"""Training-curve plots (counterpart of ``mjrl_tpu/utils/make_train_plots.py``).

One PNG per requested key, x-axis = cumulative environment samples when
``num_samples`` was logged (with an iteration top axis), else iteration
index.  Also usable as a CLI:

    python -m mjrl_tpu_torch.utils.make_train_plots --log_path <log.csv> \
        --keys stoc_pol_mean --save_loc <dir>
"""

import argparse
import os

from mjrl_tpu_torch.utils.logger import DataLog


def make_train_plots(log=None, log_path=None, keys=None, save_loc=None,
                     sample_key="num_samples", x_scale=1.0, y_scale=1.0):
    if log is None and log_path is None:
        print("Need a log dict or a log file path")
        return
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: no training plots written")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    if log is None:
        logger = DataLog()
        logger.read_log(log_path)
        log = logger.log

    if sample_key in log:
        samples = [x_scale * s for s in _cumulative(log[sample_key])]
    else:
        samples = None

    for key in (keys or []):
        if key not in log:
            continue
        ys = [y_scale * v for v in log[key] if v is not None]
        fig, ax1 = plt.subplots()
        if samples is not None and len(samples) == len(ys):
            ax1.plot(samples, ys)
            ax1.set_xlabel("samples")
            ax2 = ax1.twiny()
            ax2.set_xlim(0, len(ys))
            ax2.set_xlabel("iterations")
        else:
            ax1.plot(ys)
            ax1.set_xlabel("iterations")
        ax1.set_ylabel(key)
        ax1.set_title(key)
        fig.tight_layout()
        out = os.path.join(save_loc or ".", f"{key}.png")
        fig.savefig(out, dpi=100)
        plt.close(fig)


def _cumulative(xs):
    out, tot = [], 0.0
    for x in xs:
        tot += (x or 0)
        out.append(tot)
    return out


def main():
    parser = argparse.ArgumentParser(description="Plot training curves")
    parser.add_argument("--log_path", type=str, required=True)
    parser.add_argument("--keys", type=str, nargs="+",
                        default=["stoc_pol_mean"])
    parser.add_argument("--save_loc", type=str, default=".")
    args = parser.parse_args()
    make_train_plots(log_path=args.log_path, keys=args.keys,
                     save_loc=args.save_loc)


if __name__ == "__main__":
    main()
