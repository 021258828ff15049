"""Grid plot of every scalar log key (counterpart of
``mjrl_tpu/utils/plot_from_logs.py``).

    python -m mjrl_tpu_torch.utils.plot_from_logs --data <log.pickle> \\
        --output <plot.png>

Without matplotlib it says so and writes no plot, as
``make_train_plots`` does.
"""

import argparse
import math
import pickle

import numpy as np


def plot_from_logs(data, output="plot.png", xkey=None):
    """-> True when a plot was written."""
    if isinstance(data, str):
        with open(data, "rb") as f:
            data = pickle.load(f)
    scalar_keys = [k for k, v in data.items()
                   if len(v) and isinstance(v[0], (int, float, np.floating,
                                                   np.integer))]
    n = len(scalar_keys)
    if n == 0:
        return False
    try:
        import matplotlib
    except ImportError:
        print("matplotlib is not installed: no plot written")
        return False
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    ncols = math.ceil(math.sqrt(n))
    nrows = math.ceil(n / ncols)
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=(4 * ncols, 3 * nrows), squeeze=False)
    xs = data.get(xkey) if xkey else None
    for i, key in enumerate(scalar_keys):
        ax = axes[i // ncols][i % ncols]
        if xs is not None and len(xs) == len(data[key]):
            ax.plot(xs, data[key])
        else:
            ax.plot(data[key])
        ax.set_title(key, fontsize=9)
    for j in range(n, nrows * ncols):
        axes[j // ncols][j % ncols].axis("off")
    fig.tight_layout()
    fig.savefig(output, dpi=100)
    plt.close(fig)
    return True


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data", type=str, required=True,
                        help="path to log.pickle")
    parser.add_argument("--output", type=str, default="plot.png")
    parser.add_argument("--xkey", type=str, default=None)
    args = parser.parse_args(argv)
    plot_from_logs(args.data, args.output, args.xkey)


if __name__ == "__main__":
    main()
