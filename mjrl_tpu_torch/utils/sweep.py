"""Config sweeps (counterpart of ``mjrl_tpu/utils/sweep.py``): a base
config and a grid of dotted-key overrides, one job directory per point,
run one after the other on the one card.

    python -m mjrl_tpu_torch.utils.sweep --output /tmp/sweeps \\
        --config examples/example_configs/swimmer_ppo.json \\
        --grid seed=1,2 rl_num_iter=1 [--device cpu]

Each grid point becomes a job directory ``<output>/<k=v,...>`` holding
its ``config.json``.  ``--entry pkg.module:fn`` runs any ``fn(job_dir,
config_path)``, as in the JAX package; without it each point goes through
the port's job script, ``examples/torch_policy_opt_job_script.py``, whose
``main`` takes an argv: ``main(["--output", job_dir, "--config",
config_path])`` (``--device`` passed on when given).
"""

import argparse
import copy
import importlib
import itertools
import json
import os

from mjrl_tpu_torch.utils.config import apply_overrides, load_config

JOB_SCRIPT = "examples.torch_policy_opt_job_script:main"


def expand_grid(grid_args):
    """['a=1,2', 'b=x,y'] -> list of override lists covering the grid."""
    keys, values = [], []
    for item in grid_args:
        key, _, raw = item.partition("=")
        keys.append(key)
        values.append(raw.split(","))
    return [[f"{k}={v}" for k, v in zip(keys, point)]
            for point in itertools.product(*values)]


def run_sweep(output, base_config, grid, entry):
    """-> list of (job_dir, overrides).  ``entry(job_dir, config_path)``
    runs each point in turn."""
    os.makedirs(output, exist_ok=True)
    results = []
    for overrides in expand_grid(grid):
        tag = ",".join(o.replace("/", "_") for o in overrides) or "base"
        job_dir = os.path.join(output, tag)
        os.makedirs(job_dir, exist_ok=True)
        cfg = apply_overrides(copy.deepcopy(base_config), overrides)
        cfg_path = os.path.join(job_dir, "config.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f, indent=2, default=str)
        entry(job_dir, cfg_path)
        results.append((job_dir, overrides))
    return results


def _resolve_entry(spec):
    mod_name, _, fn_name = spec.partition(":")
    mod = importlib.import_module(mod_name)
    return getattr(mod, fn_name or "main")


def job_script_entry(*extra_argv):
    """The sweep's default entry: the port's job script on one point,
    ``extra_argv`` (such as ``--device cpu``) appended."""
    main = _resolve_entry(JOB_SCRIPT)

    def entry(job_dir, config_path):
        return main(["--output", job_dir, "--config", config_path,
                     *extra_argv])
    return entry


def main(argv=None):
    parser = argparse.ArgumentParser(description="Grid sweep runner")
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--grid", type=str, nargs="+", default=[],
                        help="key=v1,v2 ... (cartesian product)")
    parser.add_argument("--entry", type=str, default=None,
                        help="pkg.module:fn taking (job_dir, config_path) "
                             "(default: the port's job script)")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda / cpu for the job script (default: "
                             "cuda)")
    args = parser.parse_args(argv)
    if args.entry is not None:
        entry = _resolve_entry(args.entry)
    else:
        entry = job_script_entry(
            *(["--device", args.device] if args.device else []))
    return run_sweep(args.output, load_config(args.config), args.grid, entry)


if __name__ == "__main__":
    main()
