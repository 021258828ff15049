"""Frozen yardsticks: the published peaks, the counting rule of an NPG
iteration's work, and the loading of a configuration with its engine.

Nothing here names a physics engine.  A configuration
(``configs/<config>.json``) names its engine under ``engine``; the engine's
module, ``reference/<engine>_plain.py``, holds its frozen plain step, its
frozen model parameters' loader (``configs/<config>.<engine>.json``) and
the operations and bytes its kernel is counted by, so that nothing the
program later changes can move a roofline or the iteration's counted work.
The numbers are written into each configuration's file under ``counts`` (a
test recomputes them):

    python -m portbench.counts            # prints the counts of every config
"""

import importlib.util
import json
import os

from torch.utils._python_dispatch import TorchDispatchMode

# published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12

HERE = os.path.dirname(os.path.abspath(__file__))


class _OpCounter(TorchDispatchMode):
    """Counts the elementwise tensor operations a plain step issues: on
    (1,)-shaped components each is one scalar operation per
    environment."""
    SKIP = ("zeros_like", "ones_like", "select", "stack", "cat", "_to_copy",
            "unsqueeze", "view", "detach", "alias", "empty", "lift_fresh")

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if not any(s in name for s in self.SKIP):
            self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def count_ops(fn):
    """Scalar operations of ``fn`` run in component form on one
    environment (the rule an engine's counters count by)."""
    with _OpCounter() as c:
        fn()
    return sum(c.counts.values())


def mlp_flops(sizes):
    """Multiply-add FLOPs (2 m n k) of one forward pass of a dense network
    with layer widths ``sizes``, per sample."""
    return sum(2 * a * b for a, b in zip(sizes[:-1], sizes[1:]))


# The passes of the policy network one NPG iteration needs, per sample, in
# forward-pass equivalents (a backward pass counts 2, a Jacobian-vector
# product 1): the rollout's forward (1); the surrogate before the step (1);
# the gradient, forward and backward (3); one Fisher-vector product per CG
# iteration and one for CG's initial residual (x0 = g), each a forward
# tangent and a backward (3); the KL at the step and the surrogate after it
# (2 forwards).  The KL guard's backtracking is data-dependent and is not
# counted, so the count errs low.
def policy_passes(cg_iters):
    return 1 + 1 + 3 + 3 * (cg_iters + 1) + 2


def baseline_flops(n_features):
    """FLOPs per sample of the linear baseline in one iteration: the
    prediction over the rollout and its bootstrap column (2 F), F^T F
    (2 F^2) and F^T R (2 F), and the errors before and after the fit
    (4 F)."""
    return 2 * n_features + 2 * n_features ** 2 + 2 * n_features \
        + 4 * n_features


def iteration_counts(cfg, p, engine):
    """The counted work of one NPG iteration, per sample, for a
    configuration ``cfg`` (its JSON) and its engine's module and frozen
    parameters."""
    sizes = [cfg["obs_dim"]] + list(cfg["policy_size"]) + [cfg["act_dim"]]
    n_features = cfg["obs_dim"] + 1 + 4
    phys = engine.physics_ops(p, cfg["frame_skip"])
    pol = mlp_flops(sizes) * policy_passes(cfg["FIM_invert_args"]["iters"])
    base = baseline_flops(n_features)
    return {"physics_ops_per_sample": phys,
            "policy_flops_per_sample": pol,
            "baseline_flops_per_sample": base,
            "flops_per_sample": phys + pol + base,
            "kernel_bytes_per_env": engine.kernel_bytes(p)}


def roofline_share(ctx, kernel_symbol):
    """A physics kernel's share of its roofline in the profiled iteration,
    in %: the least time the card could take for one launch on the cell's
    rows (the larger of the counted operations over the float32 peak and
    the counted bytes over the bandwidth) over the launch's mean device
    time; None where the kernel did not run."""
    times = ctx["trace"]["durations"].get(kernel_symbol)
    if not times or ctx["cfg"]["kernel_symbol"] != kernel_symbol:
        return None
    counts, rows = ctx["counts"], ctx["rows"]
    least = max(counts["physics_ops_per_sample"] * rows / PEAK_FP32_PER_S,
                counts["kernel_bytes_per_env"] * rows / PEAK_BYTES_PER_S)
    return 100.0 * least / (sum(times) / len(times))


def load_module(path, name):
    """The Python file ``path`` as a module of its own named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_config(name):
    """-> (the configuration ``configs/<name>.json``, its frozen model
    parameters ``configs/<name>.<engine>.json``, the engine's module
    ``reference/<engine>_plain.py``)."""
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        cfg = json.load(f)
    engine = load_module(
        os.path.join(HERE, "reference", cfg["engine"] + "_plain.py"),
        "portbench_engine_" + cfg["engine"])
    p = engine.load_params(os.path.join(
        HERE, "configs", f"{name}.{cfg['engine']}.json"))
    return cfg, p, engine


def config_names():
    """Every configuration in ``configs/``: a file that names an engine."""
    names = []
    for fn in sorted(os.listdir(os.path.join(HERE, "configs"))):
        with open(os.path.join(HERE, "configs", fn)) as f:
            if "engine" in json.load(f):
                names.append(fn[:-len(".json")])
    return names


def main():
    for name in config_names():
        cfg, p, engine = load_config(name)
        print(json.dumps({"config": name,
                          "counts": iteration_counts(cfg, p, engine)}))


if __name__ == "__main__":
    main()
