"""Frozen yardsticks: the published peaks, the operation counters of the
two planar kernels, and the counting rule of an NPG iteration's work.

The counters are copies of the ones the port's smoke script used when the
benchmark was defined, run on the frozen plain step
(``reference/planar_plain.py``), so that nothing the program later changes
can move a roofline or the iteration's counted work.  The numbers they give
are written into each configuration's file under ``counts`` (a test
recomputes them):

    python -m portbench.counts            # prints the counts of every config
"""

import json
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from portbench.reference import planar_plain as planar

# published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12

HERE = os.path.dirname(os.path.abspath(__file__))


class _OpCounter(TorchDispatchMode):
    """Counts the elementwise tensor operations the plain version issues:
    on (1,)-shaped components each is one scalar operation per
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


def count_plain_ops(p, n):
    """Scalar operations per environment of one control step (n substeps),
    counted by running the plain version on one environment."""
    nu = len(p.actuators)
    q = torch.full((1, p.nv), 0.1, dtype=torch.float64)
    u = torch.full((1, nu), 0.1, dtype=torch.float64)
    with _OpCounter() as c:
        planar.step_n_arrays(p, q, q.clone(), u, n)
    return sum(c.counts.values())


def count_component_ops(fn):
    """Scalar operations of ``fn`` run in component form on one
    environment."""
    with _OpCounter() as c:
        fn()
    return sum(c.counts.values())


def solve_ops(nv, first=0, last=0):
    """Scalar operations of one solve with a Cholesky factor, in component
    form, whose right-hand side is an exact zero above row ``first`` and of
    whose result only rows >= ``last`` are read."""
    one = torch.ones(1, dtype=torch.float64)

    def solve():
        y, out = {}, {}
        for i in range(first, nv):
            s = one
            for k in range(first, i):
                s = s - one * y[k]
            y[i] = s / one
        for i in reversed(range(last, nv)):
            s = y.get(i, one)
            for k in range(i + 1, nv):
                s = s - one * out[k]
            out[i] = s / one
    return count_component_ops(solve)


def count_kernel_ops(p, n):
    """Scalar operations per environment of one control step of K1's
    algorithm at one lane per environment: the plain version's count less
    the products with exact zeros the kernel leaves out, plus the
    reciprocals it takes (the port's smoke script's rule, frozen)."""
    plain = count_plain_ops(p, n)
    nv = p.nv
    lim = [d for d in range(nv) if p.limited[d]]
    factorizations = 2 if any(p.damping) else 1
    per_substep = 2 * int(sum(map(sum, planar.chain_mask(p)))) \
        - factorizations * nv
    if lim:
        full = solve_ops(nv)
        per_substep += (full - solve_ops(nv, 0, lim[0])
                        + sum(full - solve_ops(nv, d, lim[0]) for d in lim)
                        + 5 * len(lim) + (planar.PGS_SWEEPS - 1) * len(lim)
                        - len(lim))
    return plain - n * per_substep


def count_contact_ops(p, n):
    """Scalar operations per environment of one control step of K2: smooth
    dynamics and row assembly counted from the component form on one
    environment, the dual solve from its formula (C rows, nv dofs, s
    sweeps, P power iterations per acceleration evaluation; RK4 takes 4 n
    evaluations, the first cold of SWEEPS, the rest warm of
    SWEEPS_WARM)."""
    nv, nu, C = p.nv, len(p.actuators), planar.n_planar_rows(p)
    q = [torch.full((1,), 0.1, dtype=torch.float64) for _ in range(nv)]
    u = [torch.full((1,), 0.1, dtype=torch.float64) for _ in range(nu)]
    ctx = planar._planar_ctx(p, q)
    smooth = count_component_ops(lambda: planar._planar_smooth(p, q, q, u))
    rows = count_component_ops(
        lambda: planar._constraint_rows_comp(p, ctx, q, q))
    chol = nv ** 3 // 3 + nv ** 2
    solve = 2 * nv ** 2 + 2 * nv

    def evaluation(sweeps):
        return (smooth + rows + chol + (C + 1) * solve + C * (8 * nv + 7)
                + (planar.POWER_ITERS + sweeps) * (4 * C * nv + 3 * C)
                + 3 * C * planar.POWER_ITERS + 12 * C * sweeps)
    evals = n if p.integrator == planar.EULER else 4 * n
    total = evaluation(planar.SWEEPS) + (evals - 1) * evaluation(
        planar.SWEEPS_WARM)
    if p.integrator == planar.EULER:
        total += n * (chol + solve + 2 * nv * nv + 6 * nv)
    else:
        total += evals * 6 * nv
    return total


def physics_ops(p, n):
    """Operations per environment and control step of the kernel that
    steps ``p``."""
    if planar.needs_contact_path(p):
        return count_contact_ops(p, n)
    return count_kernel_ops(p, n)


def kernel_bytes(p):
    """Bytes per environment of one launch: qpos, qvel and ctrl read once,
    q and v written once, in float32."""
    return (4 * p.nv + len(p.actuators)) * 4


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


def iteration_counts(cfg, p):
    """The counted work of one NPG iteration, per sample, for a
    configuration ``cfg`` (its JSON) and its frozen planar parameters."""
    sizes = [cfg["obs_dim"]] + list(cfg["policy_size"]) + [cfg["act_dim"]]
    n_features = cfg["obs_dim"] + 1 + 4
    phys = physics_ops(p, cfg["frame_skip"])
    pol = mlp_flops(sizes) * policy_passes(cfg["FIM_invert_args"]["iters"])
    base = baseline_flops(n_features)
    return {"physics_ops_per_sample": phys,
            "policy_flops_per_sample": pol,
            "baseline_flops_per_sample": base,
            "flops_per_sample": phys + pol + base,
            "kernel_bytes_per_env": kernel_bytes(p)}


def roofline_share(ctx, kernel_symbol):
    """A planar kernel's share of its roofline in the profiled iteration,
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


def config_path(name):
    return os.path.join(HERE, "configs", name + ".json")


def load_config(name):
    with open(config_path(name)) as f:
        cfg = json.load(f)
    p = planar.load_params(os.path.join(HERE, "configs",
                                        name + ".planar.json"))
    return cfg, p


def main():
    for fn in sorted(os.listdir(os.path.join(HERE, "configs"))):
        if fn.endswith(".json") and not fn.endswith(".planar.json"):
            name = fn[:-5]
            cfg, p = load_config(name)
            print(json.dumps({"config": name,
                              "counts": iteration_counts(cfg, p)}))


if __name__ == "__main__":
    main()

