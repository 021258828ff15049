"""The comparison that decides ``correct``.

The set-up of a run drives the program's agent through its first
iterations through its own ``train_step`` and records, for each, the
rollout batch it trained on, the policy before it, and the baseline and
the logged surrogate after it.  The rollout cannot be replayed by a
reference (its noise is the program's stream and the physics over 1000
steps is chaotic), so the reference follows the program from the program's
own batches, and checks the rollout that this skips one control step at a
time:

- ``phys_gap``: sampled rows, every transition: the frozen plain step of
  the configuration's engine (``reference/<engine>_plain.py``) in float64
  from the observed state and the taken action, against the next
  observation and the reward the program produced (relative to 1 + |x|),
  the 99.9th percentile over the transitions (the largest gap is a float32
  branch flip of the dual solve's active set, rare and as large as a
  fault);
- ``phys_miss``: episode ends the program reported, or missed, where the
  reference's state lies clear of the end test's boundaries, and ends not
  followed by a fresh reset state (an exact count);
- ``policy_gap``: the rollout's action means against the reference
  policy's at the program's parameters (relative to 1 + |x|);
- ``action_z``: the taken actions' noise, (a - mean) / std, against N(0, 1):
  the largest |mean| or |std - 1| over action dimensions and iterations;
- ``surr_gap``: the first iteration's surrogate improvement, the policy's
  loss (relative), where both sides start from the same policy and
  baseline (a later iteration's can differ by the KL guard's 0.7 backtrack
  taken on one side only: ``change_gap`` holds the later iterations);
- ``vf_gap``: each baseline fit's predictions on its batch against the
  reference fit's (RMS, relative to the returns' RMS);
- ``grad_gap``: the first policy gradient as the update got it, worst
  leaf: the gap of the leaf's norms over the larger of the reference's
  norm of that leaf and the median leaf's;
- ``step_gap``: the same for the first step, theta_2 - theta_1: the NPG
  direction that CG found, times the step size after the KL guard;
- ``step_median_gap``: the first step's gap of the median leaf: a step
  size off by a share moves every leaf's by that share;
- ``change_gap``: the same for the change after the checked iterations.

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the last three.
"""

import os

import torch

from portbench.counts import load_module
from portbench.reference import npg

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHYS_BLOCK = 1 << 16
# the numbers compared with a limit (portbench/limits/<cell>.json)
COMPARED = ("phys_gap", "phys_miss", "policy_gap", "action_z", "surr_gap",
            "vf_gap", "grad_gap", "step_gap", "step_median_gap",
            "change_gap")


def load_env(name):
    """The task semantics module ``envs/<name>.py``."""
    return load_module(os.path.join(HERE, "envs", name + ".py"),
                       "portbench_env_" + name)


def follow(steps, theta1, beta1, cfg, ar, device, rows=None,
           ranks=npg.ONE):
    """The reference's chain of iterations on the program's batches (under
    ``ranks``: this rank's rows of them)."""
    chain, theta, beta = [], theta1, beta1
    for st in steps:
        out = npg.iteration(theta, beta, st["batch"], cfg, ar, device, rows,
                            ranks)
        chain.append(out)
        theta, beta = out["theta"], out["beta"]
    return chain


def leaf_gaps(prog, ref, grad):
    """Per leaf: | |prog_k| - |ref_k| | / max(|ref_k|, median_k |ref_k|),
    over the leaves whose reference gradient norm is at least a thousandth
    of the median leaf's."""
    gn = {k: float(grad[k].norm()) for k in grad}
    med_g = sorted(gn.values())[len(gn) // 2]
    keep = [k for k in grad if gn[k] >= 1e-3 * med_g]
    rn = {k: float(ref[k].double().norm()) for k in keep}
    med = sorted(rn.values())[len(rn) // 2]
    return {k: abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med)
            for k in keep}


def _delta(a, b, device):
    return {k: a[k].to(device, torch.float64) - b[k].to(device, torch.float64)
            for k in a}


def update_numbers(grad1, thetas, betas, surrs, ref, steps, theta1,
                   device, ranks=npg.ONE):
    """The update's numbers of a chain -- its first gradient ``grad1``, its
    policies ``thetas`` after each iteration, fitted baselines ``betas``
    and surrogate improvements ``surrs`` -- against the reference chain
    ``ref``, whose returns the fits are judged on.  Besides the compared
    numbers, for the look at them: the worst leaves of the first step and
    of the change, each iteration's step gap (each side from its own
    previous policy) and the reference's KL guard backtracks."""
    g = ref[0]["grad"]
    grad = leaf_gaps(grad1, g, g)
    each, before, ref_before = [], theta1, theta1
    for theta, r in zip(thetas, ref):
        each.append(leaf_gaps(_delta(theta, before, device),
                               _delta(r["theta"], ref_before, device), g))
        before, ref_before = theta, r["theta"]
    step = each[0]
    change = leaf_gaps(_delta(thetas[-1], theta1, device),
                       _delta(ref[-1]["theta"], theta1, device), g)
    surr_gaps = [abs(s - r["surr_improvement"]) / abs(r["surr_improvement"])
                 for s, r in zip(surrs, ref)]
    vf_gap = 0.0
    ar = npg.Arith()
    for beta, r, st in zip(betas, ref, steps):
        obs = st["batch"]["observations"].to(device, torch.float64)
        diff = npg.baseline_predict(beta.to(device, torch.float64)
                                    - r["beta"].to(device, torch.float64),
                                    obs, ar)
        sums = ranks.sum(torch.stack([(diff ** 2).sum(),
                                      (r["returns"].double() ** 2).sum()]))
        vf_gap = max(vf_gap, float(torch.sqrt(sums[0] / sums[1])))
    return dict(grad_gap=max(grad.values()), change_gap=max(change.values()),
                surr_gap=surr_gaps[0], surr_gaps=surr_gaps, vf_gap=vf_gap,
                step_gap=max(step.values()),
                step_median_gap=sorted(step.values())[len(step) // 2],
                step_leaf=max(step, key=step.get), step_leaves=step,
                change_leaf=max(change, key=change.get),
                steps_gap=[max(d.values()) for d in each],
                ref_backtracks=[r["backtracks"] for r in ref])


def check_rows(n_rows, k, seed):
    """The rows whose transitions are checked: ``k`` of ``n_rows``, drawn
    from the run's seed."""
    gen = torch.Generator().manual_seed(int(seed) ^ 0x5eed)
    return torch.randperm(n_rows, generator=gen)[:min(k, n_rows)]


def physics_numbers(steps, cfg, env, engine, p, rows, device,
                    dtype=torch.float64, alter=None, ranks=npg.ONE):
    """phys_gap and phys_miss over every transition of ``rows``, stepped by
    the ``engine`` module's plain step on its parameters ``p`` (under
    ``ranks``: the largest of the ranks' gaps, the sum of their misses).
    ``alter(next_obs) -> next_obs`` plants an altered answer (for the
    readings of a fault)."""
    n_sub = cfg["frame_skip"]
    dt = engine.control_dt(p, n_sub)
    gaps, miss, checked = [], 0, 0
    for st in steps:
        b = st["batch"]
        cast = lambda x: x[rows].to(device, dtype)
        obs, act = cast(b["observations"]), cast(b["actions"])
        rew, dones = cast(b["rewards"]), cast(b["dones"])
        ext = torch.cat([obs, cast(b["last_obs"])[:, None]], dim=1)
        O, A = obs.shape[-1], act.shape[-1]
        o0, o1 = obs.reshape(-1, O), ext[:, 1:].reshape(-1, O)
        if alter is not None:
            o1 = alter(o1)
        a, r, d = act.reshape(-1, A), rew.reshape(-1), dones.reshape(-1) > 0
        for lo in range(0, o0.shape[0], PHYS_BLOCK):
            s = slice(lo, lo + PHYS_BLOCK)
            qpos, qvel, valid = env.state_from_obs(o0[s])
            q1, v1 = engine.step_n_arrays(p, qpos, qvel, a[s], n_sub)
            end_ref, clear = env.ended(q1, v1)
            r_ref = env.reward(qpos, q1, a[s], dt)
            o1_ref = env.observe(q1, v1)
            miss += int(((d[s] != end_ref) & clear & valid).sum())
            miss += int((d[s] & ~env.is_reset(o1[s])).sum())
            rel = lambda x, y: (x - y).abs() / (1.0 + y.abs())
            same = (valid & ~d[s] & ~end_ref).to(dtype)
            gap = torch.maximum(rel(o1[s], o1_ref).amax(1) * same,
                                rel(r[s], r_ref))[valid]
            gaps.append(gap.double().cpu())
            checked += int(valid.sum())
    gaps = torch.cat(gaps) if gaps else torch.zeros(1, dtype=torch.float64)
    q = torch.quantile(gaps, 0.999) if gaps.numel() <= 1 << 24 \
        else torch.kthvalue(gaps, int(0.999 * gaps.numel())).values
    mx = ranks.max(torch.stack([q, gaps.max()]).to(device))
    counts = ranks.sum(torch.tensor([miss, checked], dtype=torch.float64,
                                    device=device))
    return dict(phys_gap=float(mx[0]), phys_max=float(mx[1]),
                phys_miss=int(counts[0])), int(counts[1])


def policy_numbers(steps, rows, device, ar=None, ranks=npg.ONE):
    """policy_gap (the rollout's means on ``rows`` against the reference
    policy's at the program's parameters; ``ar`` computes the reference's
    side, float64 by default) and action_z (all samples)."""
    ref_ar = npg.Arith()
    gap, z_dev = 0.0, 0.0
    for st in steps:
        b, theta = st["batch"], st["theta"]
        th64 = {k: v.to(device, torch.float64) for k, v in theta.items()}
        obs = b["observations"][rows].to(device)
        O = obs.shape[-1]
        mu_ref = npg.policy_mean(th64, obs.reshape(-1, O).double(), ref_ar)
        if ar is None:
            mu = b["agent_mean"][rows].to(device).reshape(mu_ref.shape)
        else:
            thc = {k: v.to(device, ar.dtype) for k, v in theta.items()}
            mu = npg.policy_mean(thc, obs.reshape(-1, O).to(ar.dtype), ar)
        gap = max(gap, float(((mu.double() - mu_ref).abs()
                              / (1.0 + mu_ref.abs())).max()))
        std = torch.exp(th64["log_std"])
        A = std.shape[0]
        s1 = torch.zeros(A, dtype=torch.float64, device=device)
        s2 = torch.zeros_like(s1)
        n = 0
        acts, means = b["actions"], b["agent_mean"]
        for lo in range(0, acts.shape[0], 1024):
            z = (acts[lo:lo + 1024].to(device).double()
                 - means[lo:lo + 1024].to(device).double()) / std
            z = z.reshape(-1, A)
            s1 += z.sum(0)
            s2 += (z * z).sum(0)
            n += z.shape[0]
        tot = ranks.sum(torch.cat([s1, s2, s1.new_tensor([n])]))
        n = tot[-1]
        m = tot[:A] / n
        sd = torch.sqrt(tot[A:2 * A] / n - m * m)
        z_dev = max(z_dev, float(torch.maximum(m.abs(),
                                               (sd - 1.0).abs()).max()))
    gap = float(ranks.max(torch.tensor(gap, dtype=torch.float64,
                                       device=device)))
    return dict(policy_gap=gap, action_z=z_dev)


def program_numbers(run, cfg, engine, p, device, seed, ranks=npg.ONE):
    """Every compared number of the program's checked iterations ``run``
    (``steps``, ``theta1``, ``beta1``, ``thetas``, ``betas``, ``surrs``;
    under ``ranks``, this rank's rows) against the float64 reference, its
    transitions stepped by the configuration's ``engine`` on ``p`` ->
    (numbers, the reference chain, transitions checked)."""
    env = load_env(cfg["reference_env"])
    steps = run["steps"]
    n_rows = steps[0]["batch"]["rewards"].shape[0]
    rows = check_rows(n_rows, run["check_rows"], seed + ranks.rank)
    ref = follow(steps, run["theta1"], run["beta1"], cfg, npg.Arith(),
                 device, ranks=ranks)
    out = update_numbers(steps[0]["grad"], run["thetas"], run["betas"],
                         run["surrs"], ref, steps, run["theta1"], device,
                         ranks)
    out.update(policy_numbers(steps, rows, device, ranks=ranks))
    phys, checked = physics_numbers(steps, cfg, env, engine, p, rows,
                                    device, ranks=ranks)
    out.update(phys)
    return out, ref, checked
