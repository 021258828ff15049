#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py          # needs one NVIDIA GPU (built for sm_90a)

Phases, each a JSON object on a line of its own; the first failure exits
non-zero with the phase's name:

1. device   refuses to run without CUDA; prints the card's name and power
            limit as nvidia-smi gives them.
2. build    builds every kernel from mjrl_tpu_torch/csrc with nvcc; prints
            seconds, registers and spills.
3. kernels  each kernel against its plain PyTorch version ON THE CARD, same
            numpy-seeded inputs, at the shapes the main path gives it, with
            its time, the plain version's time and its roofline bound.
4. rollout  SwimmerEnv, 4096 environments x 500 steps, 64-64 policy,
            stochastic: every leaf finite, one kernel launch per step.
5. train    the main path through the entry points a user calls: GymEnv ->
            MLP -> LinearBaseline -> NPG -> train_agent, 3 iterations of
            4096 trajectories; finite statistics, KL within the guard, one
            launch per control step of every rollout.

The last line is {"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from mjrl_tpu_torch.algos import NPG
from mjrl_tpu_torch.baselines import LinearBaseline
from mjrl_tpu_torch.device import make_generator
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.envs.swimmer import SwimmerEnv
from mjrl_tpu_torch.models.policies import MLP
from mjrl_tpu_torch.ops import cuda_planar
from mjrl_tpu_torch.physics.planar import step_n_arrays
from mjrl_tpu_torch.samplers.rollout import rollout_batch
from mjrl_tpu_torch.utils.train_agent import train_agent

# published peaks of one H100 SXM (NVIDIA data sheet): the roofline bound
# is stated against them, with the card's power limit printed beside it
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

NUM_ENVS = 4096
HORIZON = 500
FRAME_SKIP = 5
NITER = 3


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


class _OpCounter(torch.utils._python_dispatch.TorchDispatchMode):
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
        step_n_arrays(p, q, q.clone(), u, n)
    return sum(c.counts.values()), c.counts


def swimmer_test_states(B, seed):
    """Half random states (q in U(-.5,.5), v, u in U(-1,1)), half
    limit-active (hinges pushed 0.1..0.5 rad past the +-1.5 stops, moving
    into the stop).  All states lie off the limit boundary, where kernel
    and plain version could legitimately take different branches."""
    rng = np.random.RandomState(seed)
    q = rng.uniform(-0.5, 0.5, (B, 7))
    v = rng.uniform(-1.0, 1.0, (B, 7))
    u = rng.uniform(-1.0, 1.0, (B, 4))
    h = B // 2
    q[:h, 3:] = rng.uniform(1.6, 2.0, (h, 4)) * rng.choice([-1, 1], (h, 4))
    v[:h, 3:] = np.sign(q[:h, 3:]) * np.abs(v[:h, 3:])
    return q, v, u


# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build(p):
    t0 = time.time()
    info = cuda_planar.kernel_build_info(p)
    emit({"phase": "build", "seconds": time.time() - t0,
          "nvcc_seconds": info["build_seconds"], "ptxas": info["ptxas"],
          "sources": ["mjrl_tpu_torch/csrc/planar_step.cu",
                      "mjrl_tpu_torch/csrc/planar_body.cuh"]})
    return info


def phase_kernels(p, smi):
    dev = torch.device("cuda")
    checks = []
    worst = 0.0
    for B in (NUM_ENVS, 1000):
        q, v, u = swimmer_test_states(B, seed=B)
        for dtype, tol_q, tol_v in ((torch.float64, 1e-9, 1e-9),
                                    (torch.float32, 2e-5, 2e-4)):
            tq, tv, tu = (torch.tensor(a, dtype=dtype, device=dev)
                          for a in (q, v, u))
            gq, gv = cuda_planar.cuda_step_n_batched(p, tq, tv, tu,
                                                     FRAME_SKIP)
            torch.cuda.synchronize()
            rq, rv = step_n_arrays(p, tq, tv, tu, FRAME_SKIP)
            if not (torch.isfinite(gq).all() and torch.isfinite(gv).all()):
                raise AssertionError("kernel output not finite")
            torch.testing.assert_close(gq, rq, rtol=tol_q, atol=tol_q)
            torch.testing.assert_close(gv, rv, rtol=tol_v, atol=tol_v)
            eq = (gq - rq).abs().max().item()
            ev = (gv - rv).abs().max().item()
            checks.append({"B": B, "dtype": str(dtype).split(".")[-1],
                           "max_abs_err_q": eq, "max_abs_err_v": ev,
                           "rtol_atol_q": tol_q, "rtol_atol_v": tol_v})
            if dtype == torch.float32:
                worst = max(worst, eq, ev)

    # times at the main path's shape: float32, 4096 environments, n = 5
    q, v, u = swimmer_test_states(NUM_ENVS, seed=1)
    tq, tv, tu = (torch.tensor(a, dtype=torch.float32, device=dev)
                  for a in (q, v, u))
    ms = time_ms(lambda: cuda_planar.cuda_step_n_batched(
        p, tq, tv, tu, FRAME_SKIP), 200)
    plain_ms = time_ms(lambda: step_n_arrays(p, tq, tv, tu, FRAME_SKIP), 3)
    tq64, tv64, tu64 = tq.double(), tv.double(), tu.double()
    ms_f64 = time_ms(lambda: cuda_planar.cuda_step_n_batched(
        p, tq64, tv64, tu64, FRAME_SKIP), 200)

    ops_per_env, by_name = count_plain_ops(p, FRAME_SKIP)
    nbytes = NUM_ENVS * (4 * p.nv + len(p.actuators)) * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = NUM_ENVS * ops_per_env / PEAK_FP32_PER_S * 1e3
    return {
        "name": cuda_planar.KERNEL_NAME, "route": "cuda",
        "source": cuda_planar.KERNEL_SOURCE,
        "replaces": "mjrl_tpu/ops/pallas_planar.py:85",
        "launches": None,                    # filled in from the train phase
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,   # no single PyTorch call computes this function
        "ms_float64": ms_f64, "ops_per_env_step": ops_per_env,
        "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "shape": {"B": NUM_ENVS, "nv": p.nv, "nu": len(p.actuators),
                  "n": FRAME_SKIP, "dtype": "float32"},
        "card": smi, "checks": checks,
    }


def phase_rollout(kernel_ms):
    env = SwimmerEnv()
    assert env.device.type == "cuda"
    policy = MLP(env.spec, hidden_sizes=(64, 64), seed=1)
    gen = make_generator(7, env.device)
    times = []
    for _ in range(2):          # first pass warms up
        cuda_planar.launch_count = 0
        torch.cuda.synchronize()
        t0 = time.time()
        batch = rollout_batch(env, policy.config, policy.params,
                              policy.transforms, gen, NUM_ENVS,
                              horizon=HORIZON)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        launches = cuda_planar.launch_count
        if launches != HORIZON:
            raise AssertionError(
                f"rollout launched the kernel {launches} times, expected "
                f"{HORIZON}")
    for k, leaf in batch.items():
        if torch.is_tensor(leaf) and leaf.is_floating_point() \
                and not torch.isfinite(leaf).all():
            raise AssertionError(f"rollout leaf {k} not finite")
    if tuple(batch["observations"].shape) != (NUM_ENVS, HORIZON, 12) \
            or tuple(batch["actions"].shape) != (NUM_ENVS, HORIZON, 4):
        raise AssertionError("rollout shapes wrong")
    emit({"phase": "rollout", "num_envs": NUM_ENVS, "horizon": HORIZON,
          "seconds_first": times[0], "seconds": times[1],
          "control_steps_per_s": NUM_ENVS * HORIZON / times[1],
          "kernel_launches": launches,
          "kernel_share_of_rollout": launches * kernel_ms * 1e-3 / times[1],
          "mean_return": batch["rewards"].sum(1).mean().item()})


def phase_train():
    e = GymEnv("mjrl_swimmer-v0")
    policy = MLP(e.spec, hidden_sizes=(64, 64))
    baseline = LinearBaseline(e.spec)
    agent = NPG(e, policy, baseline, normalized_step_size=0.1,
                save_logs=True)
    assert agent.device.type == "cuda" and policy.device.type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "swimmer_npg")
        cuda_planar.launch_count = 0          # just before the main path
        with contextlib.redirect_stdout(sys.stderr):
            train_agent(job, agent, seed=0, niter=NITER, num_traj=NUM_ENVS,
                        gamma=0.995, gae_lambda=0.97, save_freq=10)
        torch.cuda.synchronize()
        launches = cuda_planar.launch_count   # just after
        for f in ("results.txt",
                  os.path.join("iterations", "policy_final.pickle"),
                  os.path.join("iterations", "checkpoint_final.pickle"),
                  os.path.join("logs", "log.csv")):
            if not os.path.exists(os.path.join(job, f)):
                raise AssertionError(f"train_agent did not write {f}")
    if launches != NITER * HORIZON:
        raise AssertionError(
            f"training launched the kernel {launches} times, expected "
            f"{NITER * HORIZON}")
    log = agent.logger.log
    for k, vals in log.items():
        if len(vals) != NITER or not np.all(np.isfinite(vals)):
            raise AssertionError(f"logged {k} missing or not finite: {vals}")
    if not np.all(np.isfinite(policy.get_param_values())):
        raise AssertionError("policy parameters not finite")
    kl_cap = agent.kl_guard * agent.n_step_size / 2
    if not all(kl <= kl_cap * (1 + 1e-6) for kl in log["kl_dist"]):
        raise AssertionError(f"kl_dist {log['kl_dist']} above {kl_cap}")
    if not all(s > 0 for s in log["surr_improvement"]):
        raise AssertionError(
            f"surr_improvement not positive: {log['surr_improvement']}")
    emit({"phase": "train", "iterations": NITER, "num_traj": NUM_ENVS,
          "kernel_launches": launches,
          "time_sampling": log["time_sampling"],
          "time_npg": log["time_npg"], "time_VF": log["time_VF"],
          "kl_dist": log["kl_dist"],
          "surr_improvement": log["surr_improvement"],
          "stoc_pol_mean": log["stoc_pol_mean"]})
    return launches


def main():
    phase = "device"
    try:
        smi = phase_device()
        torch.backends.cuda.matmul.allow_tf32 = False
        p = SwimmerEnv()._planar
        phase = "build"
        phase_build(p)
        phase = "kernels"
        kernel = phase_kernels(p, smi)
        phase = "rollout"
        phase_rollout(kernel["ms"])
        phase = "train"
        kernel["launches"] = phase_train()
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' failed", file=sys.stderr)
        sys.exit(1)
    emit({"kernels": [kernel]})
    print(smi, flush=True)
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
