"""Where the time of the main path goes on the GPU.

    python -m mjrl_tpu_torch.utils.profile_main_path [--env ID]
        [--autoreset] [--out DIR]

Runs the NPG iteration of ``--env`` (default ``mjrl_swimmer-v0``; also
``Hopper-v3``, ``Walker2d-v3``, ``HalfCheetah-v3`` on the planar kernels,
and ``mjrl_point_mass-v0``, ``mjrl_reacher_7dof-v0``,
``InvertedPendulum-v2`` on the general engine) at the size users train at
(4096 environments x the env's own horizon, a 64-64 policy; with
``--autoreset``, episodes restart inside the rollout) and prints one JSON
object per line:

- ``rollout``: wall seconds of a rollout, the device time summed by kernel
  name from ``torch.profiler`` over a window of control steps (50, or the
  env's horizon if shorter), the device launches per control step and the
  share of the window in which the device was busy;
- ``iteration``: the wall seconds of the phases of three whole iterations
  (sampling, update, baseline fit);
- ``vf_fit``: one fit of the job scripts' MLP baseline (128-128, batch 64,
  2 epochs, AdamW) on 10 000 samples of the env's observations: seconds,
  microseconds per Adam step, and from the profiler the launches per step
  and the device's busy share;
- ``card``: the card's name and power limit as ``nvidia-smi`` gives them.

It needs a CUDA GPU and fails without one: a time from a CPU run is not a
device metric.
"""

import argparse
import json
import os
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from mjrl_tpu_torch.algos import NPG
from mjrl_tpu_torch.baselines import LinearBaseline, MLPBaseline
from mjrl_tpu_torch.device import make_generator
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.models.policies import MLP
from mjrl_tpu_torch.samplers.rollout import rollout_batch

NUM_ENVS, WINDOW = 4096, 50
# NPG step size per env (the examples' values; else 0.05)
STEP_SIZE = {"mjrl_swimmer-v0": 0.1}


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def device_rows(prof):
    """(kernel name, device ms, calls) of a profile, longest first."""
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])


def profile_rollout(env, policy, autoreset=False):
    gen = make_generator(0, env.device)
    roll = lambda T: rollout_batch(env, policy.config, policy.params,
                                   policy.transforms, gen, NUM_ENVS,
                                   horizon=T, autoreset=autoreset)
    HORIZON = env.horizon
    window = min(WINDOW, HORIZON)
    roll(window)                                   # builds the kernel, warms
    _, seconds = _timed(lambda: roll(HORIZON))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, window_s = _timed(lambda: roll(window))
    rows = device_rows(prof)
    busy_ms = sum(r[1] for r in rows)
    return {"phase": "rollout", "num_envs": NUM_ENVS, "horizon": HORIZON,
            "autoreset": autoreset, "seconds": seconds,
            "control_steps_per_s": NUM_ENVS * HORIZON / seconds,
            "window_steps": window, "window_ms": window_s * 1e3,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (window_s * 1e3),
            "device_launches_per_step": sum(r[2] for r in rows) / window,
            "top_kernels": [{"name": n[:80], "ms": ms, "calls": c}
                            for n, ms, c in rows[:12]]}, prof


def profile_iterations(env_id, niter=3, autoreset=False):
    e = GymEnv(env_id)
    policy = MLP(e.spec, hidden_sizes=(64, 64))
    agent = NPG(e, policy, LinearBaseline(e.spec),
                normalized_step_size=STEP_SIZE.get(env_id, 0.05),
                save_logs=True, autoreset=autoreset)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(niter):
        agent.train_step(NUM_ENVS, gamma=0.995, gae_lambda=0.97)
    log = agent.logger.log
    return {"phase": "iteration", "env": env_id, "iterations": niter,
            "autoreset": autoreset, "num_samples": log["num_samples"],
            "time_sampling": log["time_sampling"],
            "time_npg": log["time_npg"], "time_VF": log["time_VF"],
            "peak_device_memory_bytes": torch.cuda.max_memory_allocated()}


def profile_mlp_fit(spec, n=10000):
    """One MLPBaseline fit as the job scripts configure it, on ``n`` random
    observations of the env's width (returns of unit scale)."""
    bl = MLPBaseline(spec, reg_coef=1e-3, batch_size=64, epochs=2,
                     hidden_sizes=(128, 128))
    g = make_generator(1, bl.device)
    obs = torch.randn((n // 100, 100, spec.observation_dim), generator=g,
                      device=bl.device)
    batch = (obs, obs[..., 0] + 1.0, torch.ones(obs.shape[:2],
                                                device=bl.device))
    bl.fit_state(bl.state, *batch)                 # warms up
    steps = bl.cfg.epochs * (n // bl.cfg.batch_size)
    _, seconds = _timed(lambda: bl.fit_state(bl.state, *batch))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_s = _timed(lambda: bl.fit_state(bl.state, *batch))
    rows = device_rows(prof)
    busy_ms = sum(r[1] for r in rows)
    return {"phase": "vf_fit", "samples": n, "adam_steps": steps,
            "seconds": seconds, "us_per_adam_step": seconds / steps * 1e6,
            "device_launches_per_step": sum(r[2] for r in rows) / steps,
            "device_busy_share": busy_ms / (prof_s * 1e3),
            "top_kernels": [{"name": k[:80], "ms": ms, "calls": c}
                            for k, ms, c in rows[:8]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--env", default="mjrl_swimmer-v0",
                    help="registered env id (default: the swimmer)")
    ap.add_argument("--autoreset", action="store_true",
                    help="restart ended episodes inside the rollout")
    ap.add_argument("--out", default=None,
                    help="directory for the chrome trace of the window")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_main_path needs a CUDA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"card": card}), flush=True)
    e = GymEnv(args.env)
    policy = MLP(e.spec, hidden_sizes=(64, 64))
    result, prof = profile_rollout(e.env, policy, args.autoreset)
    result["env"] = args.env
    print(json.dumps(result), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out,
                                              "rollout_window.json"))
    print(json.dumps(profile_iterations(args.env,
                                        autoreset=args.autoreset)),
          flush=True)
    print(json.dumps(profile_mlp_fit(e.spec)), flush=True)


if __name__ == "__main__":
    main()
