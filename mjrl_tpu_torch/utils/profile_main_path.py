"""Where the time of the main path goes on the GPU.

    python -m mjrl_tpu_torch.utils.profile_main_path [--out DIR]

Runs the swimmer NPG iteration at the size users train at (4096 environments
x 500 control steps, a 64-64 policy) and prints one JSON object per line:

- ``rollout``: wall seconds of a rollout, the device time summed by kernel
  name from ``torch.profiler`` over a window of control steps, and the share
  of the window in which the device was busy;
- ``iteration``: the wall seconds of the phases of three whole iterations
  (sampling, update, baseline fit);
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
from mjrl_tpu_torch.baselines import LinearBaseline
from mjrl_tpu_torch.device import make_generator
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.models.policies import MLP
from mjrl_tpu_torch.samplers.rollout import rollout_batch

NUM_ENVS, HORIZON, WINDOW = 4096, 500, 50


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def profile_rollout(env, policy):
    gen = make_generator(0, env.device)
    roll = lambda T: rollout_batch(env, policy.config, policy.params,
                                   policy.transforms, gen, NUM_ENVS,
                                   horizon=T)
    roll(WINDOW)                                   # builds the kernel, warms
    _, seconds = _timed(lambda: roll(HORIZON))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, window_s = _timed(lambda: roll(WINDOW))
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"phase": "rollout", "num_envs": NUM_ENVS, "horizon": HORIZON,
            "seconds": seconds,
            "control_steps_per_s": NUM_ENVS * HORIZON / seconds,
            "window_steps": WINDOW, "window_ms": window_s * 1e3,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / (window_s * 1e3),
            "device_launches_per_step": sum(r[2] for r in rows) / WINDOW,
            "top_kernels": [{"name": n[:80], "ms": ms, "calls": c}
                            for n, ms, c in rows[:12]]}, prof


def profile_iterations(niter=3):
    e = GymEnv("mjrl_swimmer-v0")
    policy = MLP(e.spec, hidden_sizes=(64, 64))
    agent = NPG(e, policy, LinearBaseline(e.spec), normalized_step_size=0.1,
                save_logs=True)
    for _ in range(niter):
        agent.train_step(NUM_ENVS, gamma=0.995, gae_lambda=0.97)
    log = agent.logger.log
    return {"phase": "iteration", "iterations": niter,
            "time_sampling": log["time_sampling"],
            "time_npg": log["time_npg"], "time_VF": log["time_VF"],
            "peak_device_memory_bytes": torch.cuda.max_memory_allocated()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
    e = GymEnv("mjrl_swimmer-v0")
    policy = MLP(e.spec, hidden_sizes=(64, 64))
    result, prof = profile_rollout(e.env, policy)
    print(json.dumps(result), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out,
                                              "rollout_window.json"))
    print(json.dumps(profile_iterations()), flush=True)


if __name__ == "__main__":
    main()
