"""General NPG training CLI for any registered env, in the PyTorch/CUDA port
(counterpart of ``tools/train_gym.py``: the same arguments, agent, rows and
summary line).

    python tools/torch_train_gym.py --env Hopper-v3 --step_size 0.1 \
        --iters 100 --seed 123                                 # on the GPU
    python tools/torch_train_gym.py --device cpu --env Hopper-v3 \
        --ntraj 4 --horizon 10 --iters 2 --hidden 8 8          # small, CPU

The agent: a gaussian MLP (or linear) policy, ``MLPBaseline(reg_coef 1e-3,
batch 64, epochs 2, lr 1e-3)``, NPG (or TRPO) with ``agent.train_step``
called once per iteration.  Prints one JSON row per iteration (``iter,
mean_return, elapsed_s, alpha, kl_dist, surr_improvement, num_samples,
VF_error_before, VF_error_after, log_std, ep_len``) and a final summary
line.  ``--save`` pickles the last and the best policy, each with an
``.npz`` of its parameters and transforms beside it
(``convert.save_policy_npz``: numbers that either package loads).
``--ckpt`` (default ``<save>.ckpt``) is a directory of
``utils/checkpoint.py`` checkpoints plus the rows; with ``--resume`` a run
reprints the earlier rows and continues from the last checkpoint, drawing
what the uninterrupted run would have drawn.

The run is on the GPU unless ``--device cpu`` is given; without a GPU and
without ``--device cpu`` it raises.
"""

import argparse
import json
import os
import pickle
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mjrl_tpu_torch import convert                           # noqa: E402
from mjrl_tpu_torch.algos import NPG, TRPO                   # noqa: E402
from mjrl_tpu_torch.baselines import MLPBaseline             # noqa: E402
from mjrl_tpu_torch.device import resolve_device             # noqa: E402
from mjrl_tpu_torch.envs import GymEnv                       # noqa: E402
from mjrl_tpu_torch.models.policies import LinearPolicy, MLP  # noqa: E402
from mjrl_tpu_torch.utils.checkpoint import (                # noqa: E402
    latest_checkpoint, restore_agent_checkpoint, save_agent_checkpoint)

ROW_KEYS = ("alpha", "kl_dist", "surr_improvement", "num_samples",
            "VF_error_before", "VF_error_after")


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--env", default="Walker2d-v3")
    ap.add_argument("--solver", default=None,
                    help="penalty | pgs | newton (env default when omitted)")
    ap.add_argument("--cone", default=None,
                    help="pyramidal | elliptic friction cone (model default "
                         "when omitted)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--ntraj", type=int, default=100)
    ap.add_argument("--horizon", type=int, default=1000)
    ap.add_argument("--step_size", type=float, default=0.05)
    ap.add_argument("--gamma", type=float, default=0.995)
    ap.add_argument("--gae", type=float, default=0.97)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--init_log_std", type=float, default=-0.25)
    ap.add_argument("--min_log_std", type=float, default=-3.0,
                    help="entropy floor: log_std clamp applied on every "
                         "update")
    ap.add_argument("--hidden", type=int, nargs="+", default=[64, 64])
    ap.add_argument("--save", default=None,
                    help="pickle the trained policy here (and its .npz, "
                         "and <save>_best)")
    ap.add_argument("--algo", default="npg", choices=("npg", "trpo"),
                    help="NPG (KL-guarded sqrt step) or TRPO (backtracking "
                         "line search)")
    ap.add_argument("--policy", default="mlp", choices=("mlp", "linear"))
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory; defaults to <save>.ckpt "
                         "when --save is given")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the last checkpoint in --ckpt if "
                         "there is one; its rows are reprinted first")
    ap.add_argument("--ckpt_every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: raises without a GPU) or cpu")
    return ap


def build_agent(args):
    dev = resolve_device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU found: pass --device cpu to run on "
                           "the CPU")
    kw = {"solver": args.solver} if args.solver else {}
    if args.cone:
        kw["cone"] = args.cone
    e = GymEnv(args.env, env_kwargs=kw, device=dev)
    if args.policy == "linear":
        policy = LinearPolicy(e.spec, seed=args.seed,
                              init_log_std=args.init_log_std,
                              min_log_std=args.min_log_std, device=dev)
    else:
        policy = MLP(e.spec, hidden_sizes=tuple(args.hidden), seed=args.seed,
                     init_log_std=args.init_log_std,
                     min_log_std=args.min_log_std, device=dev)
    baseline = MLPBaseline(e.spec, reg_coef=1e-3, batch_size=64, epochs=2,
                           learn_rate=1e-3, device=dev)
    algo_cls = TRPO if args.algo == "trpo" else NPG
    return algo_cls(e, policy, baseline, normalized_step_size=args.step_size,
                    seed=args.seed, save_logs=True, device=dev)


def iteration_row(agent, i, stats, elapsed, ntraj):
    """The JSON row of one iteration, as ``tools/train_gym.py`` prints it."""
    row = {"iter": i, "mean_return": round(float(stats[0]), 1),
           "elapsed_s": round(elapsed, 1)}
    log = agent.logger.log
    for k in ROW_KEYS:
        if k in log and log[k]:
            row[k] = round(float(log[k][-1]), 5)
    row["log_std"] = round(float(torch.mean(
        agent.policy.params["log_std"].detach().double()).cpu()), 3)
    if "num_samples" in row:
        row["ep_len"] = round(row["num_samples"] / ntraj, 1)
    return row


def train(args, agent, stop=None):
    """The training loop of ``main``: -> (rows, summary).  ``stop(row)``
    true ends the run after that row (``tools/torch_bench_hopper.py``'s
    target)."""
    policy = agent.policy
    t0 = time.time()
    start_iter, best, best_params, rows = 0, -1e18, None, []
    if args.resume and args.ckpt and latest_checkpoint(args.ckpt) is not None:
        it = restore_agent_checkpoint(args.ckpt, agent)
        ck = torch.load(os.path.join(args.ckpt, f"rows_{it}.pt"),
                        weights_only=False)
        start_iter, best, rows = it + 1, ck["best"], ck["rows"]
        best_params = ck["best_params"]
        t0 = time.time() - ck["elapsed_s"]
        for row in rows:                # the log stays whole
            print(json.dumps(row), flush=True)

    def save_ckpt(i):
        if not args.ckpt:
            return
        save_agent_checkpoint(args.ckpt, agent, i)
        torch.save(dict(best=best, best_params=best_params, rows=rows,
                        elapsed_s=time.time() - t0),
                   os.path.join(args.ckpt, f"rows_{i}.pt"))

    stats = None
    for i in range(start_iter, args.iters):
        stats = agent.train_step(N=args.ntraj, sample_mode="trajectories",
                                 horizon=args.horizon, gamma=args.gamma,
                                 gae_lambda=args.gae)
        if float(stats[0]) > best:
            best = float(stats[0])
            best_params = policy.get_param_values()
        row = iteration_row(agent, i, stats, time.time() - t0, args.ntraj)
        rows.append(row)
        print(json.dumps(row), flush=True)
        done = stop is not None and stop(row)
        if (i + 1) % args.ckpt_every == 0 or i == args.iters - 1 or done:
            save_ckpt(i)
        if done:
            break
    final = stats[0] if stats is not None else rows[-1]["mean_return"]
    summary = {
        "env": args.env, "solver": args.solver or "default",
        "cone": args.cone or "default",
        "final_return": round(float(final), 1),
        "best_return": round(best, 1),
        "iters": args.iters,
        "elapsed_s": round(time.time() - t0, 1),
    }
    print(json.dumps(summary), flush=True)
    if args.save:
        save_policies(args.save, policy, best, best_params)
    return rows, summary


def save_policies(path, policy, best, best_params):
    """The last policy at ``path`` and the best iterate at
    ``<base>_best<ext>``, each a pickle with its ``.npz`` beside it."""
    base, ext = os.path.splitext(path)
    with open(path, "wb") as f:
        pickle.dump(policy, f)
    convert.save_policy_npz(base + ".npz", policy)
    print(json.dumps({"saved_policy": path}), flush=True)
    if best_params is not None:
        last = policy.get_param_values()
        policy.set_param_values(best_params)
        with open(base + "_best" + ext, "wb") as f:
            pickle.dump(policy, f)
        convert.save_policy_npz(base + "_best.npz", policy)
        policy.set_param_values(last)
        print(json.dumps({"saved_best_policy": base + "_best" + ext,
                          "best_return": round(best, 1)}), flush=True)


def main(argv=None):
    args = parser().parse_args(argv)
    if args.ckpt is None and args.save:
        args.ckpt = args.save + ".ckpt"
    agent = build_agent(args)
    rows, summary = train(args, agent)
    return agent, rows, summary


if __name__ == "__main__":
    main()
