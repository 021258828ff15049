"""Wall-clock for Hopper-v3 NPG to reach a return of 3000, in the
PyTorch/CUDA port (counterpart of ``tools/bench_hopper.py``: its agent, its
stopping rule and its JSON line).

    python tools/torch_bench_hopper.py --seed 123 --iters 100     # on the GPU
    python tools/torch_bench_hopper.py --device cpu --ntraj 4 \
        --horizon 10 --hidden 8 8 --iters 2                       # small, CPU

The agent: 64-64 MLP policy (``init_log_std`` -0.25, ``min_log_std`` -3),
``MLPBaseline(reg_coef 1e-3, batch 64, epochs 2, lr 1e-3)``, NPG step 0.1,
100 trajectories of 1000 steps, gamma 0.995, GAE lambda 0.97; the policy
and the agent take ``--seed``.  Training stops after the first iteration
whose mean return reaches 3000, or after ``--iters``.  Each
iteration prints ``tools/torch_train_gym.py``'s row; the last line is
``{"metric": "hopper_npg_seconds_to_3000", "value", "unit", "vs_baseline",
"iters", "final_return", "total_elapsed"}`` with, beside them, the best
return and its iteration, the median seconds per iteration, the baseline
fit's share of it (``time_VF``) and, on a GPU, the card as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives it.
"""

import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_train_gym                                       # noqa: E402


def card_name():
    """``nvidia-smi``'s name and power limit of the cards, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out or None


def main(argv=None, target=3000.0):
    ap = torch_train_gym.parser()
    ap.description = __doc__.split("\n")[0]
    ap.set_defaults(env="Hopper-v3", step_size=0.1, iters=200)
    args = ap.parse_args(argv)
    agent = torch_train_gym.build_agent(args)
    card = card_name() if agent.device.type == "cuda" else None
    if card:
        print(json.dumps({"card": card}), flush=True)

    rows, _ = torch_train_gym.train(
        args, agent, stop=lambda row: row["mean_return"] >= target)
    last = rows[-1]
    reached = last["elapsed_s"] if last["mean_return"] >= target else None
    best = max(rows, key=lambda r: r["mean_return"])
    # each iteration's seconds from the rows' elapsed_s (0.1 s steps), and
    # the fit's seconds of this process's iterations from the agent's log
    elapsed = [0.0] + [r["elapsed_s"] for r in rows]
    per_iter = [b - a for a, b in zip(elapsed, elapsed[1:])]
    vf = agent.logger.log["time_VF"]
    shares = [v / dt for v, dt in zip(vf[::-1], per_iter[::-1]) if dt > 0]
    out = {
        "metric": "hopper_npg_seconds_to_3000",
        "value": round(reached if reached is not None else -1.0, 1),
        "unit": "s",
        "vs_baseline": round(300.0 / reached, 2) if reached else 0.0,
        "iters": last["iter"] + 1,
        "final_return": last["mean_return"],
        "total_elapsed": last["elapsed_s"],
        "seed": args.seed,
        "best_return": best["mean_return"],
        "best_iter": best["iter"],
        "median_iter_s": round(statistics.median(per_iter), 3),
        "median_time_VF_share": round(statistics.median(shares), 3)
        if shares else None,
        "device": str(agent.device),
        "card": card,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
