"""Hopper-v3 NPG to a return of 3000 on every card of one host, through
``torchrun``, ``parallel.distributed.initialize()`` and ``train_agent``
(the agent and loop of ``tools/bench_hopper.py``: 64-64 policy,
init_log_std -0.25, MLPBaseline, step 0.1, 100 trajectories of 1000 steps
split over the ranks; seed 123 unless ``--seed`` is given).

    torchrun --standalone --nproc-per-node 4 examples/torch_hopper_npg_cards.py

Every rank rolls out its 100 / R trajectories on its own card; rank 0
writes the job directory (``--job``, checkpoints every ``--save_freq``
iterations) and, at the end, ``<job>/cards.json``: each iteration's
return, seconds since the start and the agent's phase times, the iteration
that crossed ``--target`` (training stops after it) or the best one, and
the cards as ``nvidia-smi`` names them.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch                                                 # noqa: E402

from mjrl_tpu_torch.parallel import distributed as pdist     # noqa: E402


class Crossed(Exception):
    """Raised by every rank after the iteration that crosses the target
    (the statistics are all-reduced, so all ranks raise together)."""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", type=float, default=3000.0)
    ap.add_argument("--niter", type=int, default=100)
    ap.add_argument("--num_traj", type=int, default=100)
    ap.add_argument("--save_freq", type=int, default=25)
    ap.add_argument("--job", default="hopper_npg_cards")
    ap.add_argument("--seed", type=int, default=123)
    args = ap.parse_args(argv)

    pdist.initialize()                  # binds LOCAL_RANK's card first
    mesh = pdist.global_mesh()
    torch.backends.cuda.matmul.allow_tf32 = False
    from mjrl_tpu_torch.algos import NPG
    from mjrl_tpu_torch.baselines import MLPBaseline
    from mjrl_tpu_torch.envs import GymEnv
    from mjrl_tpu_torch.models.policies import MLP
    from mjrl_tpu_torch.utils.train_agent import train_agent
    e = GymEnv("Hopper-v3")
    policy = MLP(e.spec, hidden_sizes=(64, 64), seed=args.seed,
                 init_log_std=-0.25)
    baseline = MLPBaseline(e.spec, reg_coef=1e-3, batch_size=64, epochs=2,
                           learn_rate=1e-3)
    agent = NPG(e, policy, baseline, normalized_step_size=0.1,
                seed=args.seed, save_logs=True, mesh=mesh)
    record, step = [], agent.train_step
    t0 = time.time()

    def timed(*a, **kw):
        stats = step(*a, **kw)
        torch.cuda.synchronize()
        log = agent.logger.get_current_log()
        record.append({"iteration": len(record), "return": stats[0],
                       "seconds": time.time() - t0,
                       "num_samples": log["num_samples"],
                       "time_sampling": log["time_sampling"],
                       "time_npg": log["time_npg"],
                       "time_VF": log["time_VF"]})
        if stats[0] >= args.target:
            raise Crossed
        return stats
    agent.train_step = timed
    try:
        train_agent(args.job, agent, seed=args.seed, niter=args.niter,
                    gamma=0.995, gae_lambda=0.97, num_traj=args.num_traj,
                    save_freq=args.save_freq)
    except Crossed:
        pass
    if mesh.rank == 0:
        cards = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()
        out = {"world": mesh.size, "backend": torch.distributed.get_backend(),
               "crossed": record[-1] if record[-1]["return"] >= args.target
               else None, "best": max(record, key=lambda r: r["return"]),
               "iterations": record, "cards": cards}
        with open(os.path.join(args.job, "cards.json"), "w") as f:
            json.dump(out, f)
        print(json.dumps({k: out[k] for k in ("world", "backend", "crossed",
                                              "best", "cards")}))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
