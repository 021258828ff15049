"""NN against linear policy on the swimmer for the PyTorch/CUDA port
(counterpart of ``examples/linear_nn_comparison.py``): NPG with an
MLP(32, 32) policy, then with a linear policy, each with an MLPBaseline
(reg 1e-3, batch 64, 2 epochs), step 0.1, gamma 0.995, lambda 0.97, 50
iterations x 10 trajectories, 5 evaluation rollouts, seed 500.

    python examples/torch_linear_nn_comparison.py          # on the GPU
    python examples/torch_linear_nn_comparison.py --device cpu --niter 2 \\
        --horizon 20 --eval_rollouts 1
"""

import argparse
import os
import sys
import time as timer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mjrl_tpu_torch.algos import NPG                        # noqa: E402
from mjrl_tpu_torch.baselines import MLPBaseline             # noqa: E402
from mjrl_tpu_torch.envs import GymEnv                       # noqa: E402
from mjrl_tpu_torch.models.policies import MLP, LinearPolicy  # noqa: E402
from mjrl_tpu_torch.utils.train_agent import train_agent     # noqa: E402

SEED = 500


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda / cpu (default: cuda; without a GPU pass cpu)")
    ap.add_argument("--niter", type=int, default=50)
    ap.add_argument("--num_traj", type=int, default=10)
    ap.add_argument("--eval_rollouts", type=int, default=5)
    ap.add_argument("--horizon", type=int, default=None,
                    help="control steps per trajectory (default: the "
                         "env's 500)")
    ap.add_argument("--job_prefix", default="swimmer")
    args = ap.parse_args(argv)

    agents = {}
    for kind in ("nn", "linear"):
        e = GymEnv("mjrl_swimmer-v0", device=args.device,
                   horizon=args.horizon)
        if args.horizon is not None:
            e.env.horizon = args.horizon  # the rollout reads the env's own
        policy = MLP(e.spec, hidden_sizes=(32, 32), seed=SEED,
                     device=args.device) if kind == "nn" else \
            LinearPolicy(e.spec, seed=SEED, device=args.device)
        baseline = MLPBaseline(e.spec, reg_coef=1e-3, batch_size=64,
                               epochs=2, learn_rate=1e-3, device=args.device)
        agent = NPG(e, policy, baseline, normalized_step_size=0.1,
                    seed=SEED, save_logs=True, device=args.device)
        ts = timer.time()
        train_agent(job_name=f"{args.job_prefix}_{kind}_exp1", agent=agent,
                    seed=SEED, niter=args.niter, gamma=0.995,
                    gae_lambda=0.97, num_cpu=1, sample_mode="trajectories",
                    num_traj=args.num_traj, save_freq=5,
                    evaluation_rollouts=args.eval_rollouts)
        print(f"time taken for {kind} policy training = "
              f"{timer.time() - ts:.1f}s")
        agents[kind] = agent
    return agents


if __name__ == "__main__":
    main()
