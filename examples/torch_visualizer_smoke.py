"""Visualizer smoke script for the PyTorch/CUDA port (counterpart of
``examples/visualizer_smoke.py``): short NPG training on the point mass
with a QuadraticBaseline (MLP(32, 32), step 0.05, gamma 0.95, lambda
0.97, 10 iterations x 40 trajectories, seed 500), then offscreen policy
rendering: two episodes of the mean action as mp4s (shaded meshes, no
interactive viewer).  The drawing needs matplotlib and OpenCV; without
matplotlib the episodes are still rolled and their qpos sequences written.

    python examples/torch_visualizer_smoke.py               # on the GPU
    python examples/torch_visualizer_smoke.py --device cpu --niter 2
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mjrl_tpu_torch.algos import NPG                        # noqa: E402
from mjrl_tpu_torch.baselines import QuadraticBaseline       # noqa: E402
from mjrl_tpu_torch.envs import GymEnv                       # noqa: E402
from mjrl_tpu_torch.models.policies import MLP               # noqa: E402
from mjrl_tpu_torch.utils.train_agent import train_agent     # noqa: E402

SEED = 500


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--job", default="point_mass_vis_exp")
    ap.add_argument("--device", default=None,
                    help="cuda / cpu (default: cuda; without a GPU pass cpu)")
    ap.add_argument("--niter", type=int, default=10)
    ap.add_argument("--num_traj", type=int, default=40)
    ap.add_argument("--episodes", type=int, default=2)
    args = ap.parse_args(argv)

    e = GymEnv("mjrl_point_mass-v0", device=args.device)
    policy = MLP(e.spec, hidden_sizes=(32, 32), seed=SEED,
                 device=args.device)
    baseline = QuadraticBaseline(e.spec, device=args.device)
    agent = NPG(e, policy, baseline, normalized_step_size=0.05, seed=SEED,
                save_logs=True, device=args.device)
    train_agent(job_name=args.job, agent=agent, seed=SEED, niter=args.niter,
                gamma=0.95, gae_lambda=0.97, num_cpu=1,
                sample_mode="trajectories", num_traj=args.num_traj,
                save_freq=5, evaluation_rollouts=None)

    vis_dir = os.path.join(args.job, "vis")
    n = e.visualize_policy(policy, num_episodes=args.episodes,
                           horizon=e.horizon, mode="evaluation",
                           save_dir=vis_dir)
    print(f"rendered {n} frames to {vis_dir}")
    return agent, n


if __name__ == "__main__":
    main()
