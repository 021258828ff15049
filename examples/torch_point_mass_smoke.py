"""The point-mass smoke benchmark for the PyTorch/CUDA port (counterpart of
``examples/point_mass_smoke.py``): NPG on mjrl_point_mass-v0, 50
iterations x 40 trajectories, MLP(32, 32), MLPBaseline, step 0.05, gamma
0.95, lambda 0.97, seed 500; expected to solve the task (success_rate ->
100 %).

    python examples/torch_point_mass_smoke.py              # on the GPU
    python examples/torch_point_mass_smoke.py --device cpu --niter 3
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mjrl_tpu_torch.algos import NPG                        # noqa: E402
from mjrl_tpu_torch.baselines import MLPBaseline             # noqa: E402
from mjrl_tpu_torch.envs import GymEnv                       # noqa: E402
from mjrl_tpu_torch.models.policies import MLP               # noqa: E402
from mjrl_tpu_torch.utils.train_agent import train_agent     # noqa: E402

SEED = 500


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--job", default="point_mass_exp1")
    ap.add_argument("--device", default=None,
                    help="cuda / cpu (default: cuda; without a GPU pass cpu)")
    ap.add_argument("--niter", type=int, default=50)
    ap.add_argument("--num_traj", type=int, default=40)
    args = ap.parse_args(argv)

    e = GymEnv("mjrl_point_mass-v0", device=args.device)
    policy = MLP(e.spec, hidden_sizes=(32, 32), seed=SEED,
                 device=args.device)
    baseline = MLPBaseline(e.spec, reg_coef=1e-3, batch_size=64, epochs=2,
                           learn_rate=1e-3, device=args.device)
    agent = NPG(e, policy, baseline, normalized_step_size=0.05, seed=SEED,
                save_logs=True, device=args.device)
    train_agent(job_name=args.job, agent=agent, seed=SEED, niter=args.niter,
                gamma=0.95, gae_lambda=0.97, num_cpu=1,
                sample_mode="trajectories", num_traj=args.num_traj,
                save_freq=25, evaluation_rollouts=None,
                plot_keys=["stoc_pol_mean", "running_score", "success_rate"])
    print("final success rate:",
          agent.logger.log.get("success_rate", ["n/a"])[-1])
    return agent


if __name__ == "__main__":
    main()
