"""Expert training + behavior cloning with the PyTorch/CUDA port
(counterpart of ``examples/behavior_clone.py``).

Trains an NPG expert on the swimmer with an MLP baseline, collects
demonstrations from its best policy, clones a fresh policy with BC, and
compares evaluation scores:

    python examples/torch_behavior_clone.py                  # on the GPU
    python examples/torch_behavior_clone.py --device cpu --niter 2 \\
        --horizon 50 --bc_epochs 2 --job /tmp/bc             # small CPU run
"""

import argparse
import os
import pickle
import sys
import time as timer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mjrl_tpu_torch.algos import BC, NPG                     # noqa: E402
from mjrl_tpu_torch.baselines import MLPBaseline             # noqa: E402
from mjrl_tpu_torch.envs import GymEnv                       # noqa: E402
from mjrl_tpu_torch.models.policies import MLP               # noqa: E402
from mjrl_tpu_torch.samplers.rollout import sample_paths     # noqa: E402
from mjrl_tpu_torch.utils.train_agent import train_agent     # noqa: E402

SEED = 500


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--job", default="torch_swimmer_exp1")
    ap.add_argument("--device", default=None,
                    help="cuda / cpu (default: cuda; without a GPU pass cpu)")
    ap.add_argument("--niter", type=int, default=50)
    ap.add_argument("--num_traj", type=int, default=10)
    ap.add_argument("--num_demos", type=int, default=5)
    ap.add_argument("--bc_epochs", type=int, default=20)
    ap.add_argument("--horizon", type=int, default=None,
                    help="control steps per episode (default: the env's)")
    args = ap.parse_args(argv)
    dev = args.device

    # train the expert policy first
    e = GymEnv("mjrl_swimmer-v0", device=dev, horizon=args.horizon)
    if args.horizon is not None:
        e.env.horizon = args.horizon
    policy = MLP(e.spec, hidden_sizes=(32, 32), seed=SEED, device=dev)
    baseline = MLPBaseline(e.spec, reg_coef=1e-3, batch_size=64, epochs=5,
                           learn_rate=1e-3, device=dev)
    agent = NPG(e, policy, baseline, normalized_step_size=0.1, seed=SEED,
                save_logs=True, device=dev)
    ts = timer.time()
    print("Training expert policy ...")
    train_agent(job_name=args.job, agent=agent, seed=SEED, niter=args.niter,
                gamma=0.995, gae_lambda=0.97, num_cpu=1,
                sample_mode="trajectories", num_traj=args.num_traj,
                save_freq=5, evaluation_rollouts=None)
    print(f"expert training time = {timer.time() - ts:.1f}s")

    # demonstrations from the best policy
    print("Collecting expert demonstrations ...")
    with open(os.path.join(args.job, "iterations", "best_policy.pickle"),
              "rb") as f:
        expert_pol = pickle.load(f)
    demo_paths = sample_paths(num_traj=args.num_demos, policy=expert_pol,
                              env=e.env)

    # behavior cloning
    policy = MLP(e.spec, hidden_sizes=(32, 32), seed=SEED, device=dev)
    bc_agent = BC(demo_paths, policy=policy, epochs=args.bc_epochs,
                  batch_size=64, lr=1e-3, device=dev)
    ts = timer.time()
    print("Running BC with expert demonstrations ...")
    bc_agent.train()
    print(f"BC training time = {timer.time() - ts:.1f}s")

    # evaluate both policies
    bc_score = e.evaluate_policy(policy, num_episodes=5, mean_action=True)
    expert_score = e.evaluate_policy(expert_pol, num_episodes=5,
                                     mean_action=True)
    print(f"Expert policy performance (eval mode) = {expert_score[0][0]:.2f}")
    print(f"BC policy performance (eval mode) = {bc_score[0][0]:.2f}")
    return bc_agent


if __name__ == "__main__":
    main()
