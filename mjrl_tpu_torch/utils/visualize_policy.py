"""CLI: render a pickled policy on an environment (counterpart of
``mjrl_tpu/utils/visualize_policy.py``), offscreen.

    python -m mjrl_tpu_torch.utils.visualize_policy \\
        --env_name mjrl_point_mass-v0 --policy <policy.pickle> \\
        --episodes 3 --save_dir ./vis [--device cpu]
"""

import argparse

from mjrl_tpu_torch.device import load_pickle
from mjrl_tpu_torch.envs.gym_env import GymEnv
from mjrl_tpu_torch.utils.render import visualize_policy


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--env_name", type=str, required=True)
    parser.add_argument("--policy", type=str, required=True,
                        help="path to pickled policy")
    parser.add_argument("--episodes", type=int, default=3)
    parser.add_argument("--save_dir", type=str, default="policy_vis")
    parser.add_argument("--stochastic", action="store_true",
                        help="sample actions instead of the mean")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda / cpu (default: cuda)")
    args = parser.parse_args(argv)

    e = GymEnv(args.env_name, device=args.device)
    policy = load_pickle(args.policy, args.device)
    n = visualize_policy(e, policy, num_episodes=args.episodes,
                         mean_action=not args.stochastic,
                         save_dir=args.save_dir)
    print(f"rendered {n} frames to {args.save_dir}")
    return n


if __name__ == "__main__":
    main()
