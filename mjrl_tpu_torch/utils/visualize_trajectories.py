"""CLI: replay trajectories as rendered GIFs (counterpart of
``mjrl_tpu/utils/visualize_trajectories.py``).

``--file`` is a pickle of a list of paths (with ``env_infos.state.qp``
sequences, else their observations) or of qpos arrays, or an ``.npy``
qpos sequence such as ``visualize_policy`` writes.

    python -m mjrl_tpu_torch.utils.visualize_trajectories \\
        --env_name mjrl_point_mass-v0 --file paths.pickle --save_dir ./vis
"""

import argparse
import os
import pickle

import numpy as np

from mjrl_tpu_torch.envs.gym_env import GymEnv
from mjrl_tpu_torch.utils.render import render_trajectory


def qpos_sequences(data):
    """The qpos sequence of every item of ``data`` (paths or arrays)."""
    out = []
    for item in data:
        if isinstance(item, dict):
            states = item.get("env_infos", {}).get("state")
            if states is not None and "qp" in states:
                out.append(np.asarray(states["qp"]))
            else:
                out.append(np.asarray(item["observations"]))
        else:
            out.append(np.asarray(item))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--env_name", type=str, required=True)
    parser.add_argument("--file", type=str, required=True,
                        help="pickle of a list of paths or qpos arrays, or "
                             "an .npy qpos sequence")
    parser.add_argument("--save_dir", type=str, default="traj_vis")
    parser.add_argument("--max_traj", type=int, default=5)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda / cpu (default: cuda)")
    args = parser.parse_args(argv)

    e = GymEnv(args.env_name, device=args.device)
    if args.file.endswith(".npy"):
        data = [np.load(args.file)]
    else:
        with open(args.file, "rb") as f:
            data = pickle.load(f)
    os.makedirs(args.save_dir, exist_ok=True)
    for i, qpos_seq in enumerate(qpos_sequences(data[: args.max_traj])):
        render_trajectory(e.env.model, qpos_seq, device=e.env.device,
                          gif_path=os.path.join(args.save_dir,
                                                f"traj_{i}.gif"))
        print(f"rendered trajectory {i}")


if __name__ == "__main__":
    main()
