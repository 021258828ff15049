"""Swimmer environment (counterpart of ``mjrl_tpu/envs/swimmer.py``).

obs = [qpos[2:], qvel] (12,); reward = -10 * (x_after - x_before) — the
agent is rewarded for moving in the negative x direction; reset randomizes
only the heading qpos[2] ~ U(-pi, pi).
"""

import math

import torch

from mjrl_tpu_torch.envs.assets import swimmer_model
from mjrl_tpu_torch.envs.base import MujocoLikeEnv


class SwimmerEnv(MujocoLikeEnv):
    observation_dim = 12
    frame_skip = 5
    horizon = 500
    needs_fk_obs = False  # obs = qpos/qvel only

    # default = implicit solver: the +-1.5 hinge limits are load-bearing (a
    # penalty stop lets NPG learn a nonphysical thrash gait); with
    # solver="newton" the planar fast path solves the exact limit QP
    def __init__(self, dtype=torch.float32, solver="newton", device=None):
        self.model = swimmer_model(solver=solver)
        self._init_common(dtype, device)

    def _reset_scenery(self, n, generator):
        return {}

    def _reset_qpos_qvel(self, n, generator):
        qpos = torch.zeros((n, 7), dtype=self.dtype, device=self.device)
        heading = torch.rand((n,), generator=generator, dtype=self.dtype,
                             device=self.device) * (2.0 * math.pi) - math.pi
        qpos[:, 2] = heading
        return qpos, torch.zeros((n, 7), dtype=self.dtype,
                                 device=self.device)

    def _obs(self, data, scenery, physics):
        return torch.cat([physics.qpos[..., 2:], physics.qvel], dim=-1)

    def _reward(self, obs, action, prev_state, new_physics):
        # reward for moving in the negative x direction
        return -10.0 * (new_physics.qpos[..., 0]
                        - prev_state.physics.qpos[..., 0])
