"""7-DoF reacher environment (counterpart of ``mjrl_tpu/envs/reacher.py``),
batch-first.

obs = [qpos (7), qvel * dt (7), finger site xyz, target site xyz] (20,);
reward = -l1 - 5 l2 between finger and target on obs clipped to [-10, 10];
reset zeroes the robot and draws the target site within a box; batched
path rewards have no time shift.  Euler at dt 0.01, 4 substeps per control
step, through the general engine (``step_n``).
"""

import numpy as np
import torch

from mjrl_tpu_torch.envs.assets import reacher_model
from mjrl_tpu_torch.envs.base import MujocoLikeEnv
from mjrl_tpu_torch.physics.kinematics import model_tables


class Reacher7DOFEnv(MujocoLikeEnv):
    observation_dim = 20
    frame_skip = 4
    horizon = 50

    # default = implicit solver: the reacher works near its joint limits,
    # where the implicit dual matches MuJoCo's qacc far closer than the
    # penalty path (tests/test_solver.py)
    def __init__(self, dtype=torch.float32, solver="pgs", device=None):
        builder = reacher_model()
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.model = builder.finalize(solver=solver, dtype=np_dtype)
        self._target_sid = builder.names["site"]["target"]
        self._finger_sid = builder.names["site"]["finger"]
        self._init_common(dtype, device)

    def _site_pos(self, scenery):
        if "target_pos" not in scenery:
            return None
        t = model_tables(self.model, self.dtype, self.device)
        sp = t.site_pos.expand(scenery["target_pos"].shape[0], -1, -1)
        sp = sp.clone()
        sp[:, self._target_sid] = scenery["target_pos"]
        return sp

    def _reset_scenery(self, n, generator):
        u = torch.rand((n, 3), generator=generator, dtype=self.dtype,
                       device=self.device)
        half = torch.tensor([0.3, 0.2, 0.25], dtype=self.dtype,
                            device=self.device)
        return {"target_pos": (2.0 * u - 1.0) * half}

    def _reset_qpos_qvel(self, n, generator):
        kw = dict(dtype=self.dtype, device=self.device)
        return torch.zeros((n, 7), **kw), torch.zeros((n, 7), **kw)

    def _obs(self, data, scenery, physics):
        return torch.cat([
            physics.qpos,
            physics.qvel * self.dt,  # delta_x instead of velocity
            data.site_xpos[:, self._finger_sid],
            data.site_xpos[:, self._target_sid]], dim=-1)

    @staticmethod
    def reward_fn(obs):
        obs = torch.clamp(obs, -10.0, 10.0)
        d = obs[..., -6:-3] - obs[..., -3:]
        l1 = torch.sum(torch.abs(d), dim=-1)
        l2 = torch.sqrt(torch.sum(d * d, dim=-1))
        return -l1 - 5.0 * l2

    def _reward(self, obs, action, prev_state, new_physics):
        return self.reward_fn(obs)

    def batched_reward(self, obs):
        return self.reward_fn(obs)
