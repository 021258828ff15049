"""PointMass environment (counterpart of ``mjrl_tpu/envs/point_mass.py``),
batch-first.

obs = [agent xy, qvel (2), target xy] (6,); reward = -l1 - 0.5 l2 between
agent and target; solved flag = reward > -0.1; batched path rewards use the
r(s, a) = r(s') shift; success = any of the last 4 steps solved, reported
as a percentage over paths.  The penalty solver, RK4 at dt 0.01, 5
substeps per control step, through the general engine (``step_n``).
"""

import numpy as np
import torch

from mjrl_tpu_torch.envs.assets import point_mass_model
from mjrl_tpu_torch.envs.base import MujocoLikeEnv
from mjrl_tpu_torch.physics.kinematics import model_tables


class PointMassEnv(MujocoLikeEnv):
    observation_dim = 6
    frame_skip = 5
    horizon = 25

    def __init__(self, dtype=torch.float32, solver="penalty", device=None):
        builder = point_mass_model()
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.model = builder.finalize(solver=solver, dtype=np_dtype)
        self._target_sid = builder.names["site"]["target"]
        self._agent_bid = builder.names["body"]["agent"]
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
        kw = dict(generator=generator, dtype=self.dtype, device=self.device)
        goal = torch.rand((n, 2), **kw) * 2.0 - 1.0
        z = torch.full((n, 1), float(self.model.site_pos[self._target_sid,
                                                         2]),
                       dtype=self.dtype, device=self.device)
        return {"target_pos": torch.cat([goal, z], dim=-1)}

    def _reset_qpos_qvel(self, n, generator):
        kw = dict(dtype=self.dtype, device=self.device)
        qpos = torch.rand((n, 2), generator=generator, **kw) * 2.0 - 1.0
        return qpos, torch.zeros((n, 2), **kw)

    def _obs(self, data, scenery, physics):
        agent = data.xpos[:, self._agent_bid, :2]
        target = data.site_xpos[:, self._target_sid, :2]
        return torch.cat([agent, physics.qvel, target], dim=-1)

    @staticmethod
    def reward_fn(obs):
        """Works on (..., 6) observations."""
        d = obs[..., :2] - obs[..., -2:]
        l1 = torch.sum(torch.abs(d), dim=-1)
        l2 = torch.sqrt(torch.sum(d * d, dim=-1))
        return -1.0 * l1 - 0.5 * l2

    def _reward(self, obs, action, prev_state, new_physics):
        return self.reward_fn(obs)

    def _info(self, obs, reward):
        return {"solved": reward > -0.1}

    def batched_reward(self, obs):
        return self.reward_fn(obs)

    def compute_path_rewards(self, paths):
        """r(s, a) = r(s') shift."""
        rewards = self.batched_reward(paths["observations"])
        rewards = torch.cat([rewards[..., 1:], rewards[..., -1:]], dim=-1)
        paths["rewards"] = rewards
        return paths

    @staticmethod
    def evaluate_success(paths, logger=None):
        """Percentage of paths with any 'solved' in the last 4 steps.
        Accepts a list of path dicts or a batched (N, T) info array."""
        if isinstance(paths, (list, tuple)):
            solved = np.array([
                np.mean(np.asarray(p["env_infos"]["solved"][-4:])) > 0.0
                for p in paths])
            rate = 100.0 * solved.mean()
        else:
            flags = np.asarray(paths)
            rate = 100.0 * np.mean(np.mean(flags[:, -4:], axis=1) > 0.0)
        if logger is None:
            return rate
        logger.log_kv("success_rate", rate)
        return None
