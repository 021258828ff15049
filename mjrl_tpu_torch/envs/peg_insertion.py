"""Peg-insertion environment (counterpart of
``mjrl_tpu/envs/peg_insertion.py``), batch-first.

obs = [qpos (7), qvel (7), peg_bottom site xyz, target site xyz] (20,);
reward = -l1 - 5 l2 + 5 (l2 < 0.06) between peg bottom and target on obs
clipped to [-10, 10]; reset zeroes the arm and draws the hole position
goal_y ~ U(0.1, 0.5), which shifts the bodies target, w4 and w3 in y by
goal_y - 0.29 from their initial positions.  RK4 at dt 0.01, 4 substeps
per control step, zero gravity, through the general engine: the implicit
solver with the contact_topk cap (64 of 282 slots) and its constraint rows
frozen for the whole control step (``row_freeze_step``).
"""

import numpy as np
import torch

from mjrl_tpu_torch.envs.assets import peg_insertion_model
from mjrl_tpu_torch.envs.base import MujocoLikeEnv
from mjrl_tpu_torch.physics.kinematics import model_tables


class PegEnv(MujocoLikeEnv):
    observation_dim = 20
    frame_skip = 4
    horizon = 50

    def __init__(self, dtype=torch.float32, solver="pgs", device=None):
        builder = peg_insertion_model()
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        # the peg's contacts are quasi-static (zero gravity, guided
        # insertion): its rows are frozen for a whole control step
        self.model = builder.finalize(solver=solver, dtype=np_dtype,
                                      row_freeze_step=True)
        self._target_sid = builder.names["site"]["target"]
        self._peg_sid = builder.names["site"]["peg_bottom"]
        self._moved_bodies = [builder.names["body"][n]
                              for n in ("target", "w4", "w3")]
        self._init_common(dtype, device)

    def _body_pos(self, scenery):
        if "goal_y" not in scenery:
            return None
        t = model_tables(self.model, self.dtype, self.device)
        delta = scenery["goal_y"] - 0.29
        bp = t.body_pos.expand(delta.shape[0], -1, -1).clone()
        for b in self._moved_bodies:
            bp[:, b, 1] = bp[:, b, 1] + delta
        return bp

    def _reset_scenery(self, n, generator):
        u = torch.rand((n,), generator=generator, dtype=self.dtype,
                       device=self.device)
        return {"goal_y": 0.1 + 0.4 * u}

    def _reset_qpos_qvel(self, n, generator):
        kw = dict(dtype=self.dtype, device=self.device)
        return torch.zeros((n, 7), **kw), torch.zeros((n, 7), **kw)

    def _obs(self, data, scenery, physics):
        return torch.cat([
            physics.qpos, physics.qvel,
            data.site_xpos[:, self._peg_sid],
            data.site_xpos[:, self._target_sid]], dim=-1)

    @staticmethod
    def reward_fn(obs):
        obs = torch.clamp(obs, -10.0, 10.0)
        d = obs[..., -6:-3] - obs[..., -3:]
        l1 = torch.sum(torch.abs(d), dim=-1)
        l2 = torch.sqrt(torch.sum(d * d, dim=-1))
        return -l1 - 5.0 * l2 + 5.0 * (l2 < 0.06).to(obs.dtype)

    def _reward(self, obs, action, prev_state, new_physics):
        return self.reward_fn(obs)

    def batched_reward(self, obs):
        return self.reward_fn(obs)

    def get_env_state(self, state):
        """{qp, qv, target_pos}: the target body's full position, as the
        reference stores it."""
        t = model_tables(self.model, self.dtype, self.device)
        tb = self._moved_bodies[0]
        target_pos = t.body_pos[tb].expand(
            state.physics.qpos.shape[0], 3).clone()
        target_pos[:, 1] = target_pos[:, 1] + (state.scenery["goal_y"]
                                               - 0.29)
        return dict(qp=state.physics.qpos, qv=state.physics.qvel,
                    target_pos=target_pos)

    def set_env_state(self, state, env_state):
        goal_y = self._as_tensor(env_state["target_pos"])[..., 1]
        return super().set_env_state(
            state, dict(qp=env_state["qp"], qv=env_state["qv"],
                        goal_y=goal_y))
