"""Generic environment over any MJCF model, no subclassing required
(counterpart of ``mjrl_tpu/envs/mjcf_env.py``).

Load an MJCF file, get a batch-first functional env with obs = [qpos,
qvel] and user-supplied reward / termination callables:

    env = MJCFEnv("robot.xml", frame_skip=5, device="cpu",
                  reward_fn=lambda obs, act: -torch.sum(obs[..., :2] ** 2,
                                                        dim=-1))
    state = env.reset(num_envs, generator); state = env.step(state, action)

``reward_fn(obs, action)`` and ``done_fn(obs)`` are torch callables on
batched tensors ((B, obs_dim), (B, nu)) -> (B,), as in the JAX package
(whose ``done_fn`` also takes the observation alone).  With
``reset_noise`` > 0, qpos gets additive uniform noise and qvel gaussian
noise scaled by it, both from the generator ``reset`` is given.  As in the
JAX package, the quaternion segments of ball and free joints are left as
drawn: the kinematics and the integrator normalize them.
"""

import numpy as np
import torch

from mjrl_tpu_torch.envs.base import MujocoLikeEnv
from mjrl_tpu_torch.physics.mjcf import load_mjcf


class MJCFEnv(MujocoLikeEnv):
    needs_fk_obs = False

    def __init__(self, path=None, xml_string=None, reward_fn=None,
                 done_fn=None, frame_skip=1, horizon=1000,
                 reset_noise=0.0, dtype=torch.float32, solver="penalty",
                 device=None):
        builder = load_mjcf(path, xml_string=xml_string)
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.model = builder.finalize(solver=solver, dtype=np_dtype)
        if self.model.nu == 0:
            raise ValueError(
                "MJCFEnv needs at least one actuator (the model has no "
                "controls to act on); add <actuator><motor .../> entries")
        self.names = builder.names
        self.frame_skip = int(frame_skip)
        self.horizon = int(horizon)
        self.observation_dim = self.model.nq + self.model.nv
        self._reward_fn = reward_fn
        self._done_fn = done_fn
        self._reset_noise = float(reset_noise)
        self._init_common(dtype, device)

    # -- MujocoLikeEnv hooks ----------------------------------------------
    def _reset_scenery(self, n, generator):
        return {}

    def _reset_qpos_qvel(self, n, generator):
        kw = dict(dtype=self.dtype, device=self.device)
        qpos = self._as_tensor(self.model.qpos0).expand(n, -1).clone()
        qvel = torch.zeros((n, self.model.nv), **kw)
        r = self._reset_noise
        if r > 0.0:
            qpos = qpos + (torch.rand(qpos.shape, generator=generator, **kw)
                           * (2.0 * r) - r)
            qvel = qvel + r * torch.randn(qvel.shape, generator=generator,
                                          **kw)
        return qpos, qvel

    def _obs(self, data, scenery, physics):
        return torch.cat([physics.qpos, physics.qvel], dim=-1)

    def _reward(self, obs, action, prev_state, new_physics):
        if self._reward_fn is None:
            return obs.new_zeros(obs.shape[:-1])
        return torch.as_tensor(self._reward_fn(obs, action), dtype=obs.dtype,
                               device=obs.device)

    def _done(self, obs, physics):
        if self._done_fn is None:
            return torch.zeros(obs.shape[:-1], dtype=torch.bool,
                               device=obs.device)
        return torch.as_tensor(self._done_fn(self._obs(None, None, physics)),
                               dtype=torch.bool, device=obs.device)

    def batched_reward(self, obs):
        """Rewards of (..., obs_dim) observations with zero actions (the
        reward is read from the observations, as ``compute_path_rewards``
        assumes)."""
        if self._reward_fn is None:
            return obs.new_zeros(obs.shape[:-1])
        flat = obs.reshape(-1, obs.shape[-1])
        zero_act = flat.new_zeros((flat.shape[0], self.model.nu))
        return self._reward_fn(flat, zero_act).reshape(obs.shape[:-1])
