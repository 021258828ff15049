"""Functional, batch-first environment API (counterpart of
``mjrl_tpu/envs/base.py``).

An environment is a static config object; its state is an ``EnvState`` of
tensors with a leading batch dimension, living on the env's device:

    state = env.reset(num_envs, generator)   # EnvState, leaves (B, ...)
    state = env.step(state, action)          # one control step for all B
                                             #   (frame_skip substeps inside)

Where the JAX package writes a per-environment function and ``vmap``s it,
the port writes the batch dimension out.  A model that qualifies for the
planar fast path (and is not moved per episode) is stepped by it: on a CUDA
device ``step`` launches the hand-written planar kernel
(``ops/cuda_planar.py``) once per call.  Every other model goes through the
general engine (``physics/step.py::step_n``, eager PyTorch), and envs that
observe world positions (``needs_fk_obs``) take forward kinematics after
the step.
"""

from dataclasses import dataclass, replace
from typing import Any, Dict

import numpy as np
import torch

from mjrl_tpu_torch.device import resolve_device
from mjrl_tpu_torch.ops.cuda_planar import cuda_step_n_batched
from mjrl_tpu_torch.parallel.mesh import shard_rollout_keys
from mjrl_tpu_torch.physics.kinematics import body_frames, site_positions
from mjrl_tpu_torch.physics.model import Model, State
from mjrl_tpu_torch.physics.planar import extract_planar
from mjrl_tpu_torch.physics.step import step_n

# MuJoCo's mjMAXVAL: any |qpos|/|qvel| beyond this (or non-finite) triggers
# a state reset instead of propagating garbage.
_MJ_MAXVAL = 1e10


def _rescue_divergence(old: State, new: State) -> State:
    """MuJoCo-parity divergence rescue for one control step, per
    environment row: where the stepped state is non-finite or beyond
    mjMAXVAL, keep the pre-step qpos and zero qvel (an emergency brake), so
    one exploded trajectory never poisons an update with NaN advantages."""
    ok = (torch.isfinite(new.qpos) & (new.qpos.abs() < _MJ_MAXVAL)).all(-1) \
        & (torch.isfinite(new.qvel) & (new.qvel.abs() < _MJ_MAXVAL)).all(-1)
    ok = ok.unsqueeze(-1)
    return State(qpos=torch.where(ok, new.qpos, old.qpos),
                 qvel=torch.where(ok, new.qvel, torch.zeros_like(new.qvel)))


@dataclass(frozen=True)
class EnvSpec:
    """Matches the mjrl EnvSpec."""
    observation_dim: int
    action_dim: int
    horizon: int


@dataclass
class EnvState:
    physics: State           # qpos, qvel (B, nv)
    scenery: Dict[str, Any]  # movable model overrides (e.g. target pos)
    obs: Any                 # (B, obs_dim)
    reward: Any              # (B,)
    done: Any                # (B,) bool
    info: Dict[str, Any]
    t: Any                   # (B,) int32 step counter

    def replace(self, **kw):
        return replace(self, **kw)


class MujocoLikeEnv:
    """Base for physics-backed functional envs.

    Subclasses define: ``model`` (Model), ``frame_skip``, ``horizon``,
    ``observation_dim``, ``_obs(data, scenery, physics)``,
    ``_reward(obs, action, prev_state, new_physics)``, ``_info(obs,
    reward)``, ``_reset_scenery(n, generator)``,
    ``_reset_qpos_qvel(n, generator)`` — all batch-first — and, when the
    scenery moves sites or bodies, ``_site_pos(scenery)`` or
    ``_body_pos(scenery)``.
    """

    model: Model
    frame_skip: int
    horizon: int
    # envs whose _obs ignores kinematic data (qpos/qvel-only observations)
    # set this False to skip the post-step forward kinematics
    needs_fk_obs = True

    def _init_common(self, dtype, device):
        self.dtype = dtype
        self.device = resolve_device(device)
        # the planar fast path, when the model qualifies and the env never
        # moves a part of the model per episode (as the JAX package picks)
        static_model = (type(self)._site_pos is MujocoLikeEnv._site_pos
                        and type(self)._body_pos is MujocoLikeEnv._body_pos)
        self._planar = extract_planar(
            self.model, np.float32 if dtype == torch.float32
            else np.float64) if static_model else None

    # -- model patching ------------------------------------------------
    def _site_pos(self, scenery):
        """(B, nsite, 3) local site positions that the scenery moves (the
        JAX package's ``_patched_model``), or None for the model's."""
        return None

    def _body_pos(self, scenery):
        """(B, nbody, 3) body offsets that the scenery moves (the JAX
        package's ``_patched_model``), or None for the model's.  The
        dynamics, the narrowphase and the observed sites all read them."""
        return None

    def _kinematics(self, physics, scenery):
        """Forward kinematics for observations: body frames and sites."""
        if not self.needs_fk_obs:
            return None
        data = body_frames(self.model, physics.qpos,
                           self._body_pos(scenery))
        data.site_xpos = site_positions(self.model, data,
                                        self._site_pos(scenery))
        return data

    # -- spec ----------------------------------------------------------
    @property
    def spec(self):
        return EnvSpec(self.observation_dim, self.action_dim, self.horizon)

    @property
    def action_dim(self):
        return self.model.nu

    @property
    def act_low(self):
        return self.model.ctrlrange[:, 0]

    @property
    def act_high(self):
        return self.model.ctrlrange[:, 1]

    # -- core API ------------------------------------------------------
    def _fresh_state(self, physics, scenery):
        obs = self._obs(self._kinematics(physics, scenery), scenery, physics)
        n = obs.shape[0]
        reward = torch.zeros((n,), dtype=obs.dtype, device=obs.device)
        return EnvState(
            physics=physics, scenery=scenery, obs=obs, reward=reward,
            done=torch.zeros((n,), dtype=torch.bool, device=obs.device),
            info=self._info(obs, reward),
            t=torch.zeros((n,), dtype=torch.int32, device=obs.device))

    def reset(self, num_envs, generator=None, mesh=None) -> EnvState:
        """``num_envs`` fresh states.  Under a ``mesh`` the draws are made
        for all ``num_envs`` rows (as one rank makes them) and the state is
        built for this rank's rows only."""
        scenery = self._reset_scenery(num_envs, generator)
        qpos, qvel = self._reset_qpos_qvel(num_envs, generator)
        scenery, qpos, qvel = shard_rollout_keys((scenery, qpos, qvel), mesh)
        return self._fresh_state(State(qpos=qpos, qvel=qvel), scenery)

    def step(self, state: EnvState, action) -> EnvState:
        action = action.to(state.obs.dtype).contiguous()
        # action clipping to the control range happens inside the step
        if self._planar is not None:
            qpos, qvel = cuda_step_n_batched(
                self._planar, state.physics.qpos, state.physics.qvel, action,
                self.frame_skip)
            physics = State(qpos=qpos, qvel=qvel)
        else:
            physics = step_n(self.model, state.physics, action,
                             self.frame_skip,
                             body_pos=self._body_pos(state.scenery))
        physics = _rescue_divergence(state.physics, physics)
        obs = self._obs(self._kinematics(physics, state.scenery),
                        state.scenery, physics)
        reward = self._reward(obs, action, state, physics)
        info = self._info(obs, reward)
        return state.replace(physics=physics, obs=obs, reward=reward,
                             done=self._done(obs, physics), info=info,
                             t=state.t + 1)

    def _done(self, obs, physics):
        """mjrl envs never terminate early."""
        return torch.zeros(obs.shape[:-1], dtype=torch.bool,
                           device=obs.device)

    def _info(self, obs, reward):
        return {}

    def _reward(self, obs, action, prev_state, new_physics):
        raise NotImplementedError

    @property
    def dt(self):
        """Control timestep (timestep * frame_skip)."""
        return float(self.model.timestep) * self.frame_skip

    # -- parity helpers ------------------------------------------------
    def _as_tensor(self, x):
        """A tensor of the env's dtype on its device; arrays are copied, so
        the state never aliases the caller's memory."""
        if torch.is_tensor(x):
            return x.to(dtype=self.dtype, device=self.device)
        return torch.tensor(np.asarray(x), dtype=self.dtype,
                            device=self.device)

    def get_env_state(self, state: EnvState):
        """dict {qp, qv, ...scenery}."""
        d = dict(qp=state.physics.qpos, qv=state.physics.qvel)
        d.update(state.scenery)
        return d

    def set_env_state(self, state: EnvState, env_state: dict) -> EnvState:
        scenery = {k: self._as_tensor(v) for k, v in env_state.items()
                   if k not in ("qp", "qv")}
        physics = State(qpos=self._as_tensor(env_state["qp"]),
                        qvel=self._as_tensor(env_state["qv"]))
        obs = self._obs(self._kinematics(physics, scenery), scenery, physics)
        return state.replace(physics=physics, scenery=scenery, obs=obs)

    def state_from_qpos_qvel(self, qpos, qvel, scenery=None) -> EnvState:
        """A fresh EnvState (t = 0, reward 0) at the given (B, nq) / (B, nv)
        coordinates, with the given scenery (a dict of (B, ...) arrays;
        None: the model's own)."""
        physics = State(qpos=self._as_tensor(qpos).contiguous(),
                        qvel=self._as_tensor(qvel).contiguous())
        scenery = {k: self._as_tensor(v) for k, v in (scenery or {}).items()}
        return self._fresh_state(physics, scenery)

    def compute_path_rewards(self, paths):
        """Batched reward recomputation on (N, H, obs) observations:
        default no r(s, a) = r(s') shift; envs override as the reference
        does."""
        paths["rewards"] = self.batched_reward(paths["observations"])
        return paths

    def batched_reward(self, obs):
        raise NotImplementedError
