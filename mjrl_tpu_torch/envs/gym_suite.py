"""Gym/MuJoCo-parity environments: Hopper, Walker2d, HalfCheetah,
InvertedPendulum, Ant and Humanoid (counterpart of
``mjrl_tpu/envs/gym_suite.py``).

The MJCF models are parsed with the port's own parser
(``physics/mjcf.py``) from the port's OWN COPIES of the files,
``envs/mjcf/{hopper,walker2d,half_cheetah,inverted_pendulum,ant,
humanoid}.xml``.
They are byte-for-byte
the files of the ``gymnasium`` package (1.2.2, MIT licence, notice beside
them); the JAX package reads them from an installed ``gymnasium`` instead.
The port carries copies so that running it needs neither ``gymnasium`` nor
MuJoCo: the machine with the GPU is not promised to have either.

Hopper, Walker2d and HalfCheetah take the planar fast path: every control
step is one call of ``ops.cuda_planar.cuda_step_n_batched`` — on a CUDA
device one launch of the contact/RK4 kernel.  InvertedPendulum runs on the
penalty solver, which the fast path does not take, and Ant and Humanoid
are 3D floating bases with contacts: they go through the general engine
(``physics/step.py``), eager PyTorch, Ant and Humanoid at the implicit
solver with their constraint rows rebuilt at every RK4 stage.

Semantics follow the gym v3 task definitions:
- Hopper-v3: obs [qpos[1:], clip(qvel, +-10)] (11,); reward = healthy(1) +
  x-velocity - 1e-3 |a|^2; terminate when z < 0.7, |angle| > 0.2, or any
  state coordinate leaves (-100, 100); reset noise U(-5e-3, 5e-3).
- Walker2d-v3: obs (17,); healthy z in (0.8, 2), angle in (-1, 1).
- HalfCheetah-v3: obs (17,); reward = x-velocity - 0.1 |a|^2; no early
  termination; reset noise U(-0.1, 0.1) on qpos, 0.1 N(0,1) on qvel.
- InvertedPendulum-v2: obs (4,); reward 1; terminate when |angle| > 0.2;
  reset noise U(-0.01, 0.01).
- Ant-v3 (free joint): obs [qpos[2:], qvel] (27,: the v4 observation
  without contact forces); reward = healthy(1) + x-velocity - 0.5 |a|^2;
  terminate when z leaves (0.2, 1.0); reset noise U(-0.1, 0.1) on qpos,
  0.1 N(0, 1) on qvel, the root quaternion renormalized.
- Humanoid-v3: obs [qpos[2:], qvel] (45,); reward = healthy(5) + 1.25
  x-velocity (at the root joint) - 0.1 |a|^2; terminate when z leaves
  (1.0, 2.0); reset noise U(-0.01, 0.01), the root quaternion
  renormalized.
"""

import math
import os

import numpy as np
import torch

from mjrl_tpu_torch.envs.base import MujocoLikeEnv
from mjrl_tpu_torch.physics.mjcf import load_mjcf
from mjrl_tpu_torch.physics.model import ELLIPTIC, PYRAMIDAL

_MJCF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mjcf")


def _gym_asset(name):
    path = os.path.join(_MJCF_DIR, name)
    if not os.path.exists(path):
        raise FileNotFoundError(f"MJCF asset not found: {path}")
    return path


class _GymMujocoEnv(MujocoLikeEnv):
    xml_name: str
    reset_noise = 5e-3
    vel_noise = None   # None -> uniform reset_noise; float -> gaussian scale
    needs_fk_obs = False  # whole suite observes qpos/qvel only
    default_solver = "newton"

    def __init__(self, dtype=torch.float32, solver=None, cone=None,
                 device=None):
        solver = solver or self.default_solver
        mb = load_mjcf(_gym_asset(self.xml_name))
        if cone is not None:
            mb.opt["cone"] = (ELLIPTIC if str(cone).lower() == "elliptic"
                              else PYRAMIDAL)
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.model = mb.finalize(solver=solver, dtype=np_dtype)
        self._init_common(dtype, device)
        # MuJoCo init_qpos = qpos0 (the joints' refs)
        self.init_qpos = torch.tensor(self.model.qpos0, dtype=self.dtype,
                                      device=self.device)
        self.nq = self.model.nq
        self.nv = self.model.nv

    def _reset_scenery(self, n, generator):
        return {}

    def _reset_qpos_qvel(self, n, generator):
        kw = dict(generator=generator, dtype=self.dtype, device=self.device)
        r = self.reset_noise
        qpos = self.init_qpos + (torch.rand((n, self.nq), **kw) * (2.0 * r)
                                 - r)
        if self.vel_noise is None:
            qvel = torch.rand((n, self.nv), **kw) * (2.0 * r) - r
        else:
            qvel = self.vel_noise * torch.randn((n, self.nv), **kw)
        return qpos, qvel


class HopperEnv(_GymMujocoEnv):
    xml_name = "hopper.xml"
    observation_dim = 11
    frame_skip = 4
    horizon = 1000
    healthy_z = (0.7, math.inf)
    healthy_angle = (-0.2, 0.2)
    healthy_reward = 1.0
    ctrl_cost = 1e-3
    forward_weight = 1.0

    def _obs(self, data, scenery, physics):
        return torch.cat([physics.qpos[..., 1:],
                          torch.clamp(physics.qvel, -10.0, 10.0)], dim=-1)

    def _reward(self, obs, action, prev_state, new_physics):
        x_vel = (new_physics.qpos[..., 0]
                 - prev_state.physics.qpos[..., 0]) / self.dt
        ctrl = self.ctrl_cost * torch.sum(torch.square(action), dim=-1)
        return self.healthy_reward + self.forward_weight * x_vel - ctrl

    def _healthy_pose(self, physics):
        z, angle = physics.qpos[..., 1], physics.qpos[..., 2]
        return ((z > self.healthy_z[0]) & (z < self.healthy_z[1])
                & (angle > self.healthy_angle[0])
                & (angle < self.healthy_angle[1]))

    def _done(self, obs, physics):
        state = torch.cat([physics.qpos[..., 2:], physics.qvel], dim=-1)
        healthy = (self._healthy_pose(physics)
                   & (state.abs() < 100.0).all(-1)
                   & torch.isfinite(obs).all(-1))
        return ~healthy


class Walker2dEnv(HopperEnv):
    xml_name = "walker2d.xml"
    observation_dim = 17
    frame_skip = 4
    healthy_z = (0.8, 2.0)
    healthy_angle = (-1.0, 1.0)

    def _done(self, obs, physics):
        return ~(self._healthy_pose(physics) & torch.isfinite(obs).all(-1))


class HalfCheetahEnv(_GymMujocoEnv):
    xml_name = "half_cheetah.xml"
    observation_dim = 17
    frame_skip = 5
    horizon = 1000
    reset_noise = 0.1
    vel_noise = 0.1
    ctrl_cost = 0.1

    def _obs(self, data, scenery, physics):
        return torch.cat([physics.qpos[..., 1:], physics.qvel], dim=-1)

    def _reward(self, obs, action, prev_state, new_physics):
        x_vel = (new_physics.qpos[..., 0]
                 - prev_state.physics.qpos[..., 0]) / self.dt
        return x_vel - self.ctrl_cost * torch.sum(torch.square(action),
                                                  dim=-1)


class InvertedPendulumEnv(_GymMujocoEnv):
    xml_name = "inverted_pendulum.xml"
    observation_dim = 4
    frame_skip = 2
    horizon = 1000
    reset_noise = 0.01
    # the JAX package's base-class default: the penalty path
    default_solver = "penalty"

    def _obs(self, data, scenery, physics):
        return torch.cat([physics.qpos, physics.qvel], dim=-1)

    def _reward(self, obs, action, prev_state, new_physics):
        return torch.ones(obs.shape[:-1], dtype=obs.dtype, device=obs.device)

    def _done(self, obs, physics):
        return (physics.qpos[..., 1].abs() > 0.2) \
            | ~torch.isfinite(obs).all(-1)


class _FloatingBaseEnv(_GymMujocoEnv):
    """A 3D model on a free joint: obs [qpos[2:], qvel], alive while the
    root height stays in ``healthy_z``."""
    healthy_reward = 1.0
    forward_weight = 1.0

    def _reset_qpos_qvel(self, n, generator):
        qpos, qvel = super()._reset_qpos_qvel(n, generator)
        # renormalize the root quaternion after the additive reset noise
        quat = qpos[:, 3:7]
        quat = quat / torch.sqrt(torch.sum(quat * quat, dim=-1,
                                           keepdim=True) + 1e-12)
        return torch.cat([qpos[:, :3], quat, qpos[:, 7:]], dim=-1), qvel

    def _obs(self, data, scenery, physics):
        return torch.cat([physics.qpos[..., 2:], physics.qvel], dim=-1)

    def _reward(self, obs, action, prev_state, new_physics):
        x_vel = (new_physics.qpos[..., 0]
                 - prev_state.physics.qpos[..., 0]) / self.dt
        ctrl = self.ctrl_cost * torch.sum(torch.square(action), dim=-1)
        return self.healthy_reward + self.forward_weight * x_vel - ctrl

    def _done(self, obs, physics):
        z = physics.qpos[..., 2]
        return ~((z > self.healthy_z[0]) & (z < self.healthy_z[1])
                 & torch.isfinite(obs).all(-1))


class AntEnv(_FloatingBaseEnv):
    xml_name = "ant.xml"
    observation_dim = 27
    frame_skip = 5
    horizon = 1000
    reset_noise = 0.1
    vel_noise = 0.1
    healthy_z = (0.2, 1.0)
    ctrl_cost = 0.5


class HumanoidEnv(_FloatingBaseEnv):
    xml_name = "humanoid.xml"
    observation_dim = 45
    frame_skip = 5
    horizon = 1000
    reset_noise = 0.01
    healthy_z = (1.0, 2.0)
    healthy_reward = 5.0
    ctrl_cost = 0.1
    forward_weight = 1.25
