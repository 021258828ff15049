"""Adroit hand relocate (counterpart of ``mjrl_tpu/envs/adroit.py``),
batch-first: the DAPG flagship task.

The MJCF is the port's own copy of the ADROIT relocate model
(``envs/mjcf/adroit/``, from gymnasium-robotics 1.4.1: a 30-actuator
ShadowHand on a 6-dof arm and a free-sliding ball, 36 dof), parsed by the
port's MJCF parser and stepped by the general engine: affine position
servos, 44 limited fixed tendons, condim-1 finger pairs and condim-4
fingertip and ball contacts, dry friction on every hand dof, the primal
Newton solver (25 iterations) and the noslip pass (20 in the XML).

Task semantics of the original DAPG relocate-v0:

- action: a in [-1, 1]^30, mapped to the servo targets act_mid + a *
  act_rng of the ctrlrange;
- obs (39,): [qpos[:30], palm - obj, palm - target, obj - target];
- dense reward: -0.1 ||palm - obj||; with the ball off the table (obj_z >
  0.04): + 1 - 0.5 ||palm - target|| - 0.5 ||obj - target||; + 10 if
  ||obj - target|| < 0.1, + 20 more if < 0.05 (the original semantics, not
  the +0.1 ||palm - obj|| sign of gymnasium-robotics 1.4.1's dense
  variant); sparse: 10 if ||obj - target|| < 0.1 else -0.1;
- no early termination, horizon 200; success: the goal held on more than
  25 steps of an episode.

Reset draws the ball's table position (x U(-0.15, 0.15), y U(-0.15, 0.3))
through the ``Object`` body's offset and the ``target`` site (x, y U(-0.2,
0.2), z U(0.15, 0.35)) through its site offset; joints start at qpos0.
"""

import os

import numpy as np
import torch

from mjrl_tpu_torch.envs.base import MujocoLikeEnv, _rescue_divergence
from mjrl_tpu_torch.physics.kinematics import model_tables
from mjrl_tpu_torch.physics.mjcf import load_mjcf
from mjrl_tpu_torch.physics.step import step_n

ADROIT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "mjcf", "adroit")


def adroit_asset(name="adroit_relocate.xml"):
    """Path of an Adroit MJCF in the port's own copy."""
    return os.path.join(ADROIT_DIR, name)


def relocate_reward(palm, obj, target, sparse=False):
    """relocate-v0 reward from the three task vectors (B, 3) -> (reward
    (B,), goal_achieved (B,) bool)."""
    goal_dist = torch.linalg.vector_norm(obj - target, dim=-1)
    goal_achieved = goal_dist < 0.1
    zero = torch.zeros_like(goal_dist)
    if sparse:
        return torch.where(goal_achieved, zero + 10.0, zero - 0.1), \
            goal_achieved
    palm_target = torch.linalg.vector_norm(palm - target, dim=-1)
    reward = (-0.1 * torch.linalg.vector_norm(palm - obj, dim=-1)
              + torch.where(obj[..., 2] > 0.04,
                            1.0 - 0.5 * palm_target - 0.5 * goal_dist, zero)
              + torch.where(goal_achieved, zero + 10.0, zero)
              + torch.where(goal_dist < 0.05, zero + 20.0, zero))
    return reward, goal_achieved


class AdroitRelocateEnv(MujocoLikeEnv):
    observation_dim = 39
    frame_skip = 5
    horizon = 200

    def __init__(self, dtype=torch.float32, solver="newton",
                 reward_type="dense", device=None):
        builder = load_mjcf(adroit_asset())
        np_dtype = np.float32 if dtype == torch.float32 else np.float64
        # the primal Newton solver: the grasp states couple hundreds of
        # constraint rows, which the dual APGD does not converge at any
        # affordable sweep count
        self.model = builder.finalize(solver=solver, dtype=np_dtype,
                                      newton_iters=25)
        self.sparse_reward = reward_type.lower() == "sparse"
        names = builder.names
        self._obj_bid = names["body"]["Object"]
        self._palm_sid = names["site"]["S_grasp"]
        self._target_sid = names["site"]["target"]
        self._init_common(dtype, device)
        t = model_tables(self.model, self.dtype, self.device)
        cr = t.ctrlrange
        self._act_mid = 0.5 * (cr[:, 0] + cr[:, 1])
        self._act_rng = 0.5 * (cr[:, 1] - cr[:, 0])

    # normalized [-1, 1] action space (relocate-v0 semantics)
    @property
    def act_low(self):
        return -np.ones(self.model.nu)

    @property
    def act_high(self):
        return np.ones(self.model.nu)

    def _body_pos(self, scenery):
        if "obj_pos" not in scenery:
            return None
        t = model_tables(self.model, self.dtype, self.device)
        bp = t.body_pos.expand(scenery["obj_pos"].shape[0], -1, -1).clone()
        bp[:, self._obj_bid, :2] = scenery["obj_pos"][:, :2]
        return bp

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
        lo = torch.tensor([-0.15, -0.15], dtype=self.dtype,
                          device=self.device)
        obj_xy = lo + torch.tensor([0.3, 0.45], dtype=self.dtype,
                                   device=self.device) \
            * torch.rand((n, 2), **kw)
        tlo = torch.tensor([-0.2, -0.2, 0.15], dtype=self.dtype,
                           device=self.device)
        target = tlo + torch.tensor([0.4, 0.4, 0.2], dtype=self.dtype,
                                    device=self.device) \
            * torch.rand((n, 3), **kw)
        t = model_tables(self.model, self.dtype, self.device)
        z = t.body_pos[self._obj_bid, 2].expand(n, 1)
        return {"obj_pos": torch.cat([obj_xy, z], dim=-1),
                "target_pos": target}

    def _reset_qpos_qvel(self, n, generator):
        t = model_tables(self.model, self.dtype, self.device)
        return (t.qpos0.expand(n, -1).clone(),
                torch.zeros((n, self.model.nv), dtype=self.dtype,
                            device=self.device))

    def _task_vectors(self, data):
        return (data.xpos[:, self._obj_bid],
                data.site_xpos[:, self._palm_sid],
                data.site_xpos[:, self._target_sid])

    def _obs(self, data, scenery, physics):
        obj, palm, target = self._task_vectors(data)
        return torch.cat([physics.qpos[:, :-6], palm - obj, palm - target,
                          obj - target], dim=-1)

    def step(self, state, action):
        # relocate-v0: clip to [-1, 1], then scale to the servo ctrlrange
        action = torch.clamp(action.to(self.dtype), -1.0, 1.0)
        ctrl = self._act_mid + action * self._act_rng
        physics = step_n(self.model, state.physics, ctrl, self.frame_skip,
                         body_pos=self._body_pos(state.scenery))
        physics = _rescue_divergence(state.physics, physics)
        data = self._kinematics(physics, state.scenery)
        obs = self._obs(data, state.scenery, physics)
        reward, goal = relocate_reward(data.site_xpos[:, self._palm_sid],
                                       data.xpos[:, self._obj_bid],
                                       data.site_xpos[:, self._target_sid],
                                       self.sparse_reward)
        return state.replace(physics=physics, obs=obs, reward=reward,
                             done=self._done(obs, physics),
                             info={"goal_achieved": goal}, t=state.t + 1)

    def _info(self, obs, reward):
        return {"goal_achieved": torch.zeros(obs.shape[:-1],
                                             dtype=torch.bool,
                                             device=obs.device)}

    # -- parity helpers -------------------------------------------------
    def get_env_state(self, state):
        """gymnasium-robotics' state dict {qpos, qvel, obj_pos,
        target_pos}."""
        return dict(qpos=state.physics.qpos, qvel=state.physics.qvel,
                    obj_pos=state.scenery["obj_pos"],
                    target_pos=state.scenery["target_pos"])

    def set_env_state(self, state, env_state):
        return super().set_env_state(state, dict(
            qp=env_state["qpos"], qv=env_state["qvel"],
            obj_pos=env_state["obj_pos"],
            target_pos=env_state["target_pos"]))

    @staticmethod
    def evaluate_success(paths, logger=None):
        """Percentage of paths whose ball sat within 0.1 of the target on
        more than 25 steps; a list of path dicts or an (N, T) flag
        array."""
        if isinstance(paths, (list, tuple)):
            ok = np.array([
                np.sum(np.asarray(p["env_infos"]["goal_achieved"])) > 25
                for p in paths])
            rate = 100.0 * ok.mean()
        else:
            flags = np.asarray(paths)
            rate = 100.0 * np.mean(np.sum(flags, axis=1) > 25)
        if logger is None:
            return rate
        logger.log_kv("success_rate", rate)
        return None
