"""Hopper-v3's task semantics for the reference (gym v3): the observation
[qpos[1:], clip(qvel, +-10)], the reward 1 + x-velocity - 1e-3 |a|^2, the
end of an episode when z <= 0.7, |pitch| >= 0.2 or a state coordinate
leaves (-100, 100), and the reset qpos0 + U(-5e-3, 5e-3), qvel U(-5e-3,
5e-3).  The root's x does not enter the dynamics, so a state is rebuilt
from an observation with x = 0 wherever no velocity was clipped."""

import torch

NQ = 6
QPOS0 = (0.0, 1.25, 0.0, 0.0, 0.0, 0.0)
RESET_NOISE = 5e-3
VEL_CLIP = 10.0
HEALTHY_Z = 0.7
HEALTHY_ANGLE = 0.2
STATE_BOUND = 100.0
# how far from a boundary of the end test a reference state must lie for
# a disagreement with the program to count (float32 positions differ from
# float64 ones by ~1e-4 after one control step)
MARGIN_POS, MARGIN_BOUND = 1e-3, 1.0


def state_from_obs(obs):
    """(M, 11) -> qpos (M, 6), qvel (M, 6), and where the observation is
    the whole state (no velocity clipped)."""
    qpos = torch.cat([torch.zeros_like(obs[:, :1]), obs[:, :5]], dim=1)
    qvel = obs[:, 5:11]
    return qpos, qvel, (qvel.abs() < VEL_CLIP).all(1)


def observe(qpos, qvel):
    return torch.cat([qpos[:, 1:], qvel.clamp(-VEL_CLIP, VEL_CLIP)], dim=1)


def reward(qpos0, qpos1, action, dt):
    return 1.0 + (qpos1[:, 0] - qpos0[:, 0]) / dt \
        - 1e-3 * (action ** 2).sum(1)


def ended(qpos, qvel):
    """-> (episode ended, the state lies clear of every boundary)."""
    z, ang = qpos[:, 1], qpos[:, 2]
    big = torch.cat([qpos[:, 2:], qvel], dim=1).abs().amax(1)
    healthy = (z > HEALTHY_Z) & (ang.abs() < HEALTHY_ANGLE) \
        & (big < STATE_BOUND)
    clear = ((z - HEALTHY_Z).abs() > MARGIN_POS) \
        & ((ang.abs() - HEALTHY_ANGLE).abs() > MARGIN_POS) \
        & ((big - STATE_BOUND).abs() > MARGIN_BOUND)
    return ~healthy, clear


def is_reset(obs):
    """Whether each observation can be a fresh reset state."""
    q0 = torch.tensor(QPOS0[1:], dtype=obs.dtype, device=obs.device)
    tol = RESET_NOISE * (1 + 1e-5) + 1e-6
    return ((obs[:, :5] - q0).abs() <= tol).all(1) \
        & (obs[:, 5:].abs() <= tol).all(1)
