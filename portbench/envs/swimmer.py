"""mjrl_swimmer-v0's task semantics for the reference: the observation
[qpos[2:], qvel], the reward -10 (x_after - x_before), no end of episode,
and the reset that turns only the heading.  The root's x and y do not enter
the dynamics, so a state is rebuilt from an observation with x = y = 0."""

import torch

NQ = 7


def state_from_obs(obs):
    zeros = torch.zeros_like(obs[:, :2])
    qpos = torch.cat([zeros, obs[:, :5]], dim=1)
    return qpos, obs[:, 5:12], torch.ones_like(obs[:, 0], dtype=torch.bool)


def observe(qpos, qvel):
    return torch.cat([qpos[:, 2:], qvel], dim=1)


def reward(qpos0, qpos1, action, dt):
    return -10.0 * (qpos1[:, 0] - qpos0[:, 0])


def ended(qpos, qvel):
    never = torch.zeros_like(qpos[:, 0], dtype=torch.bool)
    return never, ~never


def is_reset(obs):
    """A fresh swimmer lies still and straight: only the heading varies."""
    return (obs[:, 1:] == 0).all(1) & (obs[:, 0].abs() <= 3.1416)
