"""Reward-function plugins for model-based training (counterpart of
``mjrl_tpu/algos/model_accel/reward_functions.py``).

A reward function takes a batched paths dict {'observations': (N, H, d),
'actions': (N, H, m)} of tensors and populates paths['rewards'] (N, H).
The runner resolves them by env id from a registry.
"""

import torch

from mjrl_tpu_torch.envs.peg_insertion import PegEnv
from mjrl_tpu_torch.envs.point_mass import PointMassEnv
from mjrl_tpu_torch.envs.reacher import Reacher7DOFEnv

_REGISTRY = {}


def register(env_id, fn):
    _REGISTRY[env_id] = fn


def get_reward_function(env_id):
    return _REGISTRY.get(env_id)


def point_mass_reward(paths):
    """Batched point-mass reward with the r(s, a) = r(s') shift: every step
    but the last takes the next step's reward."""
    rewards = PointMassEnv.reward_fn(paths["observations"])
    paths["rewards"] = torch.cat([rewards[..., 1:], rewards[..., -1:]],
                                 dim=-1)
    return paths


def reacher_reward(paths):
    paths["rewards"] = Reacher7DOFEnv.reward_fn(paths["observations"])
    return paths


def peg_insertion_reward(paths):
    paths["rewards"] = PegEnv.reward_fn(paths["observations"])
    return paths


register("mjrl_point_mass-v0", point_mass_reward)
register("mjrl_reacher_7dof-v0", reacher_reward)
register("mjrl_peg_insertion-v0", peg_insertion_reward)
