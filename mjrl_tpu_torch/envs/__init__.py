"""Environment registry (counterpart of ``mjrl_tpu/envs/__init__.py``).

``make(env_id)`` returns a functional env; ``GymEnv(env_id)`` wraps it with
the stateful host-side API.  Ported: the point mass, the swimmer, the
7-DoF reacher, peg insertion, the planar gym locomotion suite (Hopper,
Walker2d, HalfCheetah), InvertedPendulum, Ant, Humanoid and the Adroit hand
relocate task; ``MJCFEnv`` turns any MJCF file into an env.
"""

from mjrl_tpu_torch.envs.adroit import AdroitRelocateEnv
from mjrl_tpu_torch.envs.base import EnvSpec, EnvState, MujocoLikeEnv
from mjrl_tpu_torch.envs.gym_suite import (AntEnv, HalfCheetahEnv,
                                           HopperEnv, HumanoidEnv,
                                           InvertedPendulumEnv, Walker2dEnv)
from mjrl_tpu_torch.envs.mjcf_env import MJCFEnv
from mjrl_tpu_torch.envs.peg_insertion import PegEnv
from mjrl_tpu_torch.envs.point_mass import PointMassEnv
from mjrl_tpu_torch.envs.reacher import Reacher7DOFEnv
from mjrl_tpu_torch.envs.swimmer import SwimmerEnv

_REGISTRY = {}


def register(env_id, cls, **kwargs):
    _REGISTRY[env_id] = (cls, kwargs)


def registered_ids():
    return sorted(_REGISTRY)


def make(env_id, **overrides):
    """Instantiate a functional env by id."""
    if env_id not in _REGISTRY:
        raise KeyError(
            f"unknown env id {env_id!r}; known: {registered_ids()}")
    cls, kwargs = _REGISTRY[env_id]
    return cls(**{**kwargs, **overrides})


register("mjrl_point_mass-v0", PointMassEnv)
register("mjrl_swimmer-v0", SwimmerEnv)
register("mjrl_reacher_7dof-v0", Reacher7DOFEnv)
register("mjrl_peg_insertion-v0", PegEnv)
for _id in ("Hopper-v3", "Hopper-v4"):
    register(_id, HopperEnv)
for _id in ("HalfCheetah-v3", "HalfCheetah-v4"):
    register(_id, HalfCheetahEnv)
for _id in ("Walker2d-v3", "Walker2d-v4"):
    register(_id, Walker2dEnv)
for _id in ("InvertedPendulum-v2", "InvertedPendulum-v4"):
    register(_id, InvertedPendulumEnv)
for _id in ("Ant-v3", "Ant-v4"):
    register(_id, AntEnv)
for _id in ("Humanoid-v3", "Humanoid-v4"):
    register(_id, HumanoidEnv)

for _id in ("relocate-v0", "AdroitHandRelocate-v1"):
    register(_id, AdroitRelocateEnv)

from mjrl_tpu_torch.envs.gym_env import GymEnv  # noqa: E402  (needs _REGISTRY)
