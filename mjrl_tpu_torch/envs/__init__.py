"""Environment registry (counterpart of ``mjrl_tpu/envs/__init__.py``).

``make(env_id)`` returns a functional env; ``GymEnv(env_id)`` wraps it with
the stateful host-side API.  Only the swimmer is ported so far; the
remaining ids are listed in ROADMAP.md queue 1.
"""

from mjrl_tpu_torch.envs.base import EnvSpec, EnvState, MujocoLikeEnv
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


register("mjrl_swimmer-v0", SwimmerEnv)

from mjrl_tpu_torch.envs.gym_env import GymEnv  # noqa: E402  (needs _REGISTRY)
