"""Env factory hook (counterpart of ``mjrl_tpu/utils/get_environment.py``)."""

from mjrl_tpu_torch.envs.gym_env import GymEnv


def get_environment(env_name=None, **kwargs):
    """A ``GymEnv`` of ``env_name`` (keyword arguments such as ``device``
    passed on), or None when no name is given."""
    if env_name is None:
        print("Need to specify environment name")
        return None
    return GymEnv(env_name, **kwargs)
