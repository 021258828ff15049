"""On-policy algorithms, behavior cloning, DAPG and the model-based branch
(counterpart of ``mjrl_tpu/algos``): ``BatchREINFORCE``, ``NPG``,
``TRPO``, ``PPO``, ``BC``, ``DAPG``, ``MBAC``, and from ``model_accel``
the world models, ``ModelAccelNPG`` and ``MPCPolicy``."""

from mjrl_tpu_torch.algos.batch_reinforce import BatchREINFORCE
from mjrl_tpu_torch.algos.behavior_cloning import BC
from mjrl_tpu_torch.algos.dapg import DAPG
from mjrl_tpu_torch.algos.mbac import MBAC
from mjrl_tpu_torch.algos.model_accel.model_accel_npg import ModelAccelNPG
from mjrl_tpu_torch.algos.model_accel.model_learning_mpc import MPCPolicy
from mjrl_tpu_torch.algos.model_accel.nn_dynamics import (WorldModel,
                                                          WorldModelEnsemble)
from mjrl_tpu_torch.algos.npg_cg import NPG
from mjrl_tpu_torch.algos.ppo_clip import PPO
from mjrl_tpu_torch.algos.trpo import TRPO

__all__ = ["BatchREINFORCE", "NPG", "TRPO", "PPO", "BC", "DAPG", "MBAC",
           "WorldModel", "WorldModelEnsemble", "ModelAccelNPG", "MPCPolicy"]
