"""On-policy algorithms and behavior cloning (counterpart of
``mjrl_tpu/algos``).  Ported: ``BatchREINFORCE``, ``NPG``, ``TRPO``, ``PPO``
and ``BC``.  ``DAPG``, ``MBAC`` and ``model_accel`` are the remainder of
ROADMAP.md M10: their own examples need ``point_mass`` (M8) or relocate
(M9)."""

from mjrl_tpu_torch.algos.batch_reinforce import BatchREINFORCE
from mjrl_tpu_torch.algos.behavior_cloning import BC
from mjrl_tpu_torch.algos.npg_cg import NPG
from mjrl_tpu_torch.algos.ppo_clip import PPO
from mjrl_tpu_torch.algos.trpo import TRPO

__all__ = ["BatchREINFORCE", "NPG", "TRPO", "PPO", "BC"]
