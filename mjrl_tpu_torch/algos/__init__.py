"""On-policy algorithms (counterpart of ``mjrl_tpu/algos``).  Ported:
``BatchREINFORCE`` and ``NPG``; TRPO, PPO, BC, DAPG and the model-based
runner are ROADMAP.md M10."""

from mjrl_tpu_torch.algos.batch_reinforce import BatchREINFORCE
from mjrl_tpu_torch.algos.npg_cg import NPG

__all__ = ["BatchREINFORCE", "NPG"]
