from mjrl_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                          replicated_sharding,
                                          shard_rollout_keys)
