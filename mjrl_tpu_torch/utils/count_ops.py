"""Count the PyTorch operations one control step of an env dispatches.

The general engine's envs are eager PyTorch: each dispatched operation is
at most one device launch, so the count (times the launches-per-operation
ratio a chip run measured) predicts the launches per control step before
the chip is asked.  The count does not depend on the batch or the device.

    python -m mjrl_tpu_torch.utils.count_ops --env relocate-v0 \\
        --num_envs 4096 --device cpu
"""

import argparse
import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class DispatchCounter(TorchDispatchMode):
    """Counts every operation dispatched under it, by name."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def count_step(env, num_envs, seed=0):
    """Operations dispatched by the second control step of ``num_envs``
    environments under random actions in [-1, 1] (the first builds the
    model's cached tables) -> (total, {name: count})."""
    gen = torch.Generator(device=env.device).manual_seed(seed)
    state = env.reset(num_envs, gen)
    act = 2.0 * torch.rand((num_envs, env.action_dim), generator=gen,
                           dtype=env.dtype, device=env.device) - 1.0
    state = env.step(state, act)
    with DispatchCounter() as c:
        env.step(state, act)
    return sum(c.counts.values()), c.counts


def main(argv=None):
    from mjrl_tpu_torch import envs
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--env", default="relocate-v0")
    ap.add_argument("--num_envs", type=int, default=64)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    env = envs.make(args.env, device=args.device)
    total, counts = count_step(env, args.num_envs)
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({"env": args.env, "num_envs": args.num_envs,
                      "device": str(env.device), "ops_per_control_step":
                      total, "top": dict(top)}))


if __name__ == "__main__":
    main()
