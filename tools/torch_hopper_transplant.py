"""Evaluate a JAX-package Hopper-v3 policy in the PyTorch/CUDA port and
hold its returns against the JAX package's own evaluation of it.

    python tools/torch_hopper_transplant.py                        # on the GPU
    python tools/torch_hopper_transplant.py --device cpu           # plain step

``--golden`` (default ``tests/golden/torch_hopper_npg_jax_policy.npz``,
written by ``tools/parity_hopper_golden.py``) holds the policy's numbers
and the JAX package's float32 returns and lengths of its paths, stochastic
and in ``eval_mode``.  The port rolls 100 paths of 1000 steps each way
(float32, Hopper-v3 on its newton solver: on a GPU each control step one
launch of the contact kernel, on the CPU its plain version) and prints
one JSON line: each side's mean return, its standard
error and mean length, and ``z``, the difference of the means over their
combined standard error.  The run fails (exit 1) when the stochastic
means lie more than 4 combined standard errors apart.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mjrl_tpu_torch import convert                           # noqa: E402
from mjrl_tpu_torch.device import make_generator, resolve_device  # noqa: E402
from mjrl_tpu_torch.envs import GymEnv                       # noqa: E402
from mjrl_tpu_torch.models.policies import MLP               # noqa: E402
from mjrl_tpu_torch.samplers.rollout import rollout_batch    # noqa: E402

MAX_Z = 4.0
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "golden", "torch_hopper_npg_jax_policy.npz")


def load_policy(golden, device):
    """The golden's policy as a port ``Policy`` on ``device``, float32."""
    params, transforms = convert.load_policy_npz(golden)
    env = GymEnv("Hopper-v3", device=device)
    hidden = tuple(layer["w"].shape[1] for layer in params["layers"][:-1])
    policy = MLP(env.spec, hidden_sizes=hidden, device=device)
    convert.policy_params_from_numpy(policy, params, transforms)
    return env.env, policy


def summary(returns, lengths):
    r = np.asarray(returns, np.float64)
    return {"mean": float(r.mean()), "se": float(r.std() / np.sqrt(len(r))),
            "len": float(np.mean(lengths)), "n": int(len(r))}


def z_score(a, b):
    return (a["mean"] - b["mean"]) / float(np.hypot(a["se"], b["se"]))


def evaluate(golden=GOLDEN, device=None, ntraj=100, horizon=1000):
    """-> dict: the port's and the JAX package's ``stoch`` and ``eval``
    summaries, ``z`` of each, the port's per-path returns and seconds."""
    device = resolve_device(device)
    env, policy = load_policy(golden, device)
    gen = make_generator(0, device)
    z = np.load(golden)
    out = {"device": str(device), "ntraj": ntraj, "horizon": horizon}
    for mode, eval_mode in (("stoch", False), ("eval", True)):
        t0 = time.time()
        paths = rollout_batch(env, policy.config, policy.params,
                              policy.transforms, gen, ntraj, horizon=horizon,
                              eval_mode=eval_mode)
        mask = paths["mask"].double()
        ret = torch.sum(paths["rewards"].double() * mask, 1).cpu().numpy()
        lens = mask.sum(1).cpu().numpy()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        port = summary(ret, lens)
        jax_side = summary(z[f"{mode}_returns"], z[f"{mode}_lengths"])
        out[mode] = {"port": port, "jax": jax_side,
                     "z": z_score(port, jax_side),
                     "seconds": time.time() - t0,
                     "port_returns": [float(x) for x in ret]}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--golden", default=GOLDEN)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("no CUDA GPU found: pass --device cpu to run on "
                           "the CPU")
    out = evaluate(args.golden, args.device)
    print(json.dumps(out), flush=True)
    if abs(out["stoch"]["z"]) > MAX_Z:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()
