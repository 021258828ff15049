"""Write the Hopper-v3 policy golden that the PyTorch/CUDA port is held to:
a JAX-package policy's numbers and the JAX package's own evaluation of it.

    JAX_PLATFORMS=cpu python tools/parity_hopper_golden.py \
        --policy jax_hopper_123_best.pkl \
        --out tests/golden/torch_hopper_npg_jax_policy.npz

``--policy`` is a policy pickle written by ``tools/train_gym.py --save``.
The ``.npz`` holds, in ``mjrl_tpu_torch.convert.policy_npz_arrays``'
layout, the policy's layers (``layers.<i>.w`` (in, out), ``layers.<i>.b``),
``log_std`` and transforms; then 16 observations of its own Hopper-v3
paths (``obs``) and its mean actions on them (``mean_actions``); and the
JAX package's float32 evaluation on Hopper-v3 (newton solver, the env's
default) of 100 paths of 1000 steps, stochastic and in ``eval_mode``:
the per-path returns and lengths (``stoch_returns``, ``stoch_lengths``,
``eval_returns``, ``eval_lengths``), the key's ``seed`` and the seconds
each evaluation took on this machine.  Runs the JAX package; of the port
it imports only ``convert``'s layout of the file.
"""

import argparse
import json
import os
import pickle
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

from mjrl_tpu.envs import GymEnv  # noqa: E402
from mjrl_tpu.samplers.rollout import rollout_batch  # noqa: E402
from mjrl_tpu_torch.convert import policy_npz_arrays  # noqa: E402


def evaluate(env, policy, key, ntraj, horizon, eval_mode):
    fn = jax.jit(lambda p, tr, k: rollout_batch(
        env, policy.config, p, tr, k, ntraj, horizon=horizon,
        eval_mode=eval_mode))
    t0 = time.time()
    paths = fn(policy.params, policy.transforms, key)
    mask = np.asarray(paths["mask"], np.float64)
    returns = np.sum(np.asarray(paths["rewards"], np.float64) * mask, 1)
    return paths, returns, mask.sum(1), time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--policy", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    ntraj, horizon, seed = 100, 1000, 0

    with open(args.policy, "rb") as f:
        policy = pickle.load(f)
    env = GymEnv("Hopper-v3").env
    k_stoch, k_eval = jax.random.split(jax.random.PRNGKey(seed))
    paths, stoch_r, stoch_l, stoch_s = evaluate(
        env, policy, k_stoch, ntraj, horizon, False)
    _, eval_r, eval_l, eval_s = evaluate(
        env, policy, k_eval, ntraj, horizon, True)

    # 16 observations of the stochastic paths, spread over paths and time
    obs = np.asarray(paths["observations"])
    rows = np.arange(16) % obs.shape[0]
    cols = np.minimum((np.arange(16) * 7) % obs.shape[1],
                      np.asarray(stoch_l, np.int64)[rows] - 1)
    obs16 = obs[rows, cols]
    mean, _ = policy.config.dist_info(policy.params, policy.transforms,
                                      obs16)

    arrays = policy_npz_arrays(policy.params, policy.transforms)
    np.savez(args.out, obs=obs16, mean_actions=np.asarray(mean),
             stoch_returns=stoch_r, stoch_lengths=stoch_l,
             eval_returns=eval_r, eval_lengths=eval_l,
             seed=np.asarray(seed),
             seconds=np.asarray([stoch_s, eval_s]), **arrays)
    se = lambda x: float(np.std(x) / np.sqrt(len(x)))
    print(json.dumps({
        "out": args.out, "ntraj": ntraj, "horizon": horizon,
        "stoch_mean": float(np.mean(stoch_r)), "stoch_se": se(stoch_r),
        "stoch_len": float(np.mean(stoch_l)),
        "eval_mean": float(np.mean(eval_r)), "eval_se": se(eval_r),
        "eval_len": float(np.mean(eval_l)),
        "seconds": [stoch_s, eval_s]}))


if __name__ == "__main__":
    main()
