"""One NPG + MLPBaseline iteration of ``tools/bench_hopper.py``'s agent at
its full shape (100 paths x 1000 steps, float32) in the JAX package and in
the PyTorch/CUDA port, on one JAX rollout; prints how far the two agree.

    JAX_PLATFORMS=cpu python tools/parity_hopper_update.py
    JAX_PLATFORMS=cpu python tools/parity_hopper_update.py \
        --policy tests/golden/torch_hopper_npg_jax_policy.npz

Both agents start from the JAX package's policy (its seed-123 initial
64-64 MLP, ``init_log_std`` -0.25, or the policy of a ``--policy`` npz in
``mjrl_tpu_torch.convert.save_policy_npz``'s layout, whose paths run long)
and its ``MLPBaseline(reg_coef 1e-3, batch 64, epochs 2, lr 1e-3)``
weights.  The JAX package rolls out 100 x 1000 Hopper-v3 paths on the
CPU; the same batch goes through both agents' processing (returns, GAE,
whitening), NPG update (step 0.1) and baseline fit, the fit's two
permutations drawn by the JAX package and handed to the port.  Prints one
JSON line: each quantity's largest difference relative to its largest
magnitude, and, for the scale of float32 rounding, the port's update and
fit in float64 on the same numbers against each float32 result.  Runs on
the CPU; imports both packages, as the tests do.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from mjrl_tpu import baselines as jhost  # noqa: E402
from mjrl_tpu.algos.npg_cg import NPG as JaxNPG  # noqa: E402
from mjrl_tpu.envs import GymEnv as JaxGymEnv  # noqa: E402
from mjrl_tpu.models import policies as jpol  # noqa: E402
from mjrl_tpu_torch import baselines as thost  # noqa: E402
from mjrl_tpu_torch import convert  # noqa: E402
from mjrl_tpu_torch.algos import NPG  # noqa: E402
from mjrl_tpu_torch.envs import GymEnv  # noqa: E402
from mjrl_tpu_torch.models import policies as tpol  # noqa: E402

GAMMA, LAM = 0.995, 0.97
BASELINE = dict(reg_coef=1e-3, batch_size=64, epochs=2, learn_rate=1e-3)


def rel(a, b):
    """max |a - b| / max |b| (0 when both are 0)."""
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = float(np.max(np.abs(b))) if b.size else 0.0
    diff = float(np.max(np.abs(a - b))) if b.size else 0.0
    return diff / scale if scale > 0 else diff


def flat_params(tree):
    """JAX-layout policy pytree -> one float64 vector."""
    parts = [np.ravel(np.asarray(v, np.float64))
             for layer in tree["layers"] for v in (layer["w"], layer["b"])]
    return np.concatenate(parts + [np.ravel(np.asarray(tree["log_std"]))])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--policy", default=None,
                    help="npz of the policy to roll out and update "
                         "(default: the JAX package's seed-123 initial MLP)")
    args = ap.parse_args(argv)
    B, T, seed = 100, 1000, 123

    jenv = JaxGymEnv("Hopper-v3")
    jpolicy = jpol.MLP(jenv.spec, hidden_sizes=(64, 64), seed=seed,
                       init_log_std=-0.25)
    if args.policy:
        p_np, tr_np = convert.load_policy_npz(args.policy)
        jpolicy.params = jpolicy.old_params = jax.tree_util.tree_map(
            lambda x: jnp.asarray(x, jnp.float32), p_np)
        jpolicy.transforms = type(jpolicy.transforms)(
            *(jnp.asarray(t, jnp.float32) for t in tr_np))
    jbl = jhost.MLPBaseline(jenv.spec, **BASELINE)
    jagent = JaxNPG(jenv, jpolicy, jbl, normalized_step_size=0.1,
                    seed=seed, save_logs=True)

    tenv = GymEnv("Hopper-v3", device="cpu")
    tpolicy = tpol.MLP(tenv.spec, hidden_sizes=(64, 64), init_log_std=-0.25,
                       device="cpu")
    convert.policy_params_from_numpy(
        tpolicy, jax.tree_util.tree_map(np.asarray, jpolicy.params),
        tuple(np.asarray(t) for t in jpolicy.transforms))
    tbl = thost.MLPBaseline(tenv.spec, device="cpu", **BASELINE)
    convert.mlp_baseline_from_numpy(
        tbl, jax.tree_util.tree_map(np.asarray, jbl.state[0]))
    tagent = NPG(tenv, tpolicy, tbl, normalized_step_size=0.1,
                 seed=seed, device="cpu")

    jroll, jprocess, jupdate, jfit = jagent._get_phases(B, T, GAMMA, LAM)
    _, tprocess, tupdate, _ = tagent._get_phases(B, T, GAMMA, LAM)
    t0 = time.time()
    jbatch = jroll(jpolicy.params, jpolicy.transforms,
                   jax.random.PRNGKey(seed))
    jbatch["rewards"].block_until_ready()
    t_roll = time.time() - t0
    tbatch = {k: torch.as_tensor(np.array(v)) for k, v in jbatch.items()
              if k != "env_infos"}
    tbatch["env_infos"] = {}
    mask = np.asarray(jbatch["mask"])
    out = {"B": B, "T": T, "policy": args.policy or "initial",
           "valid_samples": int(mask.sum()),
           "mean_return": float(np.mean(np.sum(
               np.asarray(jbatch["rewards"]) * mask, 1))),
           "mean_length": float(mask.sum(1).mean()),
           "jax_rollout_s": t_roll}

    jret, jadv, _ = jprocess(jbl.state, jbatch)
    tret, tadv, _ = tprocess(tbl.state, tbatch)
    out["returns"] = rel(tret, jret)
    out["advantages"] = rel(tadv, jadv)

    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    jnew, jst = jupdate(jpolicy.params, jpolicy.transforms,
                        flat(jbatch["observations"]), flat(jbatch["actions"]),
                        jadv, flat(jbatch["mask"]), jax.random.PRNGKey(0))
    # the port's update on the JAX advantages, so the update alone is held
    tnew, tst = tupdate(tpolicy.params, tpolicy.transforms,
                        flat(tbatch["observations"]), flat(tbatch["actions"]),
                        torch.as_tensor(np.asarray(jadv)), flat(tbatch["mask"]),
                        torch.Generator().manual_seed(0))
    for k in ("alpha", "kl_dist", "surr_before", "surr_after"):
        out[k] = {"jax": float(jst[k]), "port": float(tst[k]),
                  "rel": rel(tst[k], jst[k])}
    jflat = flat_params(jax.tree_util.tree_map(np.asarray, jnew))
    tflat = flat_params(convert.params_to_numpy(tnew))
    old = flat_params(jax.tree_util.tree_map(np.asarray, jpolicy.params))
    out["new_params"] = rel(tflat, jflat)
    out["step"] = rel(tflat - old, jflat - old)
    # the scale of float32 rounding: the port's update in float64 on the
    # same numbers, against each float32 step
    p64 = tpol.MLP(tenv.spec, hidden_sizes=(64, 64), dtype=torch.float64,
                   device="cpu")
    convert.policy_params_from_numpy(
        p64, convert.params_to_numpy(tpolicy.params),
        tuple(t.numpy() for t in tpolicy.transforms))
    a64 = NPG(GymEnv("Hopper-v3", device="cpu",
                     env_kwargs={"dtype": torch.float64}), p64,
              thost.MLPBaseline(tenv.spec, dtype=torch.float64,
                                device="cpu", **BASELINE),
              normalized_step_size=0.1, device="cpu")
    d64 = lambda x: flat(tbatch[x]).double()
    new64, st64 = a64._get_phases(B, T, GAMMA, LAM)[2](
        p64.params, p64.transforms, d64("observations"), d64("actions"),
        torch.as_tensor(np.asarray(jadv)).double(), d64("mask"),
        torch.Generator().manual_seed(0))
    flat64 = flat_params(convert.params_to_numpy(new64))
    out["step_float64_vs_jax"] = rel(jflat - old, flat64 - old)
    out["step_float64_vs_port"] = rel(tflat - old, flat64 - old)
    out["alpha"]["float64"] = float(st64["alpha"])
    out["kl_dist"]["float64"] = float(st64["kl_dist"])

    key = jax.random.PRNGKey(seed + 1)
    perms = np.stack([np.asarray(jax.random.permutation(k, B * T))
                      for k in jax.random.split(key, 2)])
    jstate, je0, je1 = jfit(jbl.state, jbatch["observations"], jret,
                            jbatch["mask"], key)
    # the port's fit on the JAX returns, with the JAX permutations
    tstate, te0, te1 = tbl.cfg.fit(tbl.state, tbatch["observations"],
                                   torch.as_tensor(np.asarray(jret)),
                                   tbatch["mask"], perms=perms)
    out["VF_error_before"] = {"jax": float(je0), "port": float(te0)}
    out["VF_error_after"] = {"jax": float(je1), "port": float(te1)}
    layers_rel = lambda a, b: max(
        max(rel(la["w"], lb["w"]), rel(la["b"], lb["b"]))
        for la, lb in zip(a, b))
    tlayers = convert.layers_to_numpy(tstate[0])
    out["baseline_params"] = layers_rel(tlayers, jstate[0])
    # the same fit in float64, the scale of float32 rounding
    bl64 = a64.baseline
    convert.mlp_baseline_from_numpy(bl64, convert.layers_to_numpy(
        tbl.state[0]))
    s64, e064, e164 = bl64.cfg.fit(
        bl64.state, tbatch["observations"].double(),
        torch.as_tensor(np.asarray(jret)).double(), tbatch["mask"].double(),
        perms=perms)
    layers64 = convert.layers_to_numpy(s64[0])
    out["VF_error_after"]["float64"] = float(e164)
    out["baseline_float64_vs_jax"] = layers_rel(jstate[0], layers64)
    out["baseline_float64_vs_port"] = layers_rel(tlayers, layers64)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
