"""``tools/bench_hopper.py``'s agent in the port against the JAX package,
float32, on the CPU.

- One iteration of its NPG + ``MLPBaseline`` (64-64 policy at
  ``init_log_std`` -0.25, the baseline's default 128-128 at batch 64 and
  2 epochs, step 0.1) on one early-terminating Hopper-v3 batch in both
  packages, from the same weights and draws (the baseline fit's
  permutations are the JAX package's): returns and advantages at 1e-5,
  the step size, KL and new policy parameters at 1e-3 (float32 through
  ten CG iterations), the baseline's errors and weights at 1e-4.
- The golden transplant: the JAX package's trained Hopper-v3 policy
  (``tests/golden/torch_hopper_npg_jax_policy.npz``, written by
  ``tools/parity_hopper_golden.py``) loaded into the port gives the JAX
  package's float32 mean actions within 1e-6 (absolute plus relative).
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mjrl_tpu.algos.npg_cg import NPG as JaxNPG
from mjrl_tpu.models import baselines as jfb
from mjrl_tpu.models import policies as jpol
from mjrl_tpu.models.fc_network import Transforms as JTransforms
from mjrl_tpu_torch import baselines as thost
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos import NPG
from mjrl_tpu_torch.envs import gym_suite as tsuite
from mjrl_tpu_torch.models import policies as tpol
from mjrl_tpu_torch.samplers import rollout as trollout

from test_torch_baselines import jax_perms
from test_torch_gym_suite import _start_table
from test_torch_policy import numpy_params

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "torch_hopper_npg_jax_policy.npz")
B, T = 16, 8
GAMMA, LAM = 0.995, 0.97


def rel(a, b):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def f32(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                  tree)


def baseline_layers(seed, sizes=(15, 128, 128, 1)):
    rng = np.random.RandomState(seed)
    return [{"w": rng.normal(0, 1.0 / np.sqrt(sizes[i]),
                             (sizes[i], sizes[i + 1])).astype(np.float32),
             "b": rng.normal(0, 0.1, (sizes[i + 1],)).astype(np.float32)}
            for i in range(len(sizes) - 1)]


def test_bench_hopper_iteration_float32_matches_jax():
    tenv = tsuite.HopperEnv(dtype=torch.float32, device="cpu")
    p_np = numpy_params(61, (64, 64), obs=11, act=3)
    p_np["layers"] = [{k: 0.3 * v.astype(np.float32) for k, v in l.items()}
                      for l in p_np["layers"]]
    p_np["log_std"] = np.full(3, -0.25, np.float32)
    layers = baseline_layers(62)
    bl_kw = dict(reg_coef=1e-3, batch_size=64, epochs=2, learn_rate=1e-3)

    tpolicy = tpol.MLP(tenv.spec, hidden_sizes=(64, 64), init_log_std=-0.25,
                       device="cpu")
    convert.policy_params_from_numpy(tpolicy, p_np)
    tbl = thost.MLPBaseline(tenv.spec, device="cpu", **bl_kw)
    convert.mlp_baseline_from_numpy(tbl, layers)
    tagent = NPG(tenv, tpolicy, tbl, normalized_step_size=0.1, device="cpu")

    # the JAX agent's phases need its policy and baseline configs only (the
    # batch is the port's, so no JAX env steps): no JAX env, policy or
    # baseline object is built, which would compile op by op
    jpolicy = SimpleNamespace(
        config=jpol.GaussianMLP(11, 3, (64, 64), init_log_std=-0.25),
        params=f32(p_np),
        transforms=JTransforms(*(jnp.asarray(t.numpy())
                                 for t in tpolicy.transforms)))
    jbl = SimpleNamespace(cfg=jfb.MLPBaseline(11, **bl_kw), needs_key=True)
    jp = f32(layers)
    jbl.state = (jp, jbl.cfg._optimizer().init(jp))
    jagent = JaxNPG(SimpleNamespace(), jpolicy, jbl,
                    normalized_step_size=0.1)

    # the port's batch from the start table, with injected noise: rows 4-7
    # start about to fall, so paths end early and the masks take part
    q0, v0 = (np.tile(a, (B // 8, 1)) for a in _start_table())
    noise = torch.tensor(np.random.RandomState(63).normal(size=(T, B, 3)),
                         dtype=torch.float32)
    batch = trollout.rollout_batch(
        tenv, tpolicy.config, tpolicy.params, tpolicy.transforms, None, B,
        horizon=T, state0=tenv.state_from_qpos_qvel(q0, v0), noise=noise)
    assert batch["observations"].dtype == torch.float32
    assert 0 < int(batch["terminated"].sum()) < B
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()
              if torch.is_tensor(v)}

    _, jprocess, jupdate, jfit = jagent._get_phases(B, T, GAMMA, LAM)
    _, tprocess, tupdate, _ = tagent._get_phases(B, T, GAMMA, LAM)
    jret, jadv, jpr = jprocess(jbl.state, jbatch)
    tret, tadv, tpr = tprocess(tbl.state, batch)
    assert jadv.dtype == jnp.float32
    assert rel(tret, jret) < 1e-5 and rel(tpr, jpr) < 1e-5
    assert rel(tadv, jadv) < 1e-5

    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    jnew, jst = jupdate(jpolicy.params, jpolicy.transforms,
                        flat(jbatch["observations"]), flat(jbatch["actions"]),
                        jadv, flat(jbatch["mask"]), jax.random.PRNGKey(0))
    tnew, tst = tupdate(tpolicy.params, tpolicy.transforms,
                        flat(batch["observations"]), flat(batch["actions"]),
                        tadv, flat(batch["mask"]),
                        torch.Generator().manual_seed(0))
    for k in ("alpha", "kl_dist", "surr_after"):
        assert rel(tst[k], jst[k]) < 1e-3, k
    got = convert.params_to_numpy(tnew)
    for lg, lj in zip(got["layers"], jnew["layers"]):
        assert rel(lg["w"], lj["w"]) < 1e-3 and rel(lg["b"], lj["b"]) < 1e-3
    assert rel(got["log_std"], jnew["log_std"]) < 1e-3

    key = jax.random.PRNGKey(64)
    jstate, je0, je1 = jfit(jbl.state, jbatch["observations"], jret,
                            jbatch["mask"], key)
    tstate, te0, te1 = tbl.cfg.fit(tbl.state, batch["observations"], tret,
                                   batch["mask"],
                                   perms=jax_perms(key, 2, B * T))
    assert tstate[1]["count"] == 2 * (B * T // 64)
    assert rel(te0, je0) < 1e-4 and rel(te1, je1) < 1e-4
    for lt, lj in zip(convert.layers_to_numpy(tstate[0]), jstate[0]):
        assert rel(lt["w"], lj["w"]) < 1e-4 and rel(lt["b"], lj["b"]) < 1e-4


def test_golden_jax_policy_gives_the_jax_mean_actions():
    z = np.load(GOLDEN)
    params, transforms = convert.load_policy_npz(GOLDEN)
    assert [layer["w"].shape for layer in params["layers"]] == \
        [(11, 64), (64, 64), (64, 3)]
    policy = tpol.MLP(tsuite.HopperEnv(device="cpu").spec,
                      hidden_sizes=(64, 64), device="cpu")
    convert.policy_params_from_numpy(policy, params, transforms)
    mean, log_std = policy.config.dist_info(
        policy.params, policy.transforms, torch.as_tensor(z["obs"]))
    # float32 means of up to ~3 (an ulp 2.4e-7), three layers deep: 1e-6
    # absolute plus 1e-6 relative
    np.testing.assert_allclose(mean.detach().numpy(), z["mean_actions"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(log_std.detach().numpy(),
                                  z["log_std"].astype(np.float32))
    # the JAX package's evaluation travels with it: 100 paths each way
    for mode in ("stoch", "eval"):
        assert z[f"{mode}_returns"].shape == (100,)
        assert np.all(z[f"{mode}_lengths"] <= 1000)
