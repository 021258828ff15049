"""Port vs JAX package: one iteration of ``point_mass_npg.json`` (CPU,
float64) — the general engine's slice as a whole.

The configuration's agent (NPG, step 0.05, gamma 0.95, GAE 0.97, a 32-32
policy with log std 0, an ``MLPBaseline`` 128-128 with batch 64, 2 epochs,
learning rate 1e-3) at 8 paths x 25 steps:

- the JAX rollout (``rollout_batch`` from a key) against the port's with
  the JAX draws injected: its start states and targets from
  ``env.reset(k_reset)``, its action noise from ``split(k_scan, T)``;
  every leaf at 1e-9 (25 RK4 control steps of the point mass);
- the processing (returns, GAE, whitening), the NPG update and the
  baseline fit, with the fit's permutations the JAX package's own
  (``perms=``): returns and advantages at 1e-10, the new policy, the step
  statistics and the new baseline at 1e-8;
- ``success_rate`` and the evaluation rollout's ``eval_success`` through
  ``evaluate_success``, as ``train_agent`` logs them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import baselines as jhost
from mjrl_tpu.algos.npg_cg import NPG as JaxNPG
from mjrl_tpu.envs.point_mass import PointMassEnv as JaxPointMass
from mjrl_tpu.models import policies as jpol
from mjrl_tpu.models.fc_network import \
    identity_transforms as jax_identity_transforms
from mjrl_tpu.samplers import rollout as jrollout
from mjrl_tpu_torch import baselines as thost
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos import NPG
from mjrl_tpu_torch.envs.point_mass import PointMassEnv
from mjrl_tpu_torch.models import policies as tpol
from mjrl_tpu_torch.samplers import rollout as trollout
from mjrl_tpu_torch.utils.config import load_config

from test_torch_baselines import jax_perms
from test_torch_npg import close, close_tree
from test_torch_policy import numpy_params, to_jax

HERE = os.path.dirname(os.path.abspath(__file__))
B, T = 8, 25
ROLL_TOL = 1e-9


@pytest.fixture(scope="module")
def job():
    return load_config(os.path.join(HERE, "..", "examples",
                                    "example_configs", "point_mass_npg.json"))


def _jax_draws(jenv, key):
    @jax.jit
    def draws(key):               # one program: eagerly, each op compiles
        keys = jax.random.split(key, B)
        k_reset, k_scan = jax.vmap(jax.random.split)(keys).transpose(1, 0,
                                                                     2)
        s0 = jax.vmap(jenv.reset)(k_reset)
        kt = jax.vmap(lambda k: jax.random.split(k, T))(k_scan)
        return s0, jax.vmap(jax.vmap(lambda k: jax.random.normal(
            k, (2,), jnp.float64)))(kt)
    s0, noise = draws(key)
    return (np.asarray(s0.physics.qpos), np.asarray(s0.physics.qvel),
            np.asarray(s0.scenery["target_pos"]),
            np.swapaxes(np.asarray(noise), 0, 1))


@pytest.fixture(scope="module")
def agents(job):
    hid = tuple(job["policy_size"])
    jenv = JaxPointMass(dtype=jnp.float64)
    tenv = PointMassEnv(dtype=torch.float64, device="cpu")
    p_np = numpy_params(61, hid, obs=6, act=2)
    p_np["log_std"] = np.full(2, job["init_log_std"])
    rng = np.random.RandomState(62)
    sizes = (6 + 4,) + tuple(job["vf_hidden_size"]) + (1,)
    layers = [{"w": rng.normal(0, 0.2, (sizes[i], sizes[i + 1])),
               "b": rng.normal(0, 0.1, (sizes[i + 1],))}
              for i in range(len(sizes) - 1)]
    bl_kw = dict(hidden_sizes=tuple(job["vf_hidden_size"]),
                 batch_size=job["vf_batch_size"], epochs=job["vf_epochs"],
                 learn_rate=job["vf_learn_rate"])

    jpolicy = jpol.MLP(jenv.spec, hidden_sizes=hid)
    jpolicy.params = jpolicy.old_params = to_jax(p_np)
    jpolicy.transforms = jax_identity_transforms(6, 2, jnp.float64)
    jbl = jhost.MLPBaseline(jenv.spec, **bl_kw)
    jp = jax.tree_util.tree_map(jnp.asarray, layers)
    jbl.state = (jp, jbl.cfg._optimizer().init(jp))
    jagent = JaxNPG(jenv, jpolicy, jbl,
                    normalized_step_size=job["rl_step_size"])

    tpolicy = tpol.MLP(tenv.spec, hidden_sizes=hid, dtype=torch.float64,
                       device="cpu")
    convert.policy_params_from_numpy(tpolicy, p_np)
    tbl = thost.MLPBaseline(tenv.spec, dtype=torch.float64, device="cpu",
                            **bl_kw)
    convert.mlp_baseline_from_numpy(tbl, layers)
    tagent = NPG(tenv, tpolicy, tbl,
                 normalized_step_size=job["rl_step_size"], device="cpu")
    return jenv, tenv, jpolicy, tpolicy, jbl, tbl, jagent, tagent


@pytest.fixture(scope="module")
def batches(agents):
    jenv, tenv, jpolicy, tpolicy = agents[:4]
    key = jax.random.PRNGKey(63)
    jb = jrollout.rollout_batch(jenv, jpolicy.config, jpolicy.params,
                                jpolicy.transforms, key, B, horizon=T)
    q0, v0, target, noise = _jax_draws(jenv, key)
    tb = trollout.rollout_batch(
        tenv, tpolicy.config, tpolicy.params, tpolicy.transforms, None, B,
        horizon=T, state0=tenv.state_from_qpos_qvel(
            q0, v0, {"target_pos": target}), noise=torch.tensor(noise))
    return jax.tree_util.tree_map(np.asarray, jb), tb


def test_rollout_matches_the_jax_rollout(batches):
    jb, tb = batches
    for k in ("observations", "actions", "rewards", "agent_mean",
              "agent_log_std", "mask", "last_obs"):
        np.testing.assert_allclose(tb[k].numpy(), jb[k], rtol=ROLL_TOL,
                                   atol=ROLL_TOL, err_msg=k)
    assert tb["env_infos"]["solved"].tolist() \
        == jb["env_infos"]["solved"].tolist()
    assert tb["terminated"].tolist() == jb["terminated"].tolist()


def test_one_npg_iteration_matches_jax(job, agents, batches):
    _, tenv, jpolicy, tpolicy, jbl, tbl, jagent, tagent = agents
    _, tb = batches
    gamma, lam = job["rl_gamma"], job["rl_gae"]
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in tb.items()
              if torch.is_tensor(v)}
    _, jprocess, jupdate, jfit = jagent._get_phases(B, T, gamma, lam)
    _, tprocess, tupdate, _ = tagent._get_phases(B, T, gamma, lam)
    jret, jadv, _ = jprocess(jbl.state, jbatch)
    tret, tadv, _ = tprocess(tbl.state, tb)
    close(tret, jret, 1e-10)
    close(tadv, jadv, 1e-10)

    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    jnew, jst = jupdate(jpolicy.params, jpolicy.transforms,
                        flat(jbatch["observations"]), flat(jbatch["actions"]),
                        jadv, flat(jbatch["mask"]), jax.random.PRNGKey(0))
    tnew, tst = tupdate(tpolicy.params, tpolicy.transforms,
                        flat(tb["observations"]), flat(tb["actions"]),
                        tadv, flat(tb["mask"]),
                        torch.Generator().manual_seed(0))
    close_tree(tnew, jnew, 1e-8)
    for k in ("alpha", "kl_dist", "surr_before", "surr_after"):
        close(tst[k], jst[k], 1e-8)

    key = jax.random.PRNGKey(64)
    epochs = job["vf_epochs"]
    jstate, je0, je1 = jfit(jbl.state, jbatch["observations"], jret,
                            jbatch["mask"], key)
    tstate, te0, te1 = tbl.cfg.fit(tbl.state, tb["observations"], tret,
                                   tb["mask"],
                                   perms=jax_perms(key, epochs, B * T))
    for lt, lj in zip(convert.layers_to_numpy(tstate[0]), jstate[0]):
        close(lt["w"], lj["w"], 1e-8)
        close(lt["b"], lj["b"], 1e-8)
    close(te0, je0, 1e-8)
    close(te1, je1, 1e-8)
    assert tstate[1]["count"] == epochs * (B * T // job["vf_batch_size"])


def test_success_metrics_match_jax(batches):
    """success_rate from the batched 'solved' flags and eval_success from
    the list of paths, as the two agents and train_agent compute them."""
    jb, tb = batches
    flags = tb["env_infos"]["solved"].numpy()
    assert PointMassEnv.evaluate_success(flags) \
        == JaxPointMass.evaluate_success(jb["env_infos"]["solved"])
    paths = trollout.paths_to_list(tb)
    assert PointMassEnv.evaluate_success(paths) \
        == JaxPointMass.evaluate_success(paths)
    rewards = PointMassEnv(dtype=torch.float64, device="cpu") \
        .compute_path_rewards({"observations": tb["observations"]})["rewards"]
    want = JaxPointMass(dtype=jnp.float64).compute_path_rewards(
        {"observations": jnp.asarray(jb["observations"])})["rewards"]
    close(rewards, want, 1e-12)
