"""Port vs JAX package: the Adroit hand relocate env (CPU).

- The port's model, built from its own copy of the MJCF
  (``mjrl_tpu_torch/envs/mjcf/adroit/``), against the JAX env's model (from
  the installed gymnasium_robotics) field by field: float64 at 1e-12 (the
  inverse weights at 1e-9), float32 bit for bit (the inverse weights at
  3e-5, which the JAX package evaluates in float32); the row layout (the
  contact counts after the contact_topk cap, the noslip index arrays, the
  row count).
- Forward kinematics: the observation of golden grasp states with drawn
  scenery (the palm and target sites, the moved ball) against the JAX
  env's at 1e-12 on 3 states; its layout [qpos[:30], palm - obj, palm -
  target, obj - target] on 20.
- ``relocate_reward`` (dense and sparse), the success rule and the reset
  distributions' ranges.
- ``qacc_smooth`` of the 20 first golden grasp states against the JAX
  package's at 1e-9 of each state's largest entry, and against MuJoCo's
  golden qacc at the JAX test's bound (median relative error < 0.05,
  ``tests/test_condim4.py:99-131``).

The JAX side needs gymnasium_robotics for its MJCF and is skipped without
it; the port's own checks run regardless.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu_torch import envs as tenvs
from mjrl_tpu_torch.envs.adroit import AdroitRelocateEnv, relocate_reward
from mjrl_tpu_torch.physics import model as tmodel
from mjrl_tpu_torch.physics import solver as tsolver
from mjrl_tpu_torch.physics.model import State
from mjrl_tpu_torch.physics.step import qacc_smooth

from test_torch_mjcf_m9b import one_torch_thread  # noqa: E402,F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "contact_adroit.npz")
FIELDS = [f.name for f in dataclasses.fields(tmodel.Model)]
INVW = ("dof_invweight0", "body_invweight0", "ten_invweight0")
N = 20


def _jax_env(dtype):
    pytest.importorskip("gymnasium_robotics")
    from mjrl_tpu.envs.adroit import AdroitRelocateEnv as JaxAdroit
    return JaxAdroit(dtype=dtype)


@pytest.fixture(scope="module")
def envs64():
    return (_jax_env(jnp.float64),
            AdroitRelocateEnv(dtype=torch.float64, device="cpu"))


def _scenery(n, seed):
    rng = np.random.RandomState(seed)
    return {"obj_pos": np.c_[rng.uniform(-0.15, 0.15, n),
                             rng.uniform(-0.15, 0.3, n), np.full(n, 0.035)],
            "target_pos": np.c_[rng.uniform(-0.2, 0.2, (n, 2)),
                                rng.uniform(0.15, 0.35, n)]}


def test_model_matches_jax_float64(envs64):
    jm, tm = envs64[0].model, envs64[1].model
    for f in FIELDS:
        a, b = getattr(jm, f), getattr(tm, f)
        if isinstance(b, np.ndarray):
            tol = 1e-9 if f in INVW else 1e-12
            np.testing.assert_allclose(b, np.asarray(a, np.float64),
                                       rtol=tol, atol=tol, err_msg=f)
        else:
            assert a == b, (f, a, b)
    assert (tm.nv, tm.nu, tm.ntendon, tm.newton_iters, tm.noslip_iters) == \
        (36, 30, 44, 25, 20)


def test_model_matches_jax_float32():
    jm = _jax_env(jnp.float32).model
    tm = tenvs.make("relocate-v0", device="cpu").model
    for f in FIELDS:
        b = getattr(tm, f)
        if not isinstance(b, np.ndarray):
            continue
        a = np.asarray(getattr(jm, f))
        if f in INVW:
            np.testing.assert_allclose(b, a, rtol=3e-5, atol=1e-30,
                                       err_msg=f)
        else:
            assert a.ravel().tolist() == b.ravel().tolist(), f


def test_row_layout_matches_jax(envs64):
    from mjrl_tpu.physics import solver as jsolver
    jm, tm = envs64[0].model, envs64[1].model
    assert tsolver._contact_counts(tm) == jsolver._contact_counts(jm) \
        == {1: 19, 3: 64, 4: 54, 6: 0}
    assert tsolver.n_constraint_rows(tm) == jsolver.n_constraint_rows(jm)
    for a, b in zip(tsolver._noslip_layout(tm), jsolver._noslip_layout(jm)):
        np.testing.assert_array_equal(a, b)
    # the twice-declared finger pair is kept once, as the JAX package keeps it
    assert len(tm.contact_pairs) == len(set(tm.contact_pairs)) \
        == len(jm.contact_pairs) == 103


def test_observations_match_jax(envs64):
    """The sites and the moved ball through both packages' forward
    kinematics (the JAX side eagerly, on 3 of the states: its compiled FK
    of this model alone costs 17 s here), then the layout on all 20."""
    from mjrl_tpu.physics.kinematics import fwd_kinematics as jax_fk
    from mjrl_tpu.physics.model import State as JState
    jenv, tenv = envs64
    g = np.load(GOLDEN)
    q, v = g["qpos"][:N], g["qvel"][:N]
    sc = _scenery(N, 1)
    ts = tenv.state_from_qpos_qvel(q, v, sc)
    obs = ts.obs.numpy()
    for i in range(3):
        scenery = {k: jnp.asarray(x[i]) for k, x in sc.items()}
        data = jax_fk(jenv._patched_model(scenery), jnp.asarray(q[i]))
        want = jenv._obs(data, scenery, JState(qpos=jnp.asarray(q[i]),
                                               qvel=jnp.asarray(v[i])))
        np.testing.assert_allclose(obs[i], np.asarray(want), rtol=1e-12,
                                   atol=1e-12)
    np.testing.assert_array_equal(obs[:, :30], q[:, :30])
    np.testing.assert_allclose(obs[:, 30:33] - obs[:, 33:36],
                               -obs[:, 36:39], atol=1e-12)
    assert ts.info["goal_achieved"].dtype == torch.bool


def test_reward_and_success_match_jax():
    pytest.importorskip("gymnasium_robotics")
    from mjrl_tpu.envs.adroit import AdroitRelocateEnv as JaxAdroit
    from mjrl_tpu.envs.adroit import relocate_reward as jax_reward
    rng = np.random.RandomState(2)
    palm = rng.uniform(-0.3, 0.3, (64, 3))
    target = rng.uniform(-0.2, 0.3, (64, 3))
    obj = target + rng.normal(0, 0.08, (64, 3))     # both bonus radii hit
    obj[::3, 2] = 0.02                              # on the table
    for sparse in (False, True):
        jr, jg = jax.vmap(lambda p, o, t: jax_reward(p, o, t, sparse))(
            jnp.asarray(palm), jnp.asarray(obj), jnp.asarray(target))
        tr, tg = relocate_reward(torch.tensor(palm), torch.tensor(obj),
                                 torch.tensor(target), sparse)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-12,
                                   atol=1e-12)
        assert tg.tolist() == np.asarray(jg).tolist()
    d = np.linalg.norm(obj - target, axis=1)
    assert (d < 0.05).any() and ((d > 0.05) & (d < 0.1)).any()
    flags = rng.rand(12, 60) < np.linspace(0.2, 0.8, 12)[:, None]
    paths = [{"env_infos": {"goal_achieved": f}} for f in flags]
    for arg in (paths, flags):
        assert AdroitRelocateEnv.evaluate_success(arg) \
            == JaxAdroit.evaluate_success(arg)
    assert 0.0 < AdroitRelocateEnv.evaluate_success(flags) < 100.0


def test_reset_distributions():
    env = AdroitRelocateEnv(dtype=torch.float64, device="cpu")
    s = env.reset(4096, torch.Generator().manual_seed(0))
    obj, target = s.scenery["obj_pos"].numpy(), s.scenery["target_pos"].numpy()
    for x, lo, hi in ((obj[:, 0], -0.15, 0.15), (obj[:, 1], -0.15, 0.3),
                      (target[:, 0], -0.2, 0.2), (target[:, 1], -0.2, 0.2),
                      (target[:, 2], 0.15, 0.35)):
        assert lo <= x.min() and x.max() <= hi
        assert x.min() < lo + 0.01 and x.max() > hi - 0.01
    np.testing.assert_array_equal(obj[:, 2], env.model.body_pos[
        env._obj_bid, 2])
    np.testing.assert_array_equal(s.physics.qpos.numpy(),
                                  np.tile(env.model.qpos0, (4096, 1)))
    assert not s.physics.qvel.any()
    # the ball sits at its drawn position, the target site at its own
    obs = s.obs.numpy()
    np.testing.assert_allclose(obs[:, 36:39], obj - target, atol=1e-12)
    # the normalized action space
    assert env.act_low.tolist() == [-1.0] * 30
    assert env.act_high.tolist() == [1.0] * 30
    assert env.spec == tenvs.EnvSpec(39, 30, 200)


def test_golden_grasp_qacc_matches_jax_and_mujoco(envs64):
    from mjrl_tpu.physics.model import State as JState
    from mjrl_tpu.physics.step import qacc_smooth as jax_qacc_smooth
    jenv, tenv = envs64
    g = np.load(GOLDEN)
    q, v, u = g["qpos"][:N], g["qvel"][:N], g["ctrl"][:N]
    got = qacc_smooth(tenv.model, State(qpos=torch.tensor(q),
                                        qvel=torch.tensor(v)),
                      torch.tensor(u)).numpy()
    scale = np.maximum(np.abs(g["qacc"][:N]).max(1), 1.0)
    errs = np.abs(got - g["qacc"][:N]).max(1) / scale
    assert np.median(errs) < 0.05, (np.median(errs), np.sort(errs)[-5:])
    acc = jax.jit(jax.vmap(lambda qq, vv, uu: jax_qacc_smooth(
        jenv.model, JState(qpos=qq, qvel=vv), uu)))
    want = np.asarray(acc(jnp.asarray(q), jnp.asarray(v), jnp.asarray(u)))
    rel = np.abs(got - want).max(1) / np.maximum(np.abs(want).max(1), 1.0)
    assert rel.max() < 1e-9, rel.max()
