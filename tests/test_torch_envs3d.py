"""Port vs JAX package: the environments of the general engine (CPU,
float64).

- PointMass (penalty, RK4), the 7-DoF reacher at its default implicit
  solver (Euler, joint limits and the fingertip-table contact through the
  dual) and InvertedPendulum (penalty, RK4): reset with injected scenery
  and state, then 10 control steps of numpy-seeded actions (beyond the
  control range, so the clip acts).  Obs, reward, ``solved`` and done
  against the JAX env's vmapped ``step`` at 1e-9.
- The MuJoCo episodes of ``tests/golden/env_point_mass.npz`` and
  ``env_reacher.npz``: teleported to each recorded pre-step state, one
  control step, obs against MuJoCo's.  The bound is the JAX package's own
  error on the same steps, measured (max over all steps of all episodes,
  float64 on the CPU): point mass 8.9e-16 on every step; reacher 2.65e-6
  over every step (the constraint-active ones included: MuJoCo's own
  solver against the finite-sweep dual) and 2.4e-15 on the
  constraint-free ones.  The port is held to those numbers plus 1e-9.
- The registry ids construct, reset and step through ``GymEnv``, and
  without a GPU an env given no device raises.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.envs.gym_suite import InvertedPendulumEnv as JaxPendulum
from mjrl_tpu.envs.point_mass import PointMassEnv as JaxPointMass
from mjrl_tpu.envs.reacher import Reacher7DOFEnv as JaxReacher
from mjrl_tpu_torch import envs as tenvs
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.envs.gym_suite import InvertedPendulumEnv
from mjrl_tpu_torch.envs.point_mass import PointMassEnv
from mjrl_tpu_torch.envs.reacher import Reacher7DOFEnv

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
B, STEPS, TOL = 12, 10, 1e-9
# the JAX package's own error against the MuJoCo episodes (see above)
JAX_GOLDEN_ERR = {"point_mass": (8.9e-16, 8.9e-16),
                  "reacher": (2.66e-6, 2.4e-15)}


def _pm_start(rng):
    q = rng.uniform(-1.3, 1.3, (B, 2))
    q[0] = (1.39, -1.39)                      # at the joint limits
    tgt = np.concatenate([rng.uniform(-1, 1, (B, 2)),
                          np.full((B, 1), 0.05)], axis=-1)
    return q, rng.uniform(-1, 1, (B, 2)), {"target_pos": tgt}


def _reacher_start(rng):
    lo = np.array([-2.2854, -0.5236, -1.5, -2.3213, -1.5, -1.094, -1.5])
    hi = np.array([1.714602, 1.3963, 1.7, 0.0, 1.5, 0.0, 1.5])
    q = rng.uniform(lo - 0.05, hi + 0.05, (B, 7))
    q[:3] = 0.0                               # the reset pose: at a limit
    tgt = rng.uniform(-1, 1, (B, 3)) * np.array([0.3, 0.2, 0.25])
    return q, rng.uniform(-2, 2, (B, 7)), {"target_pos": tgt}


def _pendulum_start(rng):
    q = rng.uniform(-0.15, 0.15, (B, 2))
    return q, rng.uniform(-0.5, 0.5, (B, 2)), {}


CASES = {
    "point_mass": (JaxPointMass, PointMassEnv, _pm_start, 1.5),
    "reacher": (JaxReacher, Reacher7DOFEnv, _reacher_start, 1.5),
    "inverted_pendulum": (JaxPendulum, InvertedPendulumEnv,
                          _pendulum_start, 4.0),
}


def jax_batch_state(jenv, q, v, scenery):
    """Traced as one program (eagerly, each operation compiles alone)."""
    def batch_state(d):
        s = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), B))
        return jax.vmap(jenv.set_env_state)(s, d)
    return jax.jit(batch_state)(
        dict(qp=jnp.asarray(q), qv=jnp.asarray(v),
             **{k: jnp.asarray(x) for k, x in scenery.items()}))


@pytest.fixture(scope="module", params=list(CASES))
def trajectories(request):
    jcls, tcls, start, amax = CASES[request.param]
    rng = np.random.RandomState(11)
    q, v, scenery = start(rng)
    jenv = jcls(dtype=jnp.float64)
    tenv = tcls(dtype=torch.float64, device="cpu")
    acts = rng.uniform(-amax, amax, (STEPS, B, tenv.action_dim))
    js = jax_batch_state(jenv, q, v, scenery)
    ts = tenv.state_from_qpos_qvel(q, v, scenery)
    step = jax.jit(jax.vmap(jenv.step))
    out = [(js, ts)]
    for t in range(STEPS):
        js = step(js, jnp.asarray(acts[t]))
        ts = tenv.step(ts, torch.tensor(acts[t]))
        out.append((js, ts))
    return request.param, tenv, out


def test_obs_reward_done_match_jax(trajectories):
    name, _, out = trajectories
    for t, (js, ts) in enumerate(out):
        for k in ("obs", "reward"):
            np.testing.assert_allclose(getattr(ts, k).numpy(),
                                       np.asarray(getattr(js, k)), rtol=TOL,
                                       atol=TOL, err_msg=f"{name} {k} {t}")
        assert ts.done.tolist() == np.asarray(js.done).tolist(), (name, t)
        assert set(ts.info) == set(js.info)
        for k in ts.info:
            assert ts.info[k].tolist() == np.asarray(js.info[k]).tolist()
        np.testing.assert_allclose(ts.physics.qpos.numpy(),
                                   np.asarray(js.physics.qpos), rtol=TOL,
                                   atol=TOL)
        assert ts.t.tolist() == np.asarray(js.t).tolist()


def test_trajectories_exercise_the_engine(trajectories):
    """Limits, contacts and episode ends are reached, not only the smooth
    interior."""
    name, tenv, out = trajectories
    q = np.stack([ts.physics.qpos.numpy() for _, ts in out])
    if name == "inverted_pendulum":
        assert out[-1][1].done.any() and not out[-1][1].done.all()
        return
    lo, hi = tenv.model.jnt_range[:, 0], tenv.model.jnt_range[:, 1]
    assert ((q < lo) | (q > hi)).any(), name
    if name == "point_mass":
        assert out[-1][1].info["solved"].dtype == torch.bool


def _golden_errors(g, env_step, set_state, n_eps):
    """Max |obs - MuJoCo obs| over every teleported step and over the
    constraint-free ones."""
    err_all = err_clean = 0.0
    for ep in range(n_eps):
        for t, a in enumerate(g[f"ep{ep}_actions"]):
            obs = env_step(set_state(ep, g[f"ep{ep}_qpos_before"][t],
                                     g[f"ep{ep}_qvel_before"][t]), a)
            e = float(np.abs(obs - g[f"ep{ep}_obs"][t]).max())
            err_all = max(err_all, e)
            if g[f"ep{ep}_clean"][t]:
                err_clean = max(err_clean, e)
    return err_all, err_clean


@pytest.mark.parametrize("name", ["point_mass", "reacher"])
def test_golden_episodes_within_the_jax_error(name):
    g = np.load(os.path.join(GOLDEN, f"env_{name}.npz"))
    n = int(g["n_eps"])
    tenv = (PointMassEnv if name == "point_mass" else Reacher7DOFEnv)(
        dtype=torch.float64, device="cpu")
    nq = tenv.model.nq

    def target(ep):
        if name == "point_mass":
            return np.concatenate([g[f"ep{ep}_target"], [0.05]])
        return g[f"ep{ep}_target"]

    for ep in range(n):
        q0 = g[f"ep{ep}_qp"] if name == "point_mass" else np.zeros(nq)
        s0 = tenv.state_from_qpos_qvel(q0[None], np.zeros((1, nq)),
                                       {"target_pos": target(ep)[None]})
        np.testing.assert_allclose(s0.obs[0].numpy(), g[f"ep{ep}_obs0"],
                                   atol=1e-12)

    def set_state(ep, q, v):
        return tenv.state_from_qpos_qvel(q[None], v[None],
                                         {"target_pos": target(ep)[None]})

    def step(s, a):
        return tenv.step(s, torch.tensor(a)[None]).obs[0].numpy()

    err_all, err_clean = _golden_errors(g, step, set_state, n)
    bound_all, bound_clean = JAX_GOLDEN_ERR[name]
    assert err_all <= bound_all + 1e-9, err_all
    assert err_clean <= bound_clean + 1e-9, err_clean


@pytest.mark.parametrize("env_id, obs_dim, act_dim, horizon", [
    ("mjrl_point_mass-v0", 6, 2, 25),
    ("mjrl_reacher_7dof-v0", 20, 7, 50),
    ("InvertedPendulum-v2", 4, 1, 1000),
    ("InvertedPendulum-v4", 4, 1, 1000)])
def test_registry_ids_through_gym_env(env_id, obs_dim, act_dim, horizon):
    e = GymEnv(env_id, device="cpu")
    assert (e.spec.observation_dim, e.spec.action_dim, e.spec.horizon) \
        == (obs_dim, act_dim, horizon)
    o = e.reset(seed=3)
    assert np.asarray(o).shape == (obs_dim,)
    for _ in range(3):
        o, r, done, info = e.step(np.full(act_dim, 0.3))
    assert np.all(np.isfinite(o)) and np.isfinite(r)
    assert env_id in tenvs.registered_ids()
    # the planar kernels are never on this path
    assert e.env._planar is None


@pytest.mark.parametrize("cls", [PointMassEnv, Reacher7DOFEnv,
                                 InvertedPendulumEnv])
def test_no_gpu_no_device_raises(cls):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cls()
