"""Port vs JAX package: peg insertion (CPU, float64).

- Two control steps from the MuJoCo golden contact states, the hole moved
  per state, against the JAX env's vmapped ``step`` at 1e-9: the
  constraint rows frozen for the control step, the top-64 cap of the 282
  condim-1 slots.  (``test_torch_envs_ant.py`` and
  ``test_torch_envs_humanoid.py`` do the same for Ant-v3, whose rows are
  rebuilt at every RK4 stage, and Humanoid-v3; each file compiles the JAX
  control step once, 30-80 s on a CPU.)
- Peg's scenery moves the bodies target, w4 and w3 (the hole and its two
  walls) as the JAX package's ``_patched_model``; the env-state round
  trip (``target_pos``) through ``GymEnv``.
- The port's own resets keep the JAX package's semantics (Ant: the root
  quaternion renormalized after the additive noise, as the JAX package's
  formula gives on the same draw; peg: the hole's y in [0.1, 0.5], the arm
  at rest).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.envs.peg_insertion import PegEnv as JaxPeg
from mjrl_tpu.physics.kinematics import fwd_kinematics as jax_fk
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.envs.gym_suite import AntEnv
from mjrl_tpu_torch.envs.peg_insertion import PegEnv
from mjrl_tpu_torch.physics.kinematics import fwd_kinematics

from test_torch_collision3d import GOLDEN
from test_torch_mjcf_m9b import one_torch_thread  # noqa: F401

B, TOL = 6, 1e-9


def jax_batch_state(jenv, q, v, scenery):
    """A batch of JAX env states at (q, v) with the given scenery, traced
    as one program (eagerly, each of its hundreds of operations compiles
    on its own)."""
    def batch_state(q, v, sc):
        s = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), B))
        phys = s.physics.replace(qpos=q, qvel=v)
        s = s.replace(physics=phys, scenery=sc or s.scenery)
        return jax.vmap(lambda x: x.replace(obs=jenv._obs(
            jax_fk(jenv._patched_model(x.scenery), x.physics.qpos),
            x.scenery, x.physics)))(s)
    return jax.jit(batch_state)(
        jnp.asarray(q), jnp.asarray(v),
        {k: jnp.asarray(x) for k, x in scenery.items()})


def _golden(name):
    g = np.load(os.path.join(GOLDEN, f"contact_{name}.npz"))
    return g["qpos"][:B], g["qvel"][:B]


def step_both(jenv, tenv, golden, scenery, seed=8):
    """Two control steps of the JAX env and the port from the golden
    contact states -> [(jax state, port state)] * 3."""
    rng = np.random.RandomState(seed)
    q, v = _golden(golden)
    acts = rng.uniform(-1.3, 1.3, (2, B, tenv.action_dim))
    js = jax_batch_state(jenv, q, v, scenery)
    ts = tenv.state_from_qpos_qvel(q, v, scenery)
    step = jax.jit(jax.vmap(jenv.step))
    out = [(js, ts)]
    for t in range(2):
        js = step(js, jnp.asarray(acts[t]))
        ts = tenv.step(ts, torch.tensor(acts[t]))
        out.append((js, ts))
    return out


def compare_steps(name, out):
    """obs, reward, qpos at 1e-9, qvel at 1e-9 of the largest, done
    exactly, at every step; the steps change the velocities through
    contact."""
    for t, (js, ts) in enumerate(out):
        for k in ("obs", "reward"):
            w = np.asarray(getattr(js, k))
            np.testing.assert_allclose(getattr(ts, k).numpy(), w, rtol=TOL,
                                       atol=TOL, err_msg=f"{name} {k} {t}")
        np.testing.assert_allclose(ts.physics.qpos.numpy(),
                                   np.asarray(js.physics.qpos), rtol=TOL,
                                   atol=TOL)
        scale = max(np.abs(np.asarray(js.physics.qvel)).max(), 1.0)
        np.testing.assert_allclose(ts.physics.qvel.numpy(),
                                   np.asarray(js.physics.qvel), rtol=TOL,
                                   atol=TOL * scale)
        assert ts.done.tolist() == np.asarray(js.done).tolist(), (name, t)
    dv = (out[1][1].physics.qvel - out[0][1].physics.qvel).abs().max()
    assert float(dv) > 0.1, name


def test_peg_control_steps_match_jax():
    jenv, tenv = JaxPeg(dtype=jnp.float64), PegEnv(dtype=torch.float64,
                                                   device="cpu")
    m = tenv.model
    assert m.solver == 1 and tenv._planar is None
    assert (m.row_freeze_step, m.contact_topk) == (True, 64)
    goal_y = np.random.RandomState(7).uniform(0.1, 0.5, B)
    compare_steps("peg", step_both(jenv, tenv, "peg_insertion",
                                   {"goal_y": goal_y}))


def test_own_resets_keep_the_jax_semantics():
    ant = AntEnv(dtype=torch.float64, device="cpu")
    s = ant.reset(64, torch.Generator().manual_seed(5))
    # the same draw, renormalized by the JAX package's formula
    g = torch.Generator().manual_seed(5)
    raw = ant.init_qpos + (torch.rand((64, ant.nq), generator=g,
                                      dtype=torch.float64) * 0.2 - 0.1)
    quat = jnp.asarray(raw[:, 3:7].numpy())
    want = quat / jnp.sqrt(jnp.sum(quat * quat, axis=-1, keepdims=True)
                           + 1e-12)
    np.testing.assert_allclose(s.physics.qpos[:, 3:7].numpy(),
                               np.asarray(want), rtol=0, atol=1e-15)
    np.testing.assert_allclose(s.physics.qpos[:, [0, 1, 2] + list(
        range(7, 15))].numpy(), raw[:, [0, 1, 2] + list(range(7, 15))])
    assert float(s.physics.qvel.std()) == pytest.approx(0.1, rel=0.2)
    peg = PegEnv(dtype=torch.float64, device="cpu")
    s = peg.reset(256, torch.Generator().manual_seed(1))
    gy = s.scenery["goal_y"]
    assert 0.1 <= float(gy.min()) and float(gy.max()) <= 0.5
    assert float(gy.max() - gy.min()) > 0.3
    assert not s.physics.qpos.any() and not s.physics.qvel.any()
    np.testing.assert_allclose(s.obs[:, -2].numpy(), gy.numpy(), atol=1e-15)


def test_peg_scenery_moves_the_hole_and_walls():
    jenv = JaxPeg(dtype=jnp.float64)
    tenv = PegEnv(dtype=torch.float64, device="cpu")
    q = np.tile(np.random.RandomState(2).uniform(-0.5, 0.5, 7), (B, 1))
    gy = np.linspace(0.1, 0.5, B)
    want = jax.jit(jax.vmap(lambda a, y: jax_fk(jenv._patched_model(
        {"goal_y": y}), a).xpos))(jnp.asarray(q), jnp.asarray(gy))
    bp = tenv._body_pos({"goal_y": torch.tensor(gy)})
    got = fwd_kinematics(tenv.model, torch.tensor(q), body_pos=bp).xpos
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-15)
    moved = np.flatnonzero((got[1] - got[0]).abs().sum(-1).numpy() > 1e-9)
    assert sorted(moved.tolist()) == sorted(tenv._moved_bodies)


def test_peg_env_state_round_trip():
    jenv = JaxPeg(dtype=jnp.float64)
    e = GymEnv("mjrl_peg_insertion-v0", device="cpu",
               env_kwargs={"dtype": torch.float64})
    e.reset(seed=4)
    for _ in range(2):
        e.step(np.full(7, 0.5))
    st = e.get_env_state()
    assert set(st) == {"qp", "qv", "target_pos"}
    js = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), 1))
    js = jax.vmap(jenv.set_env_state)(js, {k: jnp.asarray(v)[None]
                                           for k, v in st.items()})
    np.testing.assert_allclose(
        np.asarray(jax.vmap(jenv.get_env_state)(js)["target_pos"])[0],
        st["target_pos"], rtol=0, atol=1e-15)
    np.testing.assert_allclose(np.asarray(js.obs)[0], e.get_obs(), rtol=0,
                               atol=1e-12)
    obs = e.get_obs()
    e.reset(seed=9)
    assert np.abs(e.get_obs() - obs).max() > 1e-3
    e.set_env_state(st)
    np.testing.assert_allclose(e.get_obs(), obs, rtol=0, atol=0)
