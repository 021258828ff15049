"""Port vs JAX package: fixed tendons (CPU, float64).

- The tendon tables of gymnasium's ``humanoid.xml`` (two unlimited
  hip-knee tendons) and of two small chains (``tests/test_tendons.py``'s
  models: a sprung, damped tendon with a springlength deadband and a
  motor on a joint; a length-limited tendon; tendon transmissions are
  held in ``test_torch_actuators.py``) against the JAX package's, ``ten_invweight0`` included.
- Lengths, the passive spring/damper force, the penalty path's limit
  acceleration and the implicit solver's tendon-limit row against the JAX
  package's at 1e-9, on states that cross both ends of the range.
- A few substeps of the limited chain under both solvers against JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.physics import dynamics as jdyn
from mjrl_tpu.physics import solver as jsolver
from mjrl_tpu.physics.kinematics import fwd_kinematics as jax_fk
from mjrl_tpu.physics.mjcf import load_mjcf as jax_load_mjcf
from mjrl_tpu.physics.model import State as JState
from mjrl_tpu.physics.step import step_n as jax_step_n
from mjrl_tpu_torch.physics import dynamics as tdyn
from mjrl_tpu_torch.physics import solver as tsolver
from mjrl_tpu_torch.physics.kinematics import fwd_kinematics
from mjrl_tpu_torch.physics.mjcf import load_mjcf
from mjrl_tpu_torch.physics.model import State
from mjrl_tpu_torch.physics.step import step_n

from test_tendons import _LIMIT_XML, _PASSIVE_XML
from test_torch_collision3d import _gym

TOL = 1e-9
# the sprung tendon's motor moved from the tendon onto a joint
PASSIVE_XML = _PASSIVE_XML.replace(
    '<motor tendon="couple" gear="1.5"', '<motor joint="shoulder" gear="1.5"')
TABLES = ("ten_J", "ten_range", "ten_limited", "ten_solref", "ten_solimp",
          "ten_stiffness", "ten_damping", "ten_springlength",
          "ten_invweight0")

MODELS = {
    "humanoid": (lambda s: jax_load_mjcf(_gym("humanoid")).finalize(
        jnp.float64, solver=s),
        lambda s: load_mjcf(_gym("humanoid")).finalize(solver=s)),
    "passive": (lambda s: jax_load_mjcf(xml_string=PASSIVE_XML).finalize(
        jnp.float64, solver=s),
        lambda s: load_mjcf(xml_string=PASSIVE_XML).finalize(solver=s)),
    "limit": (lambda s: jax_load_mjcf(xml_string=_LIMIT_XML).finalize(
        jnp.float64, solver=s),
        lambda s: load_mjcf(xml_string=_LIMIT_XML).finalize(solver=s)),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_tendon_tables_match_jax(name):
    jm, tm = MODELS[name][0]("pgs"), MODELS[name][1]("pgs")
    assert tm.ntendon == jm.ntendon > 0
    for f in TABLES:
        np.testing.assert_allclose(getattr(tm, f), np.asarray(getattr(jm, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    if name == "passive":   # the deadband as declared
        assert tm.ten_springlength.tolist() == [[-0.1, 0.15]]


def _states(tm, n, seed, spread=1.2):
    """Random states of a chain: joint angles that push the tendon length
    past both ends of its range."""
    rng = np.random.RandomState(seed)
    q = np.tile(tm.qpos0, (n, 1))
    q = q + rng.uniform(-spread, spread, q.shape)
    v = rng.uniform(-2, 2, (n, tm.nv))
    return q, v


@pytest.mark.parametrize("name", ["passive", "limit"])
def test_lengths_forces_and_limit_qacc_match_jax(name):
    jm, tm = MODELS[name][0]("penalty"), MODELS[name][1]("penalty")
    q, v = _states(tm, 24, 1)
    tq, tv = torch.tensor(q), torch.tensor(v)
    jq, jv = jnp.asarray(q), jnp.asarray(v)
    pairs = [
        (tdyn.tendon_lengths(tm, tq),
         jax.jit(jax.vmap(lambda a: jdyn.tendon_lengths(jm, a)))(jq)),
        (tdyn.tendon_passive_force(tm, tq, tv),
         jax.jit(jax.vmap(lambda a, b: jdyn.tendon_passive_force(
             jm, a, b)))(jq, jv)),
        (tdyn.tendon_limit_qacc(tm, tq, tv),
         jax.jit(jax.vmap(lambda a, b: jdyn.tendon_limit_qacc(
             jm, a, b)))(jq, jv)),
    ]
    for k, (g, w) in enumerate(pairs):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} {k}")
    L = pairs[0][0].numpy()[:, 0]
    if name == "limit":      # both ends of the range [-0.3, 0.5] crossed
        assert (L < -0.3).any() and (L > 0.5).any()
        assert np.abs(pairs[2][1]).max() > 0
    else:                    # both sides of the deadband [-0.1, 0.15]
        assert (L < -0.1).any() and (L > 0.15).any()
        assert np.abs(pairs[1][1]).max() > 0


def test_tendon_limit_row_matches_jax():
    jm, tm = MODELS["limit"][0]("pgs"), MODELS["limit"][1]("pgs")
    q, v = _states(tm, 24, 2)

    def jrows(qq, vv):
        d = jax_fk(jm, qq)
        r = jsolver.constraint_rows(jm, d, jdyn.compute_cdof(jm, d), qq, vv)
        return r[:5]

    want = jax.jit(jax.vmap(jrows))(jnp.asarray(q), jnp.asarray(v))
    tq, tv = torch.tensor(q), torch.tensor(v)
    d = fwd_kinematics(tm, tq)
    got = tsolver.constraint_rows(tm, d, tdyn.compute_cdof(tm, d), tq, tv)
    # the tendon row is the last: after the two joints' (unlimited) rows
    assert got[0].shape[1] == tsolver.n_constraint_rows(tm) == 1
    for k in range(5):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=TOL,
                                   atol=TOL * max(np.abs(w).max(), 1.0))
    active = got[3].numpy()[:, 0]
    assert 0 < active.sum() < len(active)


@pytest.mark.parametrize("solver_", ["penalty", "pgs"])
def test_limited_chain_steps_match_jax(solver_):
    jm, tm = MODELS["limit"][0](solver_), MODELS["limit"][1](solver_)
    q, v = _states(tm, 8, 3)
    u = np.random.RandomState(4).uniform(-1, 1, (8, tm.nu))
    want = jax.jit(jax.vmap(lambda a, b, c: jax_step_n(
        jm, JState(qpos=a, qvel=b), c, 5)))(
        jnp.asarray(q), jnp.asarray(v), jnp.asarray(u))
    got = step_n(tm, State(qpos=torch.tensor(q), qvel=torch.tensor(v)),
                 torch.tensor(u), 5)
    np.testing.assert_allclose(got.qpos.numpy(), np.asarray(want.qpos),
                               rtol=TOL, atol=TOL)
    scale = np.abs(np.asarray(want.qvel)).max()
    np.testing.assert_allclose(got.qvel.numpy(), np.asarray(want.qvel),
                               rtol=TOL, atol=TOL * scale)
