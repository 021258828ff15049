"""Port vs JAX package: equality constraints (CPU, float64).

The scenes of ``tests/test_equality.py``: a quartic joint coupling and a
connect closing a loop between two chains, a single-joint pin, and welds
between two free bodies (one with its relative pose taken at qpos0, one
inactive with an explicit relpose, against the world).

- The equality tables (kind, objects, data with the compiler's qpos0
  anchors and relative quaternion, solref, solimp, active) at 1e-12.
- ``equality_terms`` (Jacobian rows, residuals, impedance positions,
  inverse weights) and the equality rows of ``constraint_rows`` (the
  bilateral prefix: lo -inf, hi +inf) at 1e-9.
- ``qacc_smooth`` under the implicit solver (the dual) and on the penalty
  path (``equality_qacc``) at 1e-9 of the largest entry; the primal
  Newton solver's bilateral rows are held in
  ``test_torch_newton_noslip.py`` (the weld).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.physics import dynamics as jdyn
from mjrl_tpu.physics import solver as jsolver
from mjrl_tpu.physics.kinematics import fwd_kinematics as jax_fk
from mjrl_tpu_torch.physics import dynamics as tdyn
from mjrl_tpu_torch.physics import solver as tsolver
from mjrl_tpu_torch.physics.kinematics import fwd_kinematics

from test_torch_mjcf_m9b import (EQ_XML, PIN_XML, TOL, WELD_XML, assert_rel,
                                 build_both, qacc_both, random_states)
from test_torch_mjcf_m9b import one_torch_thread  # noqa: F401

SCENES = {"joint_connect": EQ_XML, "pin": PIN_XML, "weld": WELD_XML}
N = 6


@pytest.mark.parametrize("scene", list(SCENES))
def test_equality_tables_match_jax(scene):
    jm, tm = build_both(SCENES[scene])
    assert tm.neq == jm.neq > 0
    assert (tm.eq_kind, tm.eq_obj1, tm.eq_obj2) == (jm.eq_kind, jm.eq_obj1,
                                                    jm.eq_obj2)
    for f in ("eq_data", "eq_solref", "eq_solimp", "eq_active"):
        np.testing.assert_allclose(getattr(tm, f), np.asarray(getattr(jm, f)),
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    assert not np.isnan(tm.eq_data).any()


@pytest.mark.parametrize("scene", list(SCENES))
def test_equality_terms_and_rows_match_jax(scene):
    jm, tm = build_both(SCENES[scene], solver="newton")
    q, v, _ = random_states(tm, N, seed=1)

    def jterms(qq, vv):
        d = jax_fk(jm, qq)
        cdof = jdyn.compute_cdof(jm, d)
        terms = [(t[1], t[2], t[3], jnp.asarray(t[4]))
                 for t in jdyn.equality_terms(jm, d, cdof, qq)]
        rows = jsolver.constraint_rows(jm, d, cdof, qq, vv)
        return terms, rows

    want_t, want_r = jax.jit(jax.vmap(jterms))(jnp.asarray(q),
                                                jnp.asarray(v))
    tq, tv = torch.tensor(q), torch.tensor(v)
    d = fwd_kinematics(tm, tq)
    cdof = tdyn.compute_cdof(tm, d)
    got_t = tdyn.equality_terms(tm, d, cdof, tq)
    assert len(got_t) == len(want_t) == tm.neq
    for (_, jr, res, imp, iw), (wj, wres, wimp, wiw) in zip(got_t, want_t):
        for g, w in ((jr, wj), (res, wres), (imp, wimp)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                       atol=TOL)
        np.testing.assert_allclose(np.broadcast_to(iw.numpy(),
                                                   np.asarray(wiw)[0].shape),
                                   np.asarray(wiw)[0], rtol=TOL)
    got_r = tsolver.constraint_rows(tm, d, cdof, tq, tv)
    n_eq = sum(t[1].shape[1] for t in got_t)
    for i in range(5):                        # J, aref_pos, b, active, R
        w = np.asarray(want_r[i])
        np.testing.assert_allclose(got_r[i].numpy(), w, rtol=TOL,
                                   atol=TOL * max(np.abs(w).max(), 1e-300))
    assert np.isneginf(got_r[5][:n_eq].numpy()).all()
    assert np.isposinf(got_r[6][:n_eq].numpy()).all()
    np.testing.assert_array_equal(got_r[5].numpy(), np.asarray(want_r[5])[0])


@pytest.mark.parametrize("scene", ["joint_connect", "weld"])
@pytest.mark.parametrize("solver", ["newton", "penalty"])
def test_equality_qacc_matches_jax(scene, solver):
    """The pin's qacc is held in test_torch_solver3d.py."""
    jm, tm = build_both(SCENES[scene], solver=solver)
    q, v, u = random_states(tm, N, seed=2)
    a, b = qacc_both(jm, tm, q, v, u)
    assert_rel(b, a, what=(scene, solver))
