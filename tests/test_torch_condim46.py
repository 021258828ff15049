"""Port vs JAX package: torsional and rolling friction, condim 4 and 6
(CPU, float64).

A sphere on a plane spinning about the contact normal (the scene of
``tests/test_condim4.py``): condim 4 gives 6 pyramidal facet rows (the
slide pairs t1+-, t2+- and a torsional pair about the normal, mu =
friction[1]), condim 6 gives 10 (plus rolling pairs about t1 and t2, mu =
friction[2]); the frictions combine by elementwise max over the geom pair
and every facet shares the slide regularizer.

- ``constraint_rows`` against the JAX package's at 1e-9: J, aref, b, R,
  activity, bounds and slot ids, with the row counts 6 and 10.
- ``qacc_smooth`` of ten spinning states against the JAX package's at 1e-9
  of the largest entry, under the dual (APGD).
- Torsion resists spin: at condim 4 the spin decelerates by more than 50
  rad/s^2, at condim 3 it does not (the JAX test's bounds).
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
from mjrl_tpu_torch.physics.model import State
from mjrl_tpu_torch.physics.step import qacc_smooth

from test_torch_mjcf_m9b import (CONDIM_XML, TOL, assert_rel, build_both,
                                 qacc_both)
from test_torch_mjcf_m9b import one_torch_thread  # noqa: F401

ROWS = ("J", "aref_pos", "b_row", "active", "R", "lo", "hi", "slot_ids")


def _states(n=10, seed=0):
    """The JAX test's spinning states: slight penetration, spin about the
    normal U(-8, 8)."""
    rng = np.random.default_rng(seed)
    q, v = np.zeros((n, 6)), np.zeros((n, 6))
    for i in range(n):
        q[i, 2] = rng.uniform(-0.002, 0.0005)
        v[i] = rng.normal(0, 1, 6)
        v[i, 5] = rng.uniform(-8, 8)
    return q, v


@pytest.mark.parametrize("condim,n_rows", [(4, 6), (6, 10)])
def test_condim_rows_match_jax(condim, n_rows):
    jm, tm = build_both(CONDIM_XML.format(condim=condim), solver="newton")
    assert jsolver.n_constraint_rows(jm) == n_rows \
        == tsolver.n_constraint_rows(tm)
    q, v = _states()

    def jrows(qq, vv):
        d = jax_fk(jm, qq)
        r = jsolver.constraint_rows(jm, d, jdyn.compute_cdof(jm, d), qq, vv)
        return r[:7] + (r[8],)

    want = jax.jit(jax.vmap(jrows))(jnp.asarray(q), jnp.asarray(v))
    tq, tv = torch.tensor(q), torch.tensor(v)
    d = fwd_kinematics(tm, tq)
    got = tsolver.constraint_rows(tm, d, tdyn.compute_cdof(tm, d), tq, tv)
    assert got[8].shape == (10, 0)                     # no elliptic cone
    for i, part in enumerate(ROWS):
        w, g = np.asarray(want[i]), got[i].numpy()
        if part in ("lo", "hi"):
            w = w[0]
        assert g.shape == w.shape, part
        if part in ("active", "slot_ids"):
            assert np.array_equal(g, w), part
            continue
        scale = max(np.abs(w[np.isfinite(w)]).max(initial=0.0), 1e-300)
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * scale,
                                   err_msg=part)
    # the torsional pair is J_n +- mu_t (the normal's angular Jacobian)
    j = got[0].numpy()
    tors = 0.5 * (j[:, 4] - j[:, 5]) / 0.01
    np.testing.assert_allclose(tors[:, 3:], np.tile([0, 0, 1.0], (10, 1)),
                               atol=1e-12)


@pytest.mark.parametrize("condim", [4, 6])
def test_condim_qacc_matches_jax(condim):
    """Under the dual; the primal Newton solver on the condim-4 rows is
    held in test_torch_newton_noslip.py."""
    jm, tm = build_both(CONDIM_XML.format(condim=condim), solver="newton")
    q, v = _states()
    a, b = qacc_both(jm, tm, q, v)
    assert_rel(b, a, what=condim)
    assert np.abs(a).max() > 100.0           # the contact is load-bearing


def test_condim4_torsion_resists_spin():
    q = np.zeros((1, 6))
    q[0, 2] = -0.001
    v = np.zeros((1, 6))
    v[0, 5] = 8.0
    out = {}
    for cd in (3, 4):
        _, tm = build_both(CONDIM_XML.format(condim=cd), solver="newton")
        out[cd] = qacc_smooth(tm, State(qpos=torch.tensor(q),
                                        qvel=torch.tensor(v)),
                              torch.zeros((1, 0), dtype=torch.float64))
    assert float(out[4][0, 5]) < -50.0       # strong torsional braking
    assert abs(float(out[3][0, 5])) < 1.0    # no torsion rows at condim 3
