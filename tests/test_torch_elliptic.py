"""Port vs JAX package: the elliptic friction cone through the general
engine (CPU, float64).

Hopper-v3's model with <option cone="elliptic">, stepped by the general
engine (``physics/step.py``, not the planar kernel's plain version): each
condim-3 contact gives 3 rows [n, t1, t2] (blocks of K rows), the dual's
projection puts each triple on the cone mu lam_n >= |lam_t| with the
tangent pair sharing one scale, and the solve takes 4 x the sweeps.

- The rows on 3 golden contact states: J, aref, R, the triples' -inf lower
  bound and ``soc_mu`` against the JAX package's at 1e-9.
- ``qacc_smooth`` on the same states at 1e-9 of the largest entry.
- One control step (4 substeps: the cold solve, then warm starts) of
  ``step_n`` at 1e-9.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mjrl_tpu.envs.gym_suite import _gym_asset as jax_gym_asset
from mjrl_tpu.physics import dynamics as jdyn
from mjrl_tpu.physics import solver as jsolver
from mjrl_tpu.physics.kinematics import fwd_kinematics as jax_fk
from mjrl_tpu.physics.mjcf import load_mjcf as jax_load_mjcf
from mjrl_tpu.physics.model import ELLIPTIC
from mjrl_tpu.physics.model import State as JState
from mjrl_tpu.physics.step import step_n as jax_step_n
from mjrl_tpu_torch.envs.gym_suite import _gym_asset
from mjrl_tpu_torch.physics import dynamics as tdyn
from mjrl_tpu_torch.physics import solver as tsolver
from mjrl_tpu_torch.physics.kinematics import fwd_kinematics
from mjrl_tpu_torch.physics.mjcf import load_mjcf
from mjrl_tpu_torch.physics.model import State
from mjrl_tpu_torch.physics.step import step_n

from test_torch_mjcf_m9b import TOL, assert_rel, qacc_both
from test_torch_mjcf_m9b import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
B = 3


def _models():
    jb = jax_load_mjcf(jax_gym_asset("hopper.xml"))
    jb.opt["cone"] = ELLIPTIC
    tb = load_mjcf(_gym_asset("hopper.xml"))
    tb.opt["cone"] = ELLIPTIC
    return (jb.finalize(jnp.float64, solver="newton"),
            tb.finalize(solver="newton"))


def _states():
    g = np.load(os.path.join(GOLDEN, "contact_hopper.npz"))
    idx = np.flatnonzero(g["ncon"] > 0)[:B]
    return g["qpos"][idx], g["qvel"][idx], g["ctrl"][idx]


def test_elliptic_rows_match_jax():
    jm, tm = _models()
    q, v, _ = _states()

    def jrows(qq, vv):
        d = jax_fk(jm, qq)
        return jsolver.constraint_rows(jm, d, jdyn.compute_cdof(jm, d), qq,
                                       vv)

    want = jax.jit(jax.vmap(jrows))(jnp.asarray(q), jnp.asarray(v))
    tq, tv = torch.tensor(q), torch.tensor(v)
    d = fwd_kinematics(tm, tq)
    got = tsolver.constraint_rows(tm, d, tdyn.compute_cdof(tm, d), tq, tv)
    st, K = tsolver._soc_layout(tm)
    assert (st, K) == jsolver._soc_layout(jm) and K > 0
    assert got[0].shape[1] == tsolver.n_constraint_rows(tm) \
        == jsolver.n_constraint_rows(jm) == st + 3 * K
    for i in (0, 1, 2, 4):                    # J, aref_pos, b_row, R
        w = np.asarray(want[i])
        np.testing.assert_allclose(got[i].numpy(), w, rtol=TOL,
                                   atol=TOL * np.abs(w).max())
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for i in (5, 6):                          # lo, hi
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i])[0])
    assert np.isneginf(got[5][st:].numpy()).all()
    np.testing.assert_allclose(got[8].numpy(), np.asarray(want[7]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got[7].numpy(), np.asarray(want[8]))


def test_elliptic_qacc_matches_jax():
    jm, tm = _models()
    q, v, u = _states()
    a, b = qacc_both(jm, tm, q, v, u)
    assert_rel(b, a, what="elliptic qacc")


def test_elliptic_control_step_matches_jax():
    jm, tm = _models()
    q, v, u = _states()
    step = jax.jit(jax.vmap(lambda qq, vv, uu: jax_step_n(
        jm, JState(qpos=qq, qvel=vv), uu, 4)))
    want = step(jnp.asarray(q), jnp.asarray(v), jnp.asarray(u))
    got = step_n(tm, State(qpos=torch.tensor(q), qvel=torch.tensor(v)),
                 torch.tensor(u), 4)
    np.testing.assert_allclose(got.qpos.numpy(), np.asarray(want.qpos),
                               rtol=TOL, atol=TOL)
    assert_rel(got.qvel.numpy(), np.asarray(want.qvel), what="qvel")
