"""Port vs JAX package: the primal Newton solver and the noslip pass (CPU,
float64).

- ``solve_qacc_newton`` on the assembled rows of small scenes (a sphere on
  a 15-degree incline with a rolling hinge, the condim-4 spinning sphere,
  a two-body slider with dry-friction (boxed) rows, the weld's bilateral
  rows) against the JAX package's at 1e-9: qacc and the impulses it
  returns in the warm format.
- ``noslip_qacc`` on the same rows from the Newton impulses at 1e-9.
- The ``_noslip_layout`` arrays (the + and - facet rows of every friction
  direction, the dry-friction rows) and the contact counts against the
  JAX package's on scenes with condim 1, 3, 4 and 6 classes, dry friction,
  equalities and a contact_topk cap.
- Newton agrees with the dual APGD on the incline's contact states
  (``tests/test_solver_extras.py:158``: 5e-4 of the largest entry).
- The Hessian solve at Adroit's nv 36 (``cholesky_ex`` past
  ``MAX_UNROLL``) against the JAX package's ``spd_solve`` at 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.physics import solver as jsolver
from mjrl_tpu.physics.model import State as JState
from mjrl_tpu.physics.step import _forces_and_mass as jax_forces
from mjrl_tpu_torch.physics import solver as tsolver
from mjrl_tpu_torch.physics.model import State
from mjrl_tpu_torch.physics.step import _forces_and_mass, qacc_smooth

from test_torch_mjcf_m9b import (CONDIM_XML, EQ_XML, HINGE, INCLINE,
                                 PAIR_XML, TOL, WELD_XML, assert_rel,
                                 build_both, random_states)
from test_torch_mjcf_m9b import one_torch_thread  # noqa: F401

SLIDER = """
<mujoco><option timestep="0.002" gravity="0 0 -9.81"/>
<worldbody>
  <body pos="0 0 0.5">
    <joint name="s" type="slide" axis="1 0 0" frictionloss="2"/>
    <geom type="box" size="0.1 0.1 0.1" mass="1"/>
  </body>
  <body pos="0 0 1.0">
    <joint type="slide" axis="1 0 0" frictionloss="2"/>
    <joint type="slide" axis="0 0 1"/>
    <geom type="box" size="0.1 0.1 0.1" mass="1"/>
  </body>
</worldbody></mujoco>"""


def _incline_states(n, seed):
    rng = np.random.default_rng(seed)
    q = np.stack([[0.0, 0.0, rng.uniform(-0.072, -0.068), rng.normal()]
                  for _ in range(n)])
    return q, rng.normal(0, 0.5, (n, 4))


def _scene_states(name, tm):
    if name == "incline":
        return _incline_states(4, 3)
    if name == "condim4":
        q = np.zeros((4, 6))
        q[:, 2] = [-0.001, -0.0015, 0.0002, -0.0005]
        v = np.random.RandomState(4).normal(0, 1, (4, 6))
        v[:, 5] = [8.0, -5.0, 3.0, -1.0]
        return q, v
    q, v, _ = random_states(tm, 4, seed=5)
    return q, v


SCENES = {"incline": INCLINE.format(ns=20, hinge=HINGE),
          "condim4": CONDIM_XML.format(condim=4).replace(
              "<option", '<option noslip_iterations="10"'),
          "slider": SLIDER.replace("<option", '<option noslip_iterations="5"'),
          "weld": WELD_XML}


def _rows_both(name):
    """The rows, smooth acceleration and mass matrix of 4 states in both
    packages -> (jm, tm, JAX (m, a0, j, aref, active, r, lo, hi), port
    tuple)."""
    jm, tm = build_both(SCENES[name], solver="newton", newton_iters=25)
    q, v = _scene_states(name, tm)
    u = np.zeros((len(q), tm.nu))

    def jparts(qq, vv, uu):
        s = JState(qpos=qq, qvel=vv)
        m, qfrc, bias, _, (d, cdof, _) = jax_forces(jm, s, uu)
        a0 = jnp.linalg.solve(m, qfrc - bias)
        j, aref_pos, b_row, active, r, lo, hi, _, _ = \
            jsolver.constraint_rows(jm, d, cdof, qq, vv)
        return m, a0, j, aref_pos - b_row * (j @ vv), active, r, lo, hi

    want = jax.jit(jax.vmap(jparts))(jnp.asarray(q), jnp.asarray(v),
                                     jnp.asarray(u))
    want = [np.asarray(w) for w in want]
    tq, tv = torch.tensor(q), torch.tensor(v)
    s = State(qpos=tq, qvel=tv)
    m, qfrc, bias, _, (d, cdof) = _forces_and_mass(tm, s, torch.tensor(u))
    j, aref_pos, b_row, active, r, lo, hi, _, _ = tsolver.constraint_rows(
        tm, d, cdof, tq, tv)
    aref = aref_pos - b_row * tsolver._matvec(j, tv)
    # the same smooth acceleration on both sides (the JAX package's)
    got = (m, torch.tensor(want[1]), j, aref, active, r, lo, hi)
    for g, w in zip(got[2:6], want[2:6]):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL,
                                   atol=TOL * max(np.abs(w).max(), 1.0))
    return jm, tm, want, got


def _newton_both(jm, want, got):
    jn = jax.jit(jax.vmap(lambda m, a0, j, aref, act, r, lo, hi:
                          jsolver.solve_qacc_newton(m, a0, j, aref, act, r,
                                                    lo, hi, iters=25)))
    ja, jl = jn(*[jnp.asarray(w) for w in want])
    ta, tl = tsolver.solve_qacc_newton(*got, iters=25)
    return np.asarray(ja), np.asarray(jl), ta, tl


@pytest.mark.parametrize("name", list(SCENES))
def test_newton_and_noslip_match_jax(name):
    jm, tm, want, got = _rows_both(name)
    ja, jl, ta, tl = _newton_both(jm, want, got)
    assert_rel(ta.numpy(), ja, what=(name, "newton qacc"))
    assert_rel(tl.numpy(), jl, what=(name, "newton lam"))
    if not tm.noslip_iters:
        return
    m, _, j, aref, _, _, lo, hi = got
    jns = jax.jit(jax.vmap(lambda m_, j_, aref_, lam, qacc:
                           jsolver.noslip_qacc(jm, m_, j_, aref_, lam,
                                               jnp.asarray(want[6][0]),
                                               jnp.asarray(want[7][0]),
                                               qacc)))
    want_ns = np.asarray(jns(jnp.asarray(want[0]), jnp.asarray(want[2]),
                             jnp.asarray(want[3]), jnp.asarray(jl),
                             jnp.asarray(ja)))
    got_ns = tsolver.noslip_qacc(tm, m, j, aref, torch.tensor(jl), lo, hi,
                                 torch.tensor(ja))
    assert_rel(got_ns.numpy(), want_ns, what=(name, "noslip"))
    if name != "slider":        # the sliding boxes' friction is saturated
        assert np.abs(want_ns - ja).max() > 1e-6, name   # the pass acts


LAYOUT_SCENES = {
    "condim4": CONDIM_XML.format(condim=4),
    "condim6": CONDIM_XML.format(condim=6),
    "pairs": PAIR_XML.format(cone="pyramidal", ns=3),
    "slider": SLIDER,
    "loop": EQ_XML,
}


@pytest.mark.parametrize("name", list(LAYOUT_SCENES))
def test_noslip_layout_matches_jax(name):
    jm, tm = build_both(LAYOUT_SCENES[name], solver="newton")
    for a, b in zip(tsolver._noslip_layout(tm), jsolver._noslip_layout(jm)):
        np.testing.assert_array_equal(a, b)
    assert tsolver._contact_counts(tm) == jsolver._contact_counts(jm)
    assert tsolver.n_constraint_rows(tm) == jsolver.n_constraint_rows(jm)


def test_noslip_layout_with_topk_cap_matches_jax():
    """A capped condim-4 class: 5 spheres on a plane, the cap at 2."""
    bodies = "".join(
        f'<body pos="{0.3 * i} 0 0.1"><joint type="slide" axis="0 0 1"/>'
        f'<geom type="sphere" size="0.1" condim="{4 if i % 2 else 3}"/>'
        '</body>' for i in range(5))
    xml = (f'<mujoco><worldbody><geom type="plane" size="3 3 0.1"/>{bodies}'
           '</worldbody></mujoco>')
    jm, tm = build_both(xml, solver="newton", contact_topk=2)
    for a, b in zip(tsolver._noslip_layout(tm), jsolver._noslip_layout(jm)):
        np.testing.assert_array_equal(a, b)
    assert tsolver._contact_counts(tm) == jsolver._contact_counts(jm) \
        == {1: 0, 3: 2, 4: 2, 6: 0}


def test_newton_agrees_with_apgd():
    """Both minimize the same QP: equal qacc on the incline's contact
    states within the JAX test's 5e-4."""
    xml = INCLINE.format(ns=0, hinge=HINGE)
    _, m_apgd = build_both(xml, solver="newton")
    _, m_newt = build_both(xml, solver="newton", newton_iters=30)
    q, v = _incline_states(5, 3)
    s = State(qpos=torch.tensor(q), qvel=torch.tensor(v))
    u = torch.zeros((5, 0), dtype=torch.float64)
    a1 = qacc_smooth(m_apgd, s, u).numpy()
    a2 = qacc_smooth(m_newt, s, u).numpy()
    assert_rel(a2, a1, tol=5e-4, what="newton vs apgd")


def test_spd_solve_past_max_unroll_matches_jax():
    """Newton's Hessian solve at Adroit's nv 36 takes ``cholesky_ex``
    (past ``MAX_UNROLL``), the JAX package its native Cholesky: equal at
    1e-9 on batched SPD systems of the Hessian's conditioning."""
    from mjrl_tpu.ops.linalg import spd_solve as jax_spd_solve
    from mjrl_tpu_torch.ops.linalg import MAX_UNROLL, spd_solve
    n = 36
    assert n > MAX_UNROLL
    rng = np.random.RandomState(7)
    a = rng.normal(size=(4, n, n))
    h = a @ a.transpose(0, 2, 1) + 1e-3 * np.eye(n)
    g = rng.normal(size=(4, n))
    want = np.asarray(jax.vmap(jax_spd_solve)(jnp.asarray(h),
                                              jnp.asarray(g)))
    got = spd_solve(torch.tensor(h), torch.tensor(g)).numpy()
    assert_rel(got, want, what="spd_solve nv 36")
