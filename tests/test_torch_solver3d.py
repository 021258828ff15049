"""Port vs JAX package: the implicit solver of the general engine (CPU,
float64).

- The constraint rows (J, position part of aref, damping, activity,
  regularizer, bounds) against the JAX package's ``constraint_rows`` at
  1e-12: the reacher's seven limit rows and its fingertip-table contact
  row, a ball joint's rotation-angle row, dry-friction rows and a limit
  margin.
- The constrained qacc (``qacc_smooth`` under ``solver="pgs"``: a cold
  APGD solve of ``SWEEPS`` sweeps) on ``reacher_limits.npz`` and
  ``ball_limits.npz`` against the JAX package's at equal sweeps, 1e-8
  relative to the largest entry; no adaptive-restart decision flips at
  roundoff on these states, so the equal-sweep comparison holds.
- Against MuJoCo's qacc on the limit-active golden states with the JAX
  tests' medians (``test_solver.py:55-56``: median < 0.05 and < 0.3 x the
  penalty path's; ``test_ball.py:140-141``: < 0.15 and < 0.3 x).
- The features the solver left to M9b (the elliptic cone, noslip,
  equality rows, the primal Newton solver) against the JAX package.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.envs import assets as jassets
from mjrl_tpu.physics import dynamics as jdyn
from mjrl_tpu.physics import solver as jsolver
from mjrl_tpu.physics.kinematics import fwd_kinematics as jax_fk
from mjrl_tpu.physics.mjcf import load_mjcf as jax_load_mjcf
from mjrl_tpu.physics.model import State as JState
from mjrl_tpu.physics.step import qacc_smooth as jax_qacc_smooth
from mjrl_tpu_torch.envs import assets as tassets
from mjrl_tpu_torch.physics import dynamics as dyn
from mjrl_tpu_torch.physics import solver
from mjrl_tpu_torch.physics.kinematics import fwd_kinematics
from mjrl_tpu_torch.physics.mjcf import load_mjcf
from mjrl_tpu_torch.physics.model import ModelBuilder, State
from mjrl_tpu_torch.physics.step import qacc_smooth

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
REL = 1e-8


def _golden(name):
    return np.load(os.path.join(GOLDEN, f"{name}.npz"), allow_pickle=True)


def _ball_limits_xml(extra=False):
    xml = str(_golden("ball_limits")["xml"])
    if extra:       # dry friction on both joints, a margin on the hinge
        xml = xml.replace('damping="0.05"',
                          'damping="0.05" frictionloss="0.03"')
        xml = xml.replace('range="-60 60"',
                          'range="-60 60" margin="0.05" frictionloss="0.02"')
    return xml


def _reacher_states():
    g = _golden("reacher_limits")
    idx = np.where((g["nefc"] > 0) & (g["ncon"] == 0))[0][:10]
    return g, idx


MODELS = {
    "reacher": (lambda s: jassets.reacher_model().finalize(jnp.float64,
                                                           solver=s),
                lambda s: tassets.reacher_model(solver=s)),
    "ball_limits": (
        lambda s: jax_load_mjcf(xml_string=_ball_limits_xml()).finalize(
            jnp.float64, solver=s),
        lambda s: load_mjcf(xml_string=_ball_limits_xml()).finalize(
            solver=s)),
    "friction_margin": (
        lambda s: jax_load_mjcf(xml_string=_ball_limits_xml(True)).finalize(
            jnp.float64, solver=s),
        lambda s: load_mjcf(xml_string=_ball_limits_xml(True)).finalize(
            solver=s)),
}


def _states(name):
    if name == "reacher":
        g, idx = _reacher_states()
        rng = np.random.RandomState(2)
        q = np.concatenate([g["qpos"][idx], rng.uniform(-2.4, 1.8, (6, 7))])
        v = np.concatenate([g["qvel"][idx], rng.uniform(-2, 2, (6, 7))])
        u = np.concatenate([g["ctrl"][idx], rng.uniform(-1, 1, (6, 7))])
        return q, v, u
    g = _golden("ball_limits")
    return g["qpos"], g["qvel"], np.zeros((len(g["qpos"]), 0))


@pytest.fixture(scope="module", params=list(MODELS))
def solved(request):
    jbuild, tbuild = MODELS[request.param]
    jm, tm = jbuild("pgs"), tbuild("pgs")
    q, v, u = _states(request.param)

    def jrows(qq, vv):
        d = jax_fk(jm, qq)
        return jsolver.constraint_rows(jm, d, jdyn.compute_cdof(jm, d), qq,
                                       vv)[:7]

    def jacc(qq, vv, uu):
        return jax_qacc_smooth(jm, JState(qpos=qq, qvel=vv), uu)

    jq, jv, ju = (jnp.asarray(a) for a in (q, v, u))
    want_rows = jax.jit(jax.vmap(jrows))(jq, jv)
    want_acc = jax.jit(jax.vmap(jacc))(jq, jv, ju)
    tq, tv, tu = (torch.tensor(a) for a in (q, v, u))
    d = fwd_kinematics(tm, tq)
    got_rows = solver.constraint_rows(tm, d, dyn.compute_cdof(tm, d), tq, tv)
    got_acc = qacc_smooth(tm, State(qpos=tq, qvel=tv), tu)
    return request.param, want_rows, got_rows, want_acc, got_acc


ROWS = ("J", "aref_pos", "b_row", "active", "R", "lo", "hi")


@pytest.mark.parametrize("part", ROWS)
def test_constraint_rows_match_jax(solved, part):
    name, want, got, _, _ = solved
    i = ROWS.index(part)
    w, g = np.asarray(want[i]), got[i].numpy()
    if part in ("lo", "hi"):
        w = w[0]                     # per-row constants in the port
    assert g.shape == w.shape, (name, part)
    np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12,
                               err_msg=f"{name} {part}")


def test_rows_are_active(solved):
    """Limits (and the margin) act on the compared states."""
    name, _, got, _, _ = solved
    assert float(got[3].sum()) > 0, name


def test_constrained_qacc_matches_jax(solved):
    name, _, _, want, got = solved
    w = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), w, rtol=REL,
                               atol=REL * np.abs(w).max(), err_msg=name)


def _mujoco_errors(tm_pen, tm_pgs, q, v, u, qacc_ref):
    scale = np.maximum(np.abs(qacc_ref).max(axis=-1), 1.0)
    tq, tv, tu = (torch.tensor(a) for a in (q, v, u))
    errs = []
    for m in (tm_pen, tm_pgs):
        a = qacc_smooth(m, State(qpos=tq, qvel=tv), tu).numpy()
        errs.append(np.abs(a - qacc_ref).max(axis=-1) / scale)
    return errs


def test_reacher_pgs_matches_mujoco_on_limit_active_states():
    g, idx = _reacher_states()
    err_pen, err_pgs = _mujoco_errors(
        tassets.reacher_model(solver="penalty"),
        tassets.reacher_model(solver="pgs"), g["qpos"][idx], g["qvel"][idx],
        g["ctrl"][idx], g["qacc"][idx])
    assert np.median(err_pgs) < 0.05, (err_pgs, err_pen)
    assert np.median(err_pgs) < 0.3 * np.median(err_pen)


def test_ball_limit_pgs_matches_mujoco():
    g = _golden("ball_limits")
    b = lambda s: load_mjcf(xml_string=str(g["xml"])).finalize(solver=s)
    idx = np.where(g["nefc"] > 0)[0]
    assert len(idx) >= 5
    err_pen, err_pgs = _mujoco_errors(
        b("penalty"), b("pgs"), g["qpos"][idx], g["qvel"][idx],
        np.zeros((len(idx), 0)), g["qacc"][idx])
    assert np.median(err_pgs) < 0.15, err_pgs
    assert np.median(err_pgs) < 0.3 * np.median(err_pen)
    free = np.where(g["nefc"] == 0)[0][:3]
    a = qacc_smooth(b("pgs"), State(qpos=torch.tensor(g["qpos"][free]),
                                    qvel=torch.tensor(g["qvel"][free])),
                    torch.zeros((len(free), 0), dtype=torch.float64))
    np.testing.assert_allclose(a.numpy(), g["qacc"][free], atol=1e-9)


def _pendulum(**opt):
    b = ModelBuilder(**opt)
    body = b.add_body(0, pos=(0, 0, 1))
    b.add_joint(body, "hinge", axis=(0, 1, 0), jnt_range=(-1, 1))
    b.add_geom(body, "sphere", size=(0.1,), pos=(0.3, 0, 0))
    return b


def _jax_pendulum(**opt):
    from mjrl_tpu.physics.model import ModelBuilder as JaxBuilder
    b = JaxBuilder(**opt)
    body = b.add_body(0, pos=(0, 0, 1))
    b.add_joint(body, "hinge", axis=(0, 1, 0), jnt_range=(-1, 1))
    b.add_geom(body, "sphere", size=(0.1,), pos=(0.3, 0, 0))
    return b


def _pinned(b):
    b.add_equality_joint(0, polycoef=(0.2, 1, 0, 0, 0))
    return b


@pytest.mark.parametrize("opt, edit, finalize", [
    ({"cone": "elliptic"}, None, {}),
    ({"noslip_iterations": 5}, None, {}),
    ({}, _pinned, {}),
    ({}, None, {"newton_iters": 5}),
], ids=["elliptic", "noslip", "equality", "newton_iters"])
def test_former_m9b_solver_features_match_jax(opt, edit, finalize):
    """What the solver left to M9b (the elliptic cone, noslip, equality
    rows, the primal Newton solver) now runs: the pendulum near and past
    its limits (the pinned one inside them) against the JAX package, qacc
    at 1e-9 of the largest entry.

    The pin is kept off the limits: with a pin row and a limit row both
    active on the one dof in opposite senses, the active mask that starts
    the dual's power iteration is the null direction of J M^-1 J^T, the
    step size comes out far too large, and both packages' APGD diverge
    (1.88e85 at q = 1.02)."""
    pinned = edit is _pinned
    edit = edit or (lambda b: b)
    jm = edit(_jax_pendulum(**opt)).finalize(jnp.float64, solver="pgs",
                                            **finalize)
    tm = edit(_pendulum(**opt)).finalize(solver="pgs", **finalize)
    q = np.array([[0.95], [1.02], [-1.01], [0.3]])
    if pinned:
        q = np.array([[0.8], [0.5], [-0.6], [0.3]])
    v = np.array([[0.5], [1.0], [-2.0], [0.1]])
    acc = jax.jit(jax.vmap(lambda qq, vv: jax_qacc_smooth(
        jm, JState(qpos=qq, qvel=vv), jnp.zeros(0))))
    want = np.asarray(acc(jnp.asarray(q), jnp.asarray(v)))
    got = qacc_smooth(tm, State(qpos=torch.tensor(q), qvel=torch.tensor(v)),
                      torch.zeros((4, 0), dtype=torch.float64)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())
