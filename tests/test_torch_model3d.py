"""Port vs JAX package: host-side model building for the models of the
general engine (point mass, 7-DoF reacher, InvertedPendulum, peg
insertion, Ant, Humanoid with its fixed tendons and contact_topk cap, and
the ``ball`` / ``freebody`` golden XMLs with their ball and free joints).

Every table that ``finalize`` produces is held to the JAX Model's field by
field: float64 at 1e-12, the inverse-weight tables at 1e-9 (the port takes
them from its own float64 composite-rigid-body evaluation, the JAX package
from its engine).  The float32 models are rounded as the JAX package's
float32 models: every field equal bit for bit, except the inverse weights,
which the JAX package evaluates in float32 (held at 3e-5 relative).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest

from mjrl_tpu.envs import assets as jassets
from mjrl_tpu.envs.gym_suite import _gym_asset as jax_gym_asset
from mjrl_tpu.physics.mjcf import load_mjcf as jax_load_mjcf
from mjrl_tpu_torch.envs import assets as tassets
from mjrl_tpu_torch.envs.gym_suite import _gym_asset
from mjrl_tpu_torch.physics import model as tmodel
from mjrl_tpu_torch.physics.mjcf import load_mjcf

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
INVW = ("dof_invweight0", "body_invweight0", "ten_invweight0")
FIELDS = [f.name for f in dataclasses.fields(tmodel.Model)]


def _golden_xml(name):
    return str(np.load(os.path.join(GOLDEN, f"{name}.npz"),
                       allow_pickle=True)["xml"])


BUILDERS = {
    "point_mass": (jassets.point_mass_model, tassets.point_mass_model,
                   "penalty"),
    "reacher": (jassets.reacher_model, tassets.reacher_model, "pgs"),
    "inverted_pendulum": (
        lambda: jax_load_mjcf(jax_gym_asset("inverted_pendulum.xml")),
        lambda: load_mjcf(_gym_asset("inverted_pendulum.xml")), "penalty"),
    "ball": (lambda: jax_load_mjcf(xml_string=_golden_xml("ball")),
             lambda: load_mjcf(xml_string=_golden_xml("ball")), "penalty"),
    "freebody": (lambda: jax_load_mjcf(xml_string=_golden_xml("freebody")),
                 lambda: load_mjcf(xml_string=_golden_xml("freebody")),
                 "penalty"),
    "peg_insertion": (jassets.peg_insertion_model,
                      tassets.peg_insertion_model, "pgs"),
    "ant": (lambda: jax_load_mjcf(jax_gym_asset("ant.xml")),
            lambda: load_mjcf(_gym_asset("ant.xml")), "newton"),
    "humanoid": (lambda: jax_load_mjcf(jax_gym_asset("humanoid.xml")),
                 lambda: load_mjcf(_gym_asset("humanoid.xml")), "newton"),
}


@pytest.fixture(scope="module", params=list(BUILDERS))
def models(request):
    jb, tb, solver = BUILDERS[request.param]
    out = {}
    for jd, nd in ((jnp.float64, np.float64), (jnp.float32, np.float32)):
        out[nd] = (jb().finalize(jd, solver=solver),
                   tb().finalize(solver=solver, dtype=nd))
    return request.param, out


def _as_list(x):
    return np.asarray(x, np.float64).ravel().tolist()


def test_float64_tables_match_jax(models):
    name, out = models
    jm, tm = out[np.float64]
    for f in FIELDS:
        a, b = getattr(jm, f), getattr(tm, f)
        if isinstance(b, np.ndarray):
            tol = 1e-9 if f in INVW else 1e-12
            np.testing.assert_allclose(b, np.asarray(a, np.float64),
                                       rtol=tol, atol=tol,
                                       err_msg=f"{name} {f}")
        else:
            assert a == b, (name, f, a, b)


def test_float32_tables_match_jax_bit_for_bit(models):
    name, out = models
    jm, tm = out[np.float32]
    for f in FIELDS:
        b = getattr(tm, f)
        if not isinstance(b, np.ndarray):
            continue
        a = np.asarray(getattr(jm, f))
        assert a.dtype == np.float32, (name, f)
        if f in INVW:
            np.testing.assert_allclose(b, a, rtol=3e-5, atol=1e-30,
                                       err_msg=f"{name} {f}")
            assert _as_list(b.astype(np.float32)) == _as_list(b)
        else:
            assert _as_list(a) == _as_list(b), (name, f)


def test_joint_addressing(models):
    """qpos/dof addresses, including the 4- and 7-wide ball/free joints
    where nq != nv."""
    name, out = models
    jm, tm = out[np.float64]
    assert (tm.nq, tm.nv) == (jm.nq, jm.nv)
    assert tm.jnt_qposadr == jm.jnt_qposadr
    assert tm.jnt_dofadr == jm.jnt_dofadr
    assert tm.dof_qpos_idx == jm.dof_qpos_idx
    if name == "ball":
        assert (tm.nq, tm.nv) == (9, 7)
    if name == "freebody":
        assert (tm.nq, tm.nv) == (7, 6)
        np.testing.assert_allclose(tm.qpos0[3:],
                                   np.asarray(jm.qpos0)[3:], atol=1e-15)


@pytest.mark.parametrize("make, match", [
    (lambda b: b.add_joint(b.add_body(b.add_body(0)), "free"),
     "direct child of the world"),
    (lambda b: b.add_joint(b.add_body(0), "ball", jnt_range=(0.1, 1.0)),
     "ball joint range"),
], ids=["free-not-root", "ball-range"])
def test_joint_declarations_refused_as_jax(make, match):
    with pytest.raises(ValueError, match=match):
        make(tmodel.ModelBuilder())


@pytest.mark.parametrize("jnt", ["ball", "free"])
def test_motor_on_ball_or_free_joint_matches_jax(jnt):
    """An affine motor with a vector gear on a ball or free joint: every
    table as the JAX package's (float64 at 1e-12, the inverse weights at
    1e-9)."""
    from mjrl_tpu.physics.model import ModelBuilder as JaxBuilder
    builders = []
    for b in (JaxBuilder(), tmodel.ModelBuilder()):
        body = b.add_body(0, pos=(0, 0, 1))
        b.add_geom(body, "capsule", fromto=(0, 0, 0, 0, 0, -0.3),
                   size=(0.04,))
        j = b.add_joint(body, jnt)
        b.add_actuator(j, gear=(0.5, -1.0, 2.0, 0.1, 0.2, 0.3)[
            :3 if jnt == "ball" else 6], gain=3.0, bias=(0.1, -2.0, -0.5))
        builders.append(b)
    jm, tm = builders[0].finalize(jnp.float64), builders[1].finalize()
    _assert_models_equal(jm, tm, jnt)


def _assert_models_equal(jm, tm, name):
    for f in FIELDS:
        a, b = getattr(jm, f), getattr(tm, f)
        if isinstance(b, np.ndarray):
            tol = 1e-9 if f in INVW else 1e-12
            np.testing.assert_allclose(b, np.asarray(a, np.float64),
                                       rtol=tol, atol=tol,
                                       err_msg=f"{name} {f}")
        else:
            assert a == b, (name, f, a, b)


def test_newton_iterations_match_jax():
    """finalize(newton_iters=...) sets the primal Newton solver as the JAX
    package's does; every other table unchanged."""
    jm = jassets.point_mass_model().finalize(jnp.float64, solver="pgs",
                                             newton_iters=5)
    tm = tassets.point_mass_model().finalize(solver="pgs", newton_iters=5)
    assert tm.newton_iters == jm.newton_iters == 5
    _assert_models_equal(jm, tm, "point_mass newton")
