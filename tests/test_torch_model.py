"""Port vs JAX package: host-side model building for the swimmer.

The numpy ``Model`` of ``mjrl_tpu_torch.physics.model`` and the
``PlanarParams`` extracted from it are held, field by field, to the JAX
package's (float64).  Tolerances: 1e-12 on fields that are copied or
computed by the same numpy code, 1e-9 on the inverse-weight tables, which
the port computes with its own composite-rigid-body evaluation instead of
the JAX package's general 3D engine.

The float32 Swimmer env's ``PlanarParams`` are held to the JAX package's
float32 model bit for bit, except ``invweight0``: the JAX package takes
M(qpos0) from its float32 engine, the port from a float64 evaluation of the
same float32 constants, so the two tables differ by float32 rounding of the
engine (1.5e-5 relative); held at 3e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from mjrl_tpu.envs.assets import swimmer_model as jax_swimmer_model
from mjrl_tpu.physics.planar import extract_planar as jax_extract_planar
import torch

from mjrl_tpu_torch import envs as torch_envs
from mjrl_tpu_torch.envs.assets import swimmer_model
from mjrl_tpu_torch.envs.swimmer import SwimmerEnv
from mjrl_tpu_torch.physics import model as tmodel
from mjrl_tpu_torch.physics.planar import (PlanarParams, chain_mask,
                                           extract_planar)

MODEL_FIELDS = [f.name for f in dataclasses.fields(tmodel.Model)
                if f.name not in ("dof_invweight0", "body_invweight0")]


@pytest.fixture(scope="module")
def models():
    return (jax_swimmer_model().finalize(jnp.float64, solver="newton"),
            swimmer_model(solver="newton"))


@pytest.fixture(scope="module")
def planars(models):
    return jax_extract_planar(models[0]), extract_planar(models[1])


def _same(a, b, tol):
    """Nested tuples / arrays / scalars equal within ``tol``."""
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _same(x, y, tol)
        return
    if a is None:
        assert b is None
        return
    x, y = np.asarray(a), np.asarray(b)
    assert x.shape == y.shape, (x.shape, y.shape)
    if x.dtype.kind in "fiub" and y.dtype.kind in "fiub":
        np.testing.assert_allclose(np.asarray(y, np.float64),
                                   np.asarray(x, np.float64),
                                   rtol=tol, atol=tol)
    else:
        assert a == b


@pytest.mark.parametrize("name", MODEL_FIELDS)
def test_model_field_matches_jax(models, name):
    """Every Model field of the port equals the JAX Model's (1e-12)."""
    jm, tm = models
    if not hasattr(jm, name):
        pytest.fail(f"JAX Model has no field {name}")
    _same(getattr(jm, name), getattr(tm, name), 1e-12)


def test_invweights_match_jax(models):
    """dof_invweight0 / body_invweight0 from the port's numpy CRB agree
    with the JAX package's engine-derived tables at 1e-9."""
    jm, tm = models
    np.testing.assert_allclose(tm.dof_invweight0,
                               np.asarray(jm.dof_invweight0),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tm.body_invweight0,
                               np.asarray(jm.body_invweight0),
                               rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("name", PlanarParams._fields)
def test_planar_params_field_matches_jax(planars, name):
    """PlanarParams field by field (1e-12; invweight0 at 1e-9)."""
    pj, pt = planars
    assert pj is not None and pt is not None
    tol = 1e-9 if name == "invweight0" else 1e-12
    _same(getattr(pj, name), getattr(pt, name), tol)


@pytest.fixture(scope="module")
def planars_f32():
    return (jax_extract_planar(jax_swimmer_model().finalize(
                jnp.float32, solver="newton")),
            SwimmerEnv(dtype=torch.float32, device="cpu")._planar)


def _bits(x):
    """Nested tuples of numbers -> a flat list of python floats."""
    if isinstance(x, (tuple, list)):
        return [y for e in x for y in _bits(e)]
    return [float(x)]


@pytest.mark.parametrize("name", PlanarParams._fields)
def test_float32_swimmer_planar_params_field_matches_jax(planars_f32, name):
    """The float32 SwimmerEnv's model is finalized in float32, as the JAX
    package's float32 Swimmer is: every field equal bit for bit, derived
    constants (fluid boxes, limit k and b) included; invweight0 at 3e-5
    relative (see the module docstring)."""
    pj, pt = planars_f32
    a, b = _bits(getattr(pj, name)), _bits(getattr(pt, name))
    assert len(a) == len(b)
    if name == "invweight0":
        np.testing.assert_allclose(b, a, rtol=3e-5, atol=0)
        assert [float(np.float32(x)) for x in b] == b   # float32 values
    else:
        assert a == b


def test_float32_swimmer_differs_from_float64_in_the_last_bits(planars,
                                                               planars_f32):
    """The float32 model is not the float64 one: its timestep and limit
    stiffness are the float32 model's."""
    p64, p32 = planars[1], planars_f32[1]
    assert p32.timestep == float(np.float32(0.005)) != p64.timestep == 0.005
    assert p32.limit_k != p64.limit_k
    assert p32.limit_k == tuple(float(np.float32(x)) for x in p32.limit_k)


def test_planar_params_swimmer_shape(planars):
    """The sizes the kernel is instantiated for: nv 7, 5 bodies, 4
    actuators, 4 limited hinges, no damping, no contacts, Euler."""
    _, p = planars
    assert (p.nv, p.nbody, len(p.actuators)) == (7, 5, 4)
    assert sum(1 for x in p.limited if x) == 4
    assert not any(p.damping)
    assert not p.contacts_pt and not p.contacts_cc
    assert p.integrator == tmodel.EULER
    chain = chain_mask(p)
    # link b is driven by the two slides, the root hinge and hinges 1..b
    for b in range(5):
        assert chain[b] == [1.0] * (3 + b) + [0.0] * (4 - b)


def test_penalty_solver_has_no_planar_path():
    """Only implicit-solver models qualify for the fast path."""
    assert extract_planar(swimmer_model(solver="penalty")) is None


def _builders():
    from mjrl_tpu.physics import model as jmodel
    return jmodel.ModelBuilder(), tmodel.ModelBuilder()


def _fields_match(jb, tb, **kw):
    jm, tm = jb.finalize(jnp.float64, **kw), tb.finalize(**kw)
    for f in ("actuator_gain", "actuator_bias", "actuator_gearv", "gear",
              "eq_data", "eq_solref", "eq_solimp", "eq_active",
              "dof_invweight0", "body_invweight0"):
        np.testing.assert_allclose(getattr(tm, f), np.asarray(getattr(jm, f)),
                                   rtol=1e-9, atol=1e-12, err_msg=f)
    for f in ("actuator_joint", "actuator_tendon", "actuator_simple",
              "eq_kind", "eq_obj1", "eq_obj2", "contact_pairs",
              "contact_pair_condim", "nu", "neq"):
        assert getattr(tm, f) == getattr(jm, f), f
    return tm


@pytest.mark.parametrize("jnt", ["free", "ball"])
def test_motor_on_free_and_ball_joints_matches_jax(jnt):
    """A motor on a free or ball joint (a vector-gear transmission) builds
    as the JAX package builds it."""
    tm = _fields_match(*_builders_with(jnt))
    assert not tm.actuator_simple


def _builders_with(jnt):
    out = []
    for b in _builders():
        body = b.add_body(0)
        b.add_geom(body, "sphere", size=(0.1,))
        j = b.add_joint(body, jnt)
        b.add_actuator(j, gear=(1.0, 0.5, 0.25, -0.5, 0.2, 0.1)[
            :6 if jnt == "free" else 3])
        out.append(b)
    return out


def _declare(b, method):
    body = b.add_body(0, pos=(0, 0, 1))
    j = b.add_joint(body, "hinge", axis=(0, 1, 0))
    b.add_geom(body, "sphere", size=(0.1,))
    body2 = b.add_body(0, pos=(0.15, 0, 1))
    j2 = b.add_joint(body2, "hinge", axis=(0, 1, 0))
    b.add_geom(body2, "sphere", size=(0.1,))
    if method == "add_tendon":
        b.add_actuator(tendon=b.add_tendon([(j, 1.0), (j2, 0.5)]), gear=2.0)
    elif method == "add_equality_joint":
        b.add_equality_joint(j, j2, polycoef=(0.1, 0.5, 0, 0, 0))
    elif method == "add_equality_connect":
        b.add_equality_connect(body, body2, anchor=(0.1, 0, 0))
    elif method == "add_equality_weld":
        b.add_equality_weld(body, body2, anchor=(0.05, 0, 0),
                            torquescale=0.5)
    elif method == "add_contact_pair":
        b.add_contact_pair(0, 1, condim=4)
    else:
        b.add_contact_exclude(body, body2)
    return b


@pytest.mark.parametrize("method", ["add_tendon", "add_equality_joint",
                                    "add_equality_connect",
                                    "add_equality_weld", "add_contact_pair",
                                    "add_contact_exclude"])
def test_general_engine_declarations_match_jax(method):
    """What the general engine left to M9b builds as the JAX package
    builds it: a tendon transmission, equalities (the connect's and weld's
    qpos0 anchors and relative quaternion resolved), an explicit pair with
    its condim, an exclude."""
    jb, tb = _builders()
    tm = _fields_match(_declare(jb, method), _declare(tb, method),
                       solver="pgs")
    if method == "add_contact_exclude":
        assert tm.contact_pairs == ()
    if method == "add_contact_pair":
        assert tm.contact_pair_condim == (4,)


def test_unknown_solver_rejected():
    with pytest.raises(ValueError, match="unknown solver"):
        swimmer_model().finalize(solver="nope")


def test_geom_mass_inertia_matches_jax():
    """The inertiafromgeom formulas, geom type by geom type (1e-12)."""
    from mjrl_tpu.physics import model as jmodel
    rng = np.random.RandomState(0)
    for gtype in (tmodel.SPHERE, tmodel.CAPSULE, tmodel.CYLINDER,
                  tmodel.BOX):
        size = rng.uniform(0.05, 0.5, 3)
        for mass in (None, 1.7):
            mj, ij = jmodel._geom_mass_inertia(gtype, size, 900.0, mass)
            mt, it = tmodel._geom_mass_inertia(gtype, size, 900.0, mass)
            np.testing.assert_allclose(mt, mj, rtol=1e-12)
            np.testing.assert_allclose(it, ij, rtol=1e-12)


def test_registry():
    assert torch_envs.registered_ids() == [
        "AdroitHandRelocate-v1", "Ant-v3", "Ant-v4", "HalfCheetah-v3",
        "HalfCheetah-v4", "Hopper-v3", "Hopper-v4", "Humanoid-v3",
        "Humanoid-v4", "InvertedPendulum-v2", "InvertedPendulum-v4",
        "Walker2d-v3", "Walker2d-v4", "mjrl_peg_insertion-v0",
        "mjrl_point_mass-v0", "mjrl_reacher_7dof-v0", "mjrl_swimmer-v0",
        "relocate-v0"]
    assert torch_envs.make("relocate-v0", device="cpu").spec \
        == torch_envs.EnvSpec(39, 30, 200)
    with pytest.raises(KeyError, match="unknown env id"):
        torch_envs.make("mjrl_hopper-v0")
    env = torch_envs.make("mjrl_swimmer-v0", device="cpu")
    assert env.spec == torch_envs.EnvSpec(12, 4, 500)
    assert env.device.type == "cpu"
