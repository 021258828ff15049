"""Port vs JAX package: host-side model building for the swimmer.

The numpy ``Model`` of ``mjrl_tpu_torch.physics.model`` and the
``PlanarParams`` extracted from it are held, field by field, to the JAX
package's (float64).  Tolerances: 1e-12 on fields that are copied or
computed by the same numpy code, 1e-9 on the inverse-weight tables, which
the port computes with its own composite-rigid-body evaluation instead of
the JAX package's general 3D engine.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from mjrl_tpu.envs.assets import swimmer_model as jax_swimmer_model
from mjrl_tpu.physics.planar import extract_planar as jax_extract_planar
from mjrl_tpu_torch import envs as torch_envs
from mjrl_tpu_torch.envs.assets import swimmer_model
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


@pytest.mark.parametrize("jnt", ["free", "ball"])
def test_free_and_ball_joints_not_ported(jnt):
    b = tmodel.ModelBuilder()
    body = b.add_body(0)
    with pytest.raises(NotImplementedError, match="M8"):
        b.add_joint(body, jnt)


@pytest.mark.parametrize("method", ["add_tendon", "add_equality_joint",
                                    "add_equality_connect",
                                    "add_equality_weld", "add_contact_pair",
                                    "add_contact_exclude"])
def test_general_engine_declarations_not_ported(method):
    b = tmodel.ModelBuilder()
    with pytest.raises(NotImplementedError, match="M8/M9"):
        getattr(b, method)()


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
    assert torch_envs.registered_ids() == ["mjrl_swimmer-v0"]
    with pytest.raises(KeyError, match="unknown env id"):
        torch_envs.make("mjrl_hopper-v0")
    env = torch_envs.make("mjrl_swimmer-v0", device="cpu")
    assert env.spec == torch_envs.EnvSpec(12, 4, 500)
    assert env.device.type == "cpu"
