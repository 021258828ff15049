"""Port vs JAX package: the MJCF parser and the models it builds (host side,
float64).

``mjrl_tpu_torch.physics.mjcf.load_mjcf`` is held to the JAX package's
parser on the port's own copies of the three gym locomotion files: every
``Model`` field at 1e-12 (same numpy arithmetic; the JAX side stores its
arrays through jnp), and the ``PlanarParams`` extracted from it field by
field, contact tables, cone and integrator included.  The copies are
byte-for-byte the files of the installed ``gymnasium``.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest

from mjrl_tpu.physics import planar as jplanar
from mjrl_tpu.physics.mjcf import load_mjcf as jax_load_mjcf
from mjrl_tpu_torch.physics import model as tmodel
from mjrl_tpu_torch.physics import planar as tplanar
from mjrl_tpu_torch.physics.mjcf import load_mjcf

from test_torch_kernel_host import CONTACT_MODELS, MJCF

FILES = [v[0] for v in CONTACT_MODELS.values()]
# (nv, bodies, nu, integrator, contacts_pt, contacts_cc, rows)
SIZES = {"hopper.xml": (6, 4, 3, tmodel.RK4, 8, 3, 38),
         "walker2d.xml": (9, 7, 6, tmodel.RK4, 14, 0, 62),
         "half_cheetah.xml": (9, 7, 6, tmodel.EULER, 16, 0, 70)}


def flatten(tree):
    out = []

    def rec(x):
        if isinstance(x, (tuple, list)):
            for y in x:
                rec(y)
        else:
            out.append(float(x))
    rec(tree)
    return np.array(out)


@pytest.fixture(scope="module", params=FILES)
def models(request):
    path = os.path.join(MJCF, request.param)
    return (request.param,
            jax_load_mjcf(path).finalize(jnp.float64, solver="newton"),
            load_mjcf(path).finalize(solver="newton"))


def test_model_fields_match_jax(models):
    _, mj, mt = models
    compared = 0
    for f in dataclasses.fields(mt):
        a, b = getattr(mt, f.name), getattr(mj, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == np.float64
            np.testing.assert_allclose(a, np.asarray(b, np.float64),
                                       rtol=1e-12, atol=1e-12,
                                       err_msg=f.name)
        else:
            assert a == b, f.name
        compared += 1
    assert compared > 60


def test_planar_params_match_jax(models):
    name, mj, mt = models
    pj, pt = jplanar.extract_planar(mj), tplanar.extract_planar(mt)
    assert pj is not None and pt is not None
    assert pt._fields == pj._fields
    for field in pt._fields:
        a, b = getattr(pt, field), getattr(pj, field)
        if isinstance(a, (int, float)):
            assert a == pytest.approx(b, abs=1e-12), field
        else:
            fa, fb = flatten(a), flatten(b)
            assert fa.shape == fb.shape, field
            np.testing.assert_allclose(fa, fb, rtol=1e-12, atol=1e-12,
                                       err_msg=field)
    nv, nb, nu, integ, npt, ncc, rows = SIZES[name]
    assert (pt.nv, pt.nbody, len(pt.actuators), pt.integrator,
            len(pt.contacts_pt), len(pt.contacts_cc),
            tplanar.n_planar_rows(pt)) == (nv, nb, nu, integ, npt, ncc, rows)
    assert pt.cone == 0 and tplanar.needs_contact_path(pt)
    assert (pt.ax1, pt.ax2) == (2, 0)            # the (z, x) plane, hinge +y
    if name == "half_cheetah.xml":
        assert any(pt.stiffness) and pt.timestep == 0.01
    else:
        assert not any(pt.stiffness) and pt.timestep == 0.002


@pytest.mark.parametrize("fname", FILES)
def test_float32_model_is_rounded_like_the_jax_one(fname):
    """finalize(dtype=float32) rounds every numeric field to float32, as the
    JAX package's float32 model is stored: the timestep 0.002 reads
    0.0020000000949949026.  The inverse weights are computed from the
    rounded model on both sides, in different precision: 1e-4 relative."""
    path = os.path.join(MJCF, fname)
    mj = jax_load_mjcf(path).finalize(jnp.float32, solver="newton")
    mt = load_mjcf(path).finalize(solver="newton", dtype=np.float32)
    assert float(mt.timestep) == float(mj.timestep) \
        == float(np.float32(float(mt.timestep)))
    for f in ("body_mass", "body_inertia", "body_pos", "dof_damping",
              "dof_range", "geom_size", "geom_pos", "gear"):
        assert np.array_equal(getattr(mt, f),
                              np.asarray(getattr(mj, f), np.float64)), f
    np.testing.assert_allclose(mt.dof_invweight0,
                               np.asarray(mj.dof_invweight0), rtol=1e-4)
    pt = tplanar.extract_planar(mt)
    assert pt.timestep == float(mj.timestep)


@pytest.mark.parametrize("fname", FILES)
def test_xml_copies_are_gymnasium_s_files(fname):
    gymnasium = pytest.importorskip("gymnasium")
    theirs = os.path.join(os.path.dirname(gymnasium.__file__), "envs",
                          "mujoco", "assets", fname)
    with open(theirs, "rb") as f, open(os.path.join(MJCF, fname), "rb") as g:
        assert f.read() == g.read()
    assert os.path.exists(os.path.join(MJCF, "LICENSE.gymnasium"))


def test_elliptic_cone_option_and_xml_string():
    xml = open(os.path.join(MJCF, "hopper.xml")).read()
    b = load_mjcf(xml_string=xml.replace('<option ',
                                         '<option cone="elliptic" '))
    m = b.finalize(solver="newton")
    p = tplanar.extract_planar(m)
    assert m.cone == tmodel.ELLIPTIC and p.cone == 1
    assert tplanar.n_planar_rows(p) == 3 + 3 + 8 * 3
    assert tplanar._planar_soc(p)[:2] == (6, 8)


_BODY = ('<mujoco><worldbody><body><joint name="j" type="{jt}"/>'
         '<geom size="0.1"/></body></worldbody>{extra}</mujoco>')


_MOTOR = '<actuator><motor joint="j"/></actuator>'


_ACT = ("actuator_gain", "actuator_bias", "actuator_gearv",
        "actuator_simple", "actuator_joint", "actuator_tendon")


@pytest.mark.parametrize("jt, extra, what", [
    ("free", _MOTOR, _ACT),
    ("ball", _MOTOR, _ACT),
    ("hinge", '<actuator><position joint="j" kp="2"/></actuator>', _ACT),
    ("hinge", '<tendon><fixed name="t"><joint joint="j" coef="1"/></fixed>'
     '</tendon><actuator><motor tendon="t"/></actuator>', _ACT),
    ("hinge", '<equality><joint joint1="j"/></equality>',
     ("eq_kind", "eq_obj1", "eq_obj2", "eq_data", "eq_solref",
      "eq_solimp", "eq_active")),
    ("hinge", '<contact><exclude body1="world" body2="world"/></contact>',
     ("contact_pairs", "contact_pair_condim")),
], ids=["free", "ball", "servo", "tendon", "equality", "exclude"])
def test_formerly_unbuildable_elements_match_jax(jt, extra, what):
    """Elements the port refused until the rest of the general engine was
    ported build as the JAX package builds them."""
    xml = _BODY.format(jt=jt, extra=extra)
    jm = jax_load_mjcf(xml_string=xml).finalize(jnp.float64)
    tm = load_mjcf(xml_string=xml).finalize()
    for f in what:
        a, b = getattr(jm, f), getattr(tm, f)
        if isinstance(b, np.ndarray):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-12,
                                       atol=1e-12, err_msg=f)
        else:
            assert a == b, f
