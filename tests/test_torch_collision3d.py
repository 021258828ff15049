"""Port vs JAX package: the narrowphase of the general engine (CPU,
float64).

- ``find_contacts`` of every pair group on peg insertion (box-sphere,
  box-capsule, cylinder-box axis samples, static box-box walls; the hole
  moved per state), Ant (plane-sphere, plane-capsule) and Humanoid (plus
  capsule-sphere, capsule-capsule, sphere-sphere): depths, points and
  normals at 1e-9, g1/g2 equal, in the same emission order, on the MuJoCo
  golden contact states and perturbations of them.
- ``contact_geom_ids`` and ``contact_pair_condims`` equal.
- Capsule-box slots in the submerged branch (the deeper end's centre
  inside the box: one slot suppressed) and the collapsed branch (the clip
  interval shrinks to a point: slot 1 suppressed), kept 1 cm from the
  branch boundaries.
- The box-box, capsule-box and sphere-box scenes of
  ``tests/test_manifolds.py`` against the JAX package.
- The penalty path's ``contact_qfrc`` against JAX on Ant and Humanoid.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.envs.assets import peg_insertion_model as jax_peg_model
from mjrl_tpu.physics import collision as jcol
from mjrl_tpu.physics import dynamics as jdyn
from mjrl_tpu.physics.kinematics import fwd_kinematics as jax_fk
from mjrl_tpu.physics.mjcf import load_mjcf as jax_load_mjcf
from mjrl_tpu_torch.envs.assets import peg_insertion_model
from mjrl_tpu_torch.physics import collision as tcol
from mjrl_tpu_torch.physics import dynamics as tdyn
from mjrl_tpu_torch.physics.kinematics import fwd_kinematics
from mjrl_tpu_torch.physics.mjcf import load_mjcf

from test_manifolds import BASE, SCENES
from test_torch_mjcf_m9b import one_torch_thread  # noqa: F401

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden")
MJCF = os.path.join(HERE, "..", "mjrl_tpu_torch", "envs", "mjcf")
TOL = 1e-9
# the peg's three moved bodies (target, w4, w3) shift in y with the hole
PEG_MOVED = ("target", "w4", "w3")


def _gym(name):
    return os.path.join(MJCF, f"{name}.xml")


MODELS = {
    "peg": (lambda s: jax_peg_model().finalize(jnp.float64, solver=s),
            lambda s: peg_insertion_model(solver=s), "contact_peg_insertion"),
    "ant": (lambda s: jax_load_mjcf(_gym("ant")).finalize(jnp.float64,
                                                          solver=s),
            lambda s: load_mjcf(_gym("ant")).finalize(solver=s),
            "contact_ant"),
    "humanoid": (lambda s: jax_load_mjcf(_gym("humanoid")).finalize(
        jnp.float64, solver=s),
        lambda s: load_mjcf(_gym("humanoid")).finalize(solver=s),
        "contact_humanoid"),
}


def _states(name, rng):
    """The golden contact states, then the same perturbed."""
    g = np.load(os.path.join(GOLDEN, MODELS[name][2] + ".npz"))
    q = g["qpos"][:16]
    q2 = q + rng.normal(0, 0.02, q.shape)
    return np.concatenate([q, q2])


def _peg_body_pos(goal_y):
    """(B, nbody, 3) body offsets of the peg with the hole at goal_y."""
    b = peg_insertion_model()
    ids = [b.names["body"][n] for n in PEG_MOVED]
    base = np.asarray(b.finalize().body_pos, np.float64)
    bp = np.tile(base, (len(goal_y), 1, 1))
    for i in ids:
        bp[:, i, 1] += goal_y - 0.29
    return bp


@pytest.fixture(scope="module", params=list(MODELS))
def contacts(request):
    name = request.param
    jm, tm = MODELS[name][0]("newton"), MODELS[name][1]("newton")
    rng = np.random.RandomState(2)
    q = _states(name, rng)
    if name == "peg":
        bp = _peg_body_pos(rng.uniform(0.1, 0.5, len(q)))
    else:
        bp = np.tile(np.asarray(tm.body_pos), (len(q), 1, 1))

    def jfind(qq, bb):
        m = jm.replace(body_pos=bb)
        d, p, n, g1, g2 = jcol.find_contacts(m, jax_fk(m, qq))
        return d, jnp.stack(p, -1), jnp.stack(n, -1), g1, g2

    want = jax.jit(jax.vmap(jfind))(jnp.asarray(q), jnp.asarray(bp))
    got = tcol.find_contacts(tm, fwd_kinematics(
        tm, torch.tensor(q), body_pos=torch.tensor(bp)))
    return name, jm, tm, want, got


@pytest.mark.parametrize("part", ["depth", "point", "normal"])
def test_find_contacts_match_jax(contacts, part):
    name, _, _, want, got = contacts
    i = ("depth", "point", "normal").index(part)
    w, g = np.asarray(want[i]), got[i].numpy()
    assert g.shape == w.shape, (name, part)
    np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                               err_msg=f"{name} {part}")


def test_emission_order_and_condims_match_jax(contacts):
    name, jm, tm, want, got = contacts
    for k, (w, g) in enumerate(zip(want[3:], got[3:])):
        assert np.asarray(w)[0].tolist() == g.tolist(), (name, k)
    jg1, jg2 = jcol.contact_geom_ids(jm)
    tg1, tg2 = tcol.contact_geom_ids(tm)
    assert tg1.tolist() == jg1.tolist() and tg2.tolist() == jg2.tolist()
    assert tcol.contact_pair_condims(tm).tolist() \
        == jcol.contact_pair_condims(jm).tolist()
    # every state set has active and inactive slots
    d = got[0]
    assert bool((d > 0).any()) and bool((d <= 0).any()), name


def test_groups_emitted_per_model():
    """The slot counts of each group, as the JAX package emits them."""
    want = {"peg": {"box_sphere": 24, "box_capsule": 168, "box_axis": 30,
                    "box_box": 60},
            "ant": {"plane_sphere": 1, "plane_capsule": 24},
            "humanoid": {"plane_sphere": 5, "plane_capsule": 24,
                         "capsule_sphere": 49, "capsule_capsule": 52,
                         "sphere_sphere": 10}}
    for name, counts in want.items():
        tm, jm = MODELS[name][1]("newton"), MODELS[name][0]("newton")
        tg = {k: len(v) for k, v in tcol._grouped_pairs(tm).items() if v}
        jg = {k: len(v) for k, v in jcol._grouped_pairs(jm).items() if v}
        assert tg == jg == counts, name


# ---- capsule-box branches and the manifold scenes ---------------------------

def _scene_xml(tsize, pos, euler, geom):
    return BASE.format(tsize=tsize, pos=pos, euler=euler, geom=geom)


# (label, table half-sizes, body pos, euler, geom): a capsule whose lower
# end's centre sits 2 cm inside the table (submerged), and a capsule lying
# along x beyond the table's y edge, nearest the top face (collapsed)
BRANCHES = [
    ("submerged", "0.5 0.5 0.1", "0 0 0.08", "0 0 0",
     '<geom type="capsule" size="0.03 0.1"/>'),
    ("collapsed", "0.5 0.5 0.1", "0 0.51 0.02", "0 90 0",
     '<geom type="capsule" size="0.05 0.1"/>'),
]


def _scene_pair(xml):
    jm = jax_load_mjcf(xml_string=xml).finalize(jnp.float64)
    tm = load_mjcf(xml_string=xml).finalize()
    q = np.zeros(tm.nq)
    jd, jp, jn, _, _ = jcol.find_contacts(jm, jax_fk(jm, jnp.asarray(q)))
    td, tp, tn, _, _ = tcol.find_contacts(
        tm, fwd_kinematics(tm, torch.tensor(q)[None]))
    return (np.asarray(jd), np.stack([np.asarray(x) for x in jp], -1),
            np.stack([np.asarray(x) for x in jn], -1)), \
        (td[0].numpy(), tp[0].numpy(), tn[0].numpy())


@pytest.mark.parametrize("label, tsize, pos, euler, geom",
                         BRANCHES + SCENES,
                         ids=[s[0] for s in BRANCHES + SCENES])
def test_scenes_match_jax(label, tsize, pos, euler, geom):
    want, got = _scene_pair(_scene_xml(tsize, pos, euler, geom))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL, err_msg=label)
    assert (got[0] > 0).any(), label
    if label in ("submerged", "collapsed"):
        # one of the two capsule-box slots is suppressed (depth -1 plus
        # the zero margin)
        assert sorted(got[0] == -1.0) == [False, True], (label, got[0])
    if label == "collapsed":
        assert got[0][1] == -1.0


# ---- penalty contact forces -------------------------------------------------

@pytest.mark.parametrize("name", ["ant", "humanoid"])
def test_contact_qfrc_matches_jax(name):
    jm, tm = MODELS[name][0]("penalty"), MODELS[name][1]("penalty")
    rng = np.random.RandomState(3)
    q = _states(name, rng)[:12]
    v = rng.uniform(-1, 1, (len(q), tm.nv))

    def jq(qq, vv):
        d = jax_fk(jm, qq)
        cdof = jdyn.compute_cdof(jm, d)
        cvel, cdd = jdyn.compute_velocities(jm, d, cdof, vv)
        m, _ = jdyn.mass_and_bias(jm, d, cdof, cvel, cdd, vv)
        return jcol.contact_qfrc(jm, d, cdof, cvel, vv, jnp.diagonal(m))

    want = np.asarray(jax.jit(jax.vmap(jq))(jnp.asarray(q), jnp.asarray(v)))
    tq, tv = torch.tensor(q), torch.tensor(v)
    d = fwd_kinematics(tm, tq)
    cdof = tdyn.compute_cdof(tm, d)
    cvel, cdd = tdyn.compute_velocities(tm, d, cdof, tv)
    m, _ = tdyn.mass_and_bias(tm, d, cdof, cvel, cdd, tv)
    got = tcol.contact_qfrc(tm, d, cdof, cvel, tv,
                            torch.diagonal(m, dim1=-2, dim2=-1)).numpy()
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max())
