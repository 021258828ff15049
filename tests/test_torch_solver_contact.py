"""Port vs JAX package: the contact rows of the implicit solver (CPU,
float64).

- ``constraint_rows`` on the MuJoCo golden contact states of peg insertion
  (282 condim-1 slots capped at 64 rows), Ant (25 condim-3 slots, four
  pyramidal facets each) and Humanoid (111 condim-1 slots capped at 64, 29
  condim-3, two fixed-tendon rows): J, the position part of aref, the
  damping, activity, R, the bounds and ``slot_ids`` against the JAX
  package's at 1e-9 (relative to each part's largest entry; slot ids and
  activity exactly).
- The contact_topk selection against ``jax.lax.top_k`` on depths with
  exact ties: the lower slot wins, as in the JAX package.
- ``qacc_smooth`` (a cold APGD solve) against the JAX package's at 1e-9 of
  the largest entry on a few states of each model; against MuJoCo's qacc
  under the JAX tests' own gates (``tests/test_solver.py:136-164``: median
  under 2 %, p90 under 0.12 / 0.12 / 0.2); the cap against the full set on
  8 peg states under 5e-3 (``:166-189``); the sliding-sphere friction
  golden (``:84-100``).
- What this slice left out until the rest of the general engine was
  ported (the elliptic cone, condim 4 and 6, Newton, noslip, equalities,
  explicit pairs and excludes, affine, vector-gear, ball and tendon
  actuators, Adroit) against the JAX package; a collidable mesh still
  raises.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.physics import dynamics as jdyn
from mjrl_tpu.physics import solver as jsolver
from mjrl_tpu.physics.kinematics import fwd_kinematics as jax_fk
from mjrl_tpu.physics.model import State as JState
from mjrl_tpu.physics.step import qacc_smooth as jax_qacc_smooth
from mjrl_tpu_torch import envs as tenvs
from mjrl_tpu_torch.envs.assets import peg_insertion_model
from mjrl_tpu_torch.physics import dynamics as tdyn
from mjrl_tpu_torch.physics import solver as tsolver
from mjrl_tpu_torch.physics.kinematics import fwd_kinematics
from mjrl_tpu_torch.physics.mjcf import load_mjcf
from mjrl_tpu_torch.physics.model import ModelBuilder, State
from mjrl_tpu_torch.physics.step import qacc_smooth, step_n

from test_torch_collision3d import GOLDEN, MODELS

from test_torch_mjcf_m9b import one_torch_thread  # noqa: E402,F401

TOL = 1e-9
ROWS = ("J", "aref_pos", "b_row", "active", "R", "lo", "hi", "slot_ids")


def _golden(name):
    return np.load(os.path.join(GOLDEN, MODELS[name][2] + ".npz"),
                   allow_pickle=True)


@pytest.fixture(scope="module", params=list(MODELS))
def rows(request):
    name = request.param
    jm, tm = MODELS[name][0]("newton"), MODELS[name][1]("newton")
    g = _golden(name)
    q, v = g["qpos"][:16], g["qvel"][:16]

    def jrows(qq, vv):
        d = jax_fk(jm, qq)
        r = jsolver.constraint_rows(jm, d, jdyn.compute_cdof(jm, d), qq, vv)
        return r[:7] + (r[8],)

    want = jax.jit(jax.vmap(jrows))(jnp.asarray(q), jnp.asarray(v))
    tq, tv = torch.tensor(q), torch.tensor(v)
    d = fwd_kinematics(tm, tq)
    got = tsolver.constraint_rows(tm, d, tdyn.compute_cdof(tm, d), tq, tv)
    return name, tm, want, got


@pytest.mark.parametrize("part", ROWS)
def test_constraint_rows_match_jax(rows, part):
    name, _, want, got = rows
    i = ROWS.index(part)
    w, g = np.asarray(want[i]), got[i].numpy()
    if part in ("lo", "hi"):
        w = w[0]                     # per-row constants in the port
    assert g.shape == w.shape, (name, part, g.shape, w.shape)
    if part in ("active", "slot_ids"):
        assert np.array_equal(g, w), (name, part)
        return
    scale = max(np.abs(w[np.isfinite(w)]).max(initial=0.0), 1e-300)
    np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL * scale,
                               err_msg=f"{name} {part}")


def test_rows_hold_the_expected_layout(rows):
    """Row counts and what the states exercise: capped classes change
    their slots between states, active contact rows exist."""
    name, tm, _, got = rows
    n = {"peg": 5 + 64, "ant": 8 + 4 * 25, "humanoid": 17 + 2 + 64 + 4 * 29}
    assert got[0].shape[1] == n[name] == tsolver.n_constraint_rows(tm)
    ids, active = got[7], got[3]
    contact = ids >= 0
    assert bool((active.bool() & contact).any()), name
    if tm.contact_topk:
        assert len({tuple(r) for r in ids.tolist()}) > 1, name


def test_topk_ties_pick_the_lower_slot_as_jax():
    rng = np.random.RandomState(0)
    for trial in range(20):
        C = int(rng.randint(65, 300))
        d = np.round(rng.normal(0, 0.01, (6, C)), 3)    # many exact ties
        d[:, rng.rand(C) < 0.4] = -0.996
        idx = np.sort(rng.choice(C, size=int(rng.randint(65, C + 1)),
                                 replace=False))
        k = 64
        _, li = jax.vmap(lambda x: jax.lax.top_k(x[idx], k))(jnp.asarray(d))
        want = np.sort(idx[np.asarray(li)], axis=1)
        got = tsolver._select(torch.tensor(d), torch.tensor(idx), k)
        assert got.tolist() == want.tolist(), trial


@pytest.mark.parametrize("name", list(MODELS))
def test_qacc_smooth_matches_jax(name):
    jm, tm = MODELS[name][0]("newton"), MODELS[name][1]("newton")
    g = _golden(name)
    q, v, u = g["qpos"][:4], g["qvel"][:4], g["ctrl"][:4]
    want = np.asarray(jax.jit(jax.vmap(lambda a, b, c: jax_qacc_smooth(
        jm, JState(qpos=a, qvel=b), c)))(*(jnp.asarray(x)
                                           for x in (q, v, u))))
    got = qacc_smooth(tm, State(qpos=torch.tensor(q), qvel=torch.tensor(v)),
                      torch.tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("name", list(MODELS))
def test_qacc_meets_the_mujoco_golden_gates(name):
    tm = MODELS[name][1]("newton")
    g = _golden(name)
    n = min(len(g["qpos"]), 25)
    acc = qacc_smooth(tm, State(qpos=torch.tensor(g["qpos"][:n]),
                                qvel=torch.tensor(g["qvel"][:n])),
                      torch.tensor(g["ctrl"][:n])).numpy()
    scale = np.maximum(np.abs(g["qacc"][:n]).max(1), 1.0)
    errs = np.abs(acc - g["qacc"][:n]).max(1) / scale
    assert np.median(errs) < 0.02, (np.median(errs), np.sort(errs)[-5:])
    p90_gate = 0.2 if name == "humanoid" else 0.12
    assert np.percentile(errs, 90) < p90_gate, np.sort(errs)[-5:]


def test_contact_topk_matches_full_active_set():
    g = _golden("peg")
    full = peg_insertion_model(solver="newton", contact_topk=0)
    topk = peg_insertion_model(solver="newton")
    assert (full.contact_topk, topk.contact_topk) == (0, 64)
    s = State(qpos=torch.tensor(g["qpos"][:8]),
              qvel=torch.tensor(g["qvel"][:8]))
    u = torch.tensor(g["ctrl"][:8])
    a_full = qacc_smooth(full, s, u).numpy()
    a_topk = qacc_smooth(topk, s, u).numpy()
    scale = np.maximum(np.abs(a_full).max(1), 1.0)
    assert (np.abs(a_full - a_topk).max(1) / scale < 5e-3).all()


def test_friction_sliding_sphere_matches_mujoco():
    """A sphere sliding on a plane (condim 3, pyramidal facets) slows
    until it rolls without slipping (MuJoCo: 2.0 -> 1.43 m/s)."""
    g = np.load(os.path.join(GOLDEN, "sliding_sphere.npz"),
                allow_pickle=True)
    model = load_mjcf(xml_string=str(g["xml"])).finalize(solver="pgs")
    qvel0 = torch.zeros((1, model.nv), dtype=torch.float64)
    qvel0[0, 0] = float(g["v0"])
    s = State(qpos=torch.tensor(g["qpos0"])[None], qvel=qvel0)
    out = step_n(model, s, torch.zeros((1, 0), dtype=torch.float64),
                 int(g["steps"]))
    vx, wy = float(out.qvel[0, 0]), float(out.qvel[0, 4])
    assert abs(vx - float(g["vx_end"])) < 0.15, vx
    assert abs(wy * 0.1 - vx) < 0.1, (wy, vx)


# ---- what M9b brought: each former refusal against the JAX package ---------

def _sphere_on_plane(MB, condim=3, **opt):
    b = MB(**opt)
    b.add_geom(0, "plane", size=(5, 5, 1))
    body = b.add_body(0, pos=(0, 0, 0.1))
    b.add_joint(body, "free")
    b.add_geom(body, "sphere", size=(0.1,), condim=condim)
    return b


def _hinge(MB):
    """A pendulum on a hinge with a sphere geom above a plane that
    neither collides with (contype 0)."""
    b = MB()
    b.add_geom(0, "plane", size=(5, 5, 1), contype=0, conaffinity=0)
    body = b.add_body(0, pos=(0, 0, 0.3))
    j = b.add_joint(body, "hinge", axis=(0, 1, 0), damping=0.1)
    b.add_geom(body, "sphere", size=(0.1,), pos=(0.2, 0, -0.25),
               contype=0, conaffinity=0)
    return b, j, body


def _two_hinges(MB):
    b, j, body = _hinge(MB)
    body2 = b.add_body(0, pos=(0.45, 0, 0.3))
    j2 = b.add_joint(body2, "hinge", axis=(0, 1, 0))
    b.add_geom(body2, "sphere", size=(0.1,), pos=(-0.2, 0, -0.25))
    b.add_geom(body, "sphere", size=(0.08,), pos=(0.25, 0, -0.2))
    return b, j, j2, body, body2


def _contact_pair(MB):
    b, _, _ = _hinge(MB)
    b.add_contact_pair(0, 1, condim=3)        # the plane and the sphere
    return b


def _exclude(MB):
    b, _, _, body, body2 = _two_hinges(MB)
    b.add_contact_exclude(body, body2)
    return b


def _affine(MB):
    b, j, _ = _hinge(MB)
    b.add_actuator(j, gain=2.0, bias=(0.1, -2.0, -0.5))
    return b


def _vector_gear(MB):
    b, j, _ = _hinge(MB)
    b.add_actuator(j, gear=(1.0, 0.5))
    return b


def _ball_motor(MB):
    b = MB()
    body = b.add_body(0, pos=(0, 0, 1))
    j = b.add_joint(body, "ball", damping=0.1)
    b.add_geom(body, "capsule", fromto=(0, 0, 0, 0, 0, -0.3), size=(0.04,))
    b.add_actuator(j, gear=(1.0, 0.5, 0.25))
    return b


def _tendon_motor(MB):
    b, j, j2, _, _ = _two_hinges(MB)
    b.add_actuator(tendon=b.add_tendon([(j, 1.0), (j2, -0.5)]), gear=2.0)
    return b


def _equality(MB):
    b, j, j2, _, _ = _two_hinges(MB)
    b.add_equality_joint(j, j2, polycoef=(0.1, 0.5, 0.2, 0, 0))
    return b


def _finalize(b, **kw):
    from mjrl_tpu.physics.model import ModelBuilder as JaxBuilder
    if isinstance(b, JaxBuilder):
        return b.finalize(jnp.float64, **kw)
    return b.finalize(**kw)


FORMER_M9B = {
    "elliptic": (lambda MB: _sphere_on_plane(MB, cone="elliptic"), {}),
    "condim4": (lambda MB: _sphere_on_plane(MB, 4), {}),
    "condim6": (lambda MB: _sphere_on_plane(MB, 6), {}),
    "newton_iters": (_sphere_on_plane, {"newton_iters": 3}),
    "noslip": (lambda MB: _sphere_on_plane(MB, noslip_iterations=4), {}),
    "equality": (_equality, {}),
    "contact_pair": (_contact_pair, {}),
    "exclude": (_exclude, {}),
    "affine_gain": (_affine, {}),
    "vector_gear": (_vector_gear, {}),
    "ball_motor": (_ball_motor, {}),
    "tendon_transmission": (_tendon_motor, {}),
}


def _states(tm, n=3):
    rng = np.random.RandomState(0)
    q = np.tile(tm.qpos0, (n, 1))
    if tm.jnt_type[0] == 0:              # the sphere on the plane: in contact
        q[:, 2] = 0.1 - rng.uniform(0.0005, 0.002, n)
    elif tm.jnt_type[0] == 1:            # the ball joint: tilted
        quat = np.array([1.0, 0.2, -0.1, 0.05]) + rng.normal(0, 0.05, (n, 4))
        q[:, :4] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    else:
        q = q + rng.uniform(-0.8, 0.8, q.shape)
    v = rng.normal(0, 1, (n, tm.nv))
    return q, v, rng.uniform(-1.5, 1.5, (n, tm.nu))


@pytest.mark.parametrize("item", list(FORMER_M9B) + ["adroit"])
def test_former_m9b_items_match_jax(item):
    """What raised NotImplementedError naming M9b before the rest of the
    general engine was ported now builds, and one output of it matches
    the JAX package at 1e-9: qacc_smooth under the implicit solver (the
    Adroit env, from the port's own XML: its contact pairs and servo
    tables against the JAX parser's on the installed MJCF; the whole model
    is held in test_torch_adroit.py)."""
    if item == "adroit":
        pytest.importorskip("gymnasium_robotics")
        from mjrl_tpu.envs.adroit import adroit_asset
        from mjrl_tpu.physics.mjcf import load_mjcf as jax_load_mjcf
        tm = tenvs.make("relocate-v0", device="cpu",
                        dtype=torch.float64).model
        jb = jax_load_mjcf(adroit_asset())
        jb._sort_by_body()
        pairs, condims = jb._contact_pairs()
        assert (tm.contact_pairs, tm.contact_pair_condim) == (pairs, condims)
        for f, k in (("actuator_gain", "gain"), ("actuator_bias", "bias"),
                     ("ctrlrange", "ctrlrange")):
            np.testing.assert_allclose(
                getattr(tm, f), np.array([a[k] for a in jb.actuators]),
                rtol=TOL, atol=TOL, err_msg=f)
        return
    from mjrl_tpu.physics.model import ModelBuilder as JaxBuilder
    make, kw = FORMER_M9B[item]
    jm = _finalize(make(JaxBuilder), solver="newton", **kw)
    tm = _finalize(make(ModelBuilder), solver="newton", **kw)
    q, v, u = _states(tm)
    acc = jax.jit(jax.vmap(lambda qq, vv, uu: jax_qacc_smooth(
        jm, JState(qpos=qq, qvel=vv), uu)))
    want = np.asarray(acc(jnp.asarray(q), jnp.asarray(v), jnp.asarray(u)))
    got = qacc_smooth(tm, State(qpos=torch.tensor(q), qvel=torch.tensor(v)),
                      torch.tensor(u)).numpy()
    scale = np.maximum(np.abs(want).max(1, keepdims=True), 1.0)
    assert (np.abs(got - want) / scale).max() < TOL, item
    assert tm.contact_pairs == jm.contact_pairs, item


_MESH = ('<mujoco><asset><mesh name="m" vertex="0 0 0 1 0 0 0 1 0 0 0 1"/>'
         '</asset><worldbody><body><joint type="hinge"/>'
         '<geom type="mesh" mesh="m"/></body></worldbody></mujoco>')


def test_collidable_mesh_raises_as_jax():
    """A collidable mesh still raises, with the JAX package's wording."""
    with pytest.raises(NotImplementedError,
                       match="collidable mesh geoms are not supported"):
        load_mjcf(xml_string=_MESH)
