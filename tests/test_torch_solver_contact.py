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
- Everything this slice leaves out raises, naming ROADMAP.md M9b.
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
from mjrl_tpu_torch.physics.step import check_model, qacc_smooth, step_n

from test_torch_collision3d import GOLDEN, MODELS

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


# ---- what M9b holds ------------------------------------------------------------

def _sphere_on_plane(condim=3, **opt):
    b = ModelBuilder(**opt)
    b.add_geom(0, "plane", size=(5, 5, 1))
    body = b.add_body(0, pos=(0, 0, 0.1))
    b.add_joint(body, "free")
    b.add_geom(body, "sphere", size=(0.1,), condim=condim)
    return b


def _hinge():
    b = ModelBuilder()
    body = b.add_body(0)
    return b, b.add_joint(body, "hinge"), body


def _ball_motor():
    b = ModelBuilder()
    b.add_actuator(b.add_joint(b.add_body(0), "ball"))


def _tendon_motor():
    b, j, _ = _hinge()
    b.add_actuator(tendon=b.add_tendon([(j, 1.0)]))


_MESH = ('<mujoco><asset><mesh name="m" vertex="0 0 0 1 0 0 0 1 0 0 0 1"/>'
         '</asset><worldbody><body><joint type="hinge"/>'
         '<geom type="mesh" mesh="m"/></body></worldbody></mujoco>')

M9B = {
    "elliptic": lambda: check_model(_sphere_on_plane(cone="elliptic")
                                    .finalize(solver="pgs")),
    "condim4": lambda: check_model(_sphere_on_plane(4).finalize(
        solver="pgs")),
    "condim6": lambda: check_model(_sphere_on_plane(6).finalize(
        solver="pgs")),
    "newton_iters": lambda: _sphere_on_plane().finalize(solver="pgs",
                                                        newton_iters=3),
    "noslip": lambda: check_model(_sphere_on_plane(noslip_iterations=4)
                                  .finalize(solver="pgs")),
    "equality": lambda: _hinge()[0].add_equality_joint(0),
    "contact_pair": lambda: _hinge()[0].add_contact_pair(0, 1),
    "exclude": lambda: _hinge()[0].add_contact_exclude(0, 1),
    "affine_gain": lambda: _hinge()[0].add_actuator(0, gain=2.0,
                                                    bias=(0, -2, 0)),
    "vector_gear": lambda: _hinge()[0].add_actuator(0, gear=(1.0, 0.5)),
    "ball_motor": _ball_motor,
    "tendon_transmission": _tendon_motor,
    "mesh": lambda: load_mjcf(xml_string=_MESH),
    "adroit": lambda: tenvs.make("relocate-v0", device="cpu"),
}


@pytest.mark.parametrize("item", list(M9B))
def test_m9b_items_raise_naming_m9b(item):
    with pytest.raises(NotImplementedError, match="M9b"):
        M9B[item]()
