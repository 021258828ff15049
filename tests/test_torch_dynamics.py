"""Port vs JAX package: smooth dynamics of the general engine (CPU,
float64).

- Mass matrix, bias forces, passive forces (springs, damping, fluid) and
  the penalty path's ``qacc_smooth`` (limits, the reacher's fingertip-table
  contact) against the JAX package's on numpy-seeded states, 1e-10
  relative to each quantity's largest entry.  Models: point mass, the
  7-DoF reacher, the swimmer on the penalty solver with its geoms made
  non-colliding (fluid drag; the planar fast path only takes the implicit
  solver), the ``ball.npz`` tree and a sprung ball pendulum (quaternion
  springs).
- MuJoCo's golden data at the JAX tests' tolerances: ``point_mass.npz`` and
  ``reacher.npz`` (qM, qfrc_bias, qfrc_passive; qacc on the constraint-free
  states), ``ball.npz`` (qM, bias, qacc, one 5-substep transition, both
  trajectory endpoints) and ``freebody.npz`` stepped to its end state.

The ``ball.npz`` tree has one contact pair, its capsule against its box,
whose narrowphase is ROADMAP.md M9.  Its contacts are inactive in every
golden state (the JAX package's own depths, checked below), so the tree is
stepped here with its geoms non-colliding: the same dynamics.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.envs import assets as jassets
from mjrl_tpu.physics import dynamics as jdyn
from mjrl_tpu.physics.collision import find_contacts as jax_find_contacts
from mjrl_tpu.physics.kinematics import fwd_kinematics as jax_fk
from mjrl_tpu.physics.mjcf import load_mjcf as jax_load_mjcf
from mjrl_tpu.physics.model import State as JState
from mjrl_tpu.physics.step import qacc_smooth as jax_qacc_smooth
from mjrl_tpu_torch.envs import assets as tassets
from mjrl_tpu_torch.physics import dynamics as dyn
from mjrl_tpu_torch.physics.collision import find_contacts
from mjrl_tpu_torch.physics.kinematics import fwd_kinematics
from mjrl_tpu_torch.physics.mjcf import load_mjcf
from mjrl_tpu_torch.physics.model import State
from mjrl_tpu_torch.physics.step import qacc_smooth, step_n

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
REL = 1e-10
N = 12


def _golden(name):
    return np.load(os.path.join(GOLDEN, f"{name}.npz"), allow_pickle=True)


def _ball_xml(colliding=False):
    xml = str(_golden("ball")["xml"])
    return xml if colliding else xml.replace(
        "<geom ", '<geom contype="0" conaffinity="0" ')


_SPRUNG = """<mujoco><option timestep="0.002"/><worldbody>
  <body pos="0 0 1"><joint type="ball" stiffness="2.5" damping="0.1"/>
    <geom type="capsule" fromto="0 0 0 0.3 0.1 -0.2" size="0.04"/>
    <body pos="0.3 0.1 -0.2"><joint type="hinge" axis="0 1 0"
      stiffness="1.5" springref="0.2"/>
      <geom type="sphere" size="0.05" pos="0.1 0 0"/></body></body>
  </worldbody></mujoco>"""


def _no_contacts(builder):
    """A model builder with its geoms made non-colliding (the swimmer's
    capsule-capsule pairs are ROADMAP.md M9's narrowphase)."""
    for g in builder.geoms:
        g["contype"] = g["conaffinity"] = 0
    return builder


def _quats(rng, n, k):
    q = rng.normal(size=(n, k, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(n, 4 * k)


MODELS = {
    "point_mass": (lambda: jassets.point_mass_model().finalize(jnp.float64),
                   lambda: tassets.point_mass_model(solver="penalty"),
                   lambda rng: rng.uniform(-1.5, 1.5, (N, 2))),
    "reacher": (lambda: jassets.reacher_model().finalize(jnp.float64),
                lambda: tassets.reacher_model(solver="penalty"),
                lambda rng: rng.uniform(-2.4, 1.8, (N, 7))),
    "swimmer_penalty": (lambda: _no_contacts(jassets.swimmer_model()
                                             ).finalize(jnp.float64),
                        lambda: _no_contacts(tassets.swimmer_model()
                                             ).finalize(solver="penalty"),
                        lambda rng: rng.uniform(-1.7, 1.7, (N, 7))),
    "ball": (lambda: jax_load_mjcf(xml_string=_ball_xml()).finalize(
        jnp.float64), lambda: load_mjcf(xml_string=_ball_xml()).finalize(),
        lambda rng: _golden("ball")["qpos"][:N]),
    "sprung_ball": (lambda: jax_load_mjcf(xml_string=_SPRUNG).finalize(
        jnp.float64), lambda: load_mjcf(xml_string=_SPRUNG).finalize(),
        lambda rng: np.concatenate([_quats(rng, N, 1),
                                    rng.uniform(-1, 1, (N, 1))], -1)),
}


def _jax_terms(jm, q, v, u):
    d = jax_fk(jm, q)
    cdof = jdyn.compute_cdof(jm, d)
    cvel, cdd = jdyn.compute_velocities(jm, d, cdof, v)
    m, bias = jdyn.mass_and_bias(jm, d, cdof, cvel, cdd, v)
    passive = jdyn.spring_force(jm, q) + jdyn.damping_force(jm, v) \
        + jdyn.project_body_forces(jm, cdof, jdyn.fluid_force(jm, d, cvel))
    qacc = jax_qacc_smooth(jm, JState(qpos=q, qvel=v), u)
    return dict(M=m, bias=bias, passive=passive, qacc=qacc,
                actuator=jdyn.actuator_force(jm, u, q, v), cvel=cvel,
                cdofdot=cdd)


def _port_terms(tm, q, v, u):
    d = fwd_kinematics(tm, q)
    cdof = dyn.compute_cdof(tm, d)
    cvel, cdd = dyn.compute_velocities(tm, d, cdof, v)
    m, bias = dyn.mass_and_bias(tm, d, cdof, cvel, cdd, v)
    passive = dyn.spring_force(tm, q) + dyn.damping_force(tm, v) \
        + dyn.project_body_forces(tm, cdof, dyn.fluid_force(tm, d, cvel))
    return dict(M=m, bias=bias, passive=passive,
                qacc=qacc_smooth(tm, State(qpos=q, qvel=v), u),
                actuator=dyn.actuator_force(tm, u, q, v), cvel=cvel,
                cdofdot=cdd)


@pytest.fixture(scope="module", params=list(MODELS))
def terms(request):
    jbuild, tbuild, qdraw = MODELS[request.param]
    jm, tm = jbuild(), tbuild()
    rng = np.random.RandomState(21)
    q = np.asarray(qdraw(rng), np.float64)
    v = rng.uniform(-3, 3, (N, tm.nv))
    u = rng.uniform(-1.5, 1.5, (N, tm.nu))
    want = jax.jit(jax.vmap(lambda a, b, c: _jax_terms(jm, a, b, c)))(
        jnp.asarray(q), jnp.asarray(v), jnp.asarray(u))
    got = _port_terms(tm, torch.tensor(q), torch.tensor(v), torch.tensor(u))
    return request.param, want, got, (tm, q)


@pytest.mark.parametrize("quantity", ["M", "bias", "passive", "qacc",
                                      "actuator", "cvel", "cdofdot"])
def test_dynamics_match_jax(terms, quantity):
    name, want, got, _ = terms
    w, g = np.asarray(want[quantity]), got[quantity].numpy()
    assert g.shape == w.shape
    scale = max(np.abs(w).max(), 1e-300)
    np.testing.assert_allclose(g, w, rtol=REL, atol=REL * scale,
                               err_msg=f"{name} {quantity}")


def test_reacher_states_touch_the_table():
    """Some of the compared reacher states press the fingertip into the
    table, so the penalty contact force is part of the comparison."""
    _, tbuild, qdraw = MODELS["reacher"]
    tm = tbuild()
    q = torch.tensor(qdraw(np.random.RandomState(21)))
    depths = find_contacts(tm, fwd_kinematics(tm, q))[0]
    assert (depths > 0).any() and (depths <= 0).any()


@pytest.mark.parametrize("name", ["point_mass", "reacher"])
def test_golden_forces_and_qacc(name):
    """MuJoCo's qM, qfrc_bias, qfrc_passive (JAX tests: rtol 1e-5, atol
    1e-8) and qacc on the constraint-free states (rtol 1e-5, atol 1e-6 of
    the scale)."""
    g = _golden(name)
    tm = MODELS[name][1]()
    q, v = torch.tensor(g["qpos"][:20]), torch.tensor(g["qvel"][:20])
    u = torch.tensor(g["ctrl"][:20])
    got = _port_terms(tm, q, v, u)
    for k, gk in (("M", "qM"), ("bias", "qfrc_bias"),
                  ("passive", "qfrc_passive"),
                  ("actuator", "qfrc_actuator")):
        np.testing.assert_allclose(got[k].numpy(), g[gk][:20], rtol=1e-5,
                                   atol=1e-8, err_msg=f"{name} {k}")
    clean = np.where((g["nefc"][:20] == 0) & (g["ncon"][:20] == 0))[0]
    assert len(clean)
    for i in clean:
        scale = max(np.abs(g["qacc"][i]).max(), 1.0)
        np.testing.assert_allclose(got["qacc"][i].numpy(), g["qacc"][i],
                                   rtol=1e-5, atol=1e-6 * scale)


def test_ball_golden_contacts_inactive():
    """The JAX package's capsule-box depths on the golden states are all
    negative: dropping the pair leaves the penalty dynamics unchanged."""
    jm = jax_load_mjcf(xml_string=_ball_xml(colliding=True)).finalize(
        jnp.float64)
    assert len(jm.contact_pairs) == 1
    g = _golden("ball")
    depths = jax.jit(jax.vmap(lambda q: jax_find_contacts(
        jm, jax_fk(jm, q))[0]))(jnp.asarray(g["qpos"]))
    assert float(jnp.max(depths)) < 0.0


def test_ball_golden():
    """ball.npz at the JAX test's tolerances: qM 1e-10, bias 1e-9, qacc
    1e-7, one 5-substep transition 1e-10 / 1e-9."""
    g = _golden("ball")
    tm = MODELS["ball"][1]()
    q, v = torch.tensor(g["qpos"]), torch.tensor(g["qvel"])
    u = torch.zeros((q.shape[0], 0), dtype=torch.float64)
    got = _port_terms(tm, q, v, u)
    np.testing.assert_allclose(got["M"].numpy(), g["qM"], atol=1e-10)
    np.testing.assert_allclose(got["bias"].numpy(), g["qfrc_bias"],
                               atol=1e-9)
    np.testing.assert_allclose(got["qacc"].numpy(), g["qacc"], atol=1e-7)
    out = step_n(tm, State(qpos=q, qvel=v), u, 5)
    np.testing.assert_allclose(out.qpos.numpy(), g["next_qpos"], atol=1e-10)
    np.testing.assert_allclose(out.qvel.numpy(), g["next_qvel"], atol=1e-9)


@pytest.mark.parametrize("integ", ["euler", "rk4"])
def test_ball_trajectory_endpoint(integ):
    """The JAX test's endpoints: qpos 1e-8, qvel 1e-7."""
    g = _golden("ball")
    xml = _ball_xml()
    if integ == "rk4":
        xml = xml.replace('integrator="Euler"', 'integrator="RK4"')
    tm = load_mjcf(xml_string=xml).finalize()
    s = State(qpos=torch.tensor(g[f"traj_{integ}_qpos0"])[None],
              qvel=torch.tensor(g[f"traj_{integ}_qvel0"])[None])
    out = step_n(tm, s, torch.zeros((1, 0), dtype=torch.float64),
                 int(g[f"traj_{integ}_steps"]))
    np.testing.assert_allclose(out.qpos[0].numpy(),
                               g[f"traj_{integ}_qpos_end"], atol=1e-8)
    np.testing.assert_allclose(out.qvel[0].numpy(),
                               g[f"traj_{integ}_qvel_end"], atol=1e-7)


def test_freebody_golden_end_state():
    """A free body under gravity, RK4, stepped to the golden end state
    (the JAX test: qpos 1e-10, qvel 1e-9)."""
    g = _golden("freebody")
    tm = load_mjcf(xml_string=str(g["xml"])).finalize()
    s = State(qpos=torch.tensor(g["qpos0"])[None],
              qvel=torch.tensor(g["qvel0"])[None])
    out = step_n(tm, s, torch.zeros((1, 0), dtype=torch.float64),
                 int(g["steps"]))
    np.testing.assert_allclose(out.qpos[0].numpy(), g["qpos_end"],
                               atol=1e-10)
    np.testing.assert_allclose(out.qvel[0].numpy(), g["qvel_end"],
                               atol=1e-9)
