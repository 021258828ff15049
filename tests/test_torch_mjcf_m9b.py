"""Port vs JAX package: MJCF parsing and model building of the rest of the
general engine (CPU, float64).

The scenes of the JAX tests (``tests/test_equality.py``,
``test_actuators.py``, ``test_condim4.py``, ``test_solver_extras.py``) and
a few of this file's own, parsed by both packages' ``load_mjcf`` and
finalized by both ``ModelBuilder``s: every ``Model`` field equal (numeric
tables at 1e-12, the inverse weights at 1e-9).  They cover <contact>
<pair> (with and without its own condim, declared twice, against a
dynamic pair) and <exclude>, <equality> joint (coupling and pin), connect
and weld (an explicit relpose and one taken at qpos0), <general> with
biastype affine, <position>, <velocity>, vector gears on ball and free
joints, tendon transmissions and <option cone noslip_iterations>.  A
collidable mesh still raises, with the JAX package's wording.

The other M9b test files import their scenes and helpers from here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.physics.mjcf import load_mjcf as jax_load_mjcf
from mjrl_tpu.physics.model import State as JState
from mjrl_tpu.physics.step import qacc_smooth as jax_qacc_smooth
from mjrl_tpu_torch.physics import model as tmodel
from mjrl_tpu_torch.physics.mjcf import load_mjcf
from mjrl_tpu_torch.physics.model import State
from mjrl_tpu_torch.physics.step import qacc_smooth

TOL = 1e-9
FIELDS = [f.name for f in dataclasses.fields(tmodel.Model)]
INVW = ("dof_invweight0", "body_invweight0", "ten_invweight0")

CONDIM_XML = """
<mujoco>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <geom name="floor" type="plane" size="1 1 0.1" friction="1 0.01 0.0001"/>
    <body name="ball" pos="0 0 0.034">
      <joint name="tx" type="slide" axis="1 0 0"/>
      <joint name="ty" type="slide" axis="0 1 0"/>
      <joint name="tz" type="slide" axis="0 0 1"/>
      <joint name="rx" type="hinge" axis="1 0 0"/>
      <joint name="ry" type="hinge" axis="0 1 0"/>
      <joint name="rz" type="hinge" axis="0 0 1"/>
      <geom name="sphere" type="sphere" size="0.035" condim="{condim}"
            friction="1 0.005 0.0001"/>
    </body>
  </worldbody>
</mujoco>"""

EQ_XML = """
<mujoco>
  <compiler angle="radian" inertiafromgeom="true"/>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="A" pos="0 0 1">
      <joint name="ja" type="hinge" axis="0 1 0" damping="0.2"/>
      <geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.04"
            contype="0" conaffinity="0"/>
      <body name="B" pos="0.4 0 0">
        <joint name="jb" type="hinge" axis="0 1 0" damping="0.1"/>
        <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"
              contype="0" conaffinity="0"/>
      </body>
    </body>
    <body name="C" pos="0.7 0 1">
      <joint name="jc" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.03"
            contype="0" conaffinity="0"/>
    </body>
  </worldbody>
  <equality>
    <joint joint1="ja" joint2="jb" polycoef="0.1 0.5 0.2 0 0"/>
    <connect body1="B" body2="C" anchor="0.3 0 0"/>
  </equality>
  <actuator>
    <motor joint="ja" gear="1"/>
    <motor joint="jc" gear="1"/>
  </actuator>
</mujoco>
"""

PIN_XML = """
<mujoco>
  <compiler angle="radian" inertiafromgeom="true"/>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="A" pos="0 0 1">
      <joint name="ja" type="hinge" axis="0 1 0" damping="0.2"/>
      <geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.04"
            contype="0" conaffinity="0"/>
    </body>
  </worldbody>
  <equality>
    <joint joint1="ja" polycoef="0.25" solref="0.03 0.9"/>
  </equality>
</mujoco>
"""

WELD_XML = """
<mujoco>
  <compiler angle="radian" inertiafromgeom="true"/>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="A" pos="0 0 1">
      <joint name="fa" type="free"/>
      <geom type="box" size="0.1 0.08 0.06" contype="0" conaffinity="0"/>
    </body>
    <body name="B" pos="0.5 0 1" euler="0 0 0.3">
      <joint name="fb" type="free"/>
      <geom type="box" size="0.1 0.08 0.06" contype="0" conaffinity="0"/>
    </body>
  </worldbody>
  <equality>
    <weld body1="A" body2="B" anchor="0.2 0 0" torquescale="0.7"/>
    <weld body1="B" relpose="0 0 -1 0.9 0.1 0 0" solimp="0.8 0.9 0.01"
          active="false"/>
  </equality>
</mujoco>
"""

SERVO_XML = """
<mujoco>
  <compiler angle="radian" inertiafromgeom="true"/>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="arm" pos="0 0 1">
      <joint name="shoulder" type="hinge" axis="0 1 0" damping="0.3"/>
      <geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.04"
            contype="0" conaffinity="0"/>
      <body name="slider" pos="0.4 0 0">
        <joint name="ext" type="slide" axis="1 0 0" damping="0.1"/>
        <geom type="sphere" size="0.05" contype="0" conaffinity="0"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <position joint="shoulder" kp="50" kv="3" gear="2"/>
    <velocity joint="ext" kv="10"/>
    <general joint="ext" ctrlrange="-0.5 0.5" ctrllimited="true"
             biastype="affine" gainprm="40 0 0" biasprm="0.5 -30 -2"/>
  </actuator>
</mujoco>
"""

BALL_XML = """
<mujoco>
  <compiler angle="radian" inertiafromgeom="true"/>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="pend" pos="0 0 1">
      <joint name="b" type="ball" damping="0.2" stiffness="5"/>
      <geom type="capsule" fromto="0 0 0 0 0 -0.3" size="0.04"
            contype="0" conaffinity="0"/>
    </body>
    <body name="free" pos="1 0 1">
      <joint name="f" type="free"/>
      <geom type="box" size="0.1 0.06 0.04" contype="0" conaffinity="0"/>
    </body>
  </worldbody>
  <actuator>
    <motor joint="b" gear="1 0.5 0.25" ctrlrange="-2 2" ctrllimited="true"/>
    <general joint="b" gear="0.3 -0.2 0.6" biastype="affine"
             gainprm="4 0 0" biasprm="0.1 -3 -0.5"/>
    <motor joint="f" gear="0.5 -0.3 2 0.1 0.2 -0.4"/>
    <velocity joint="f" kv="2" gear="0 0 1 0 0 0.3"/>
  </actuator>
</mujoco>
"""

TENDON_XML = """
<mujoco>
  <compiler angle="radian" inertiafromgeom="true"/>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="a" pos="0 0 1">
      <joint name="j0" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"
            contype="0" conaffinity="0"/>
      <body name="b" pos="0.3 0 0">
        <joint name="j1" type="hinge" axis="0 1 0" damping="0.1"/>
        <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"
              contype="0" conaffinity="0"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="t0" range="-0.4 0.4">
      <joint joint="j0" coef="1"/>
      <joint joint="j1" coef="-0.5"/>
    </fixed>
  </tendon>
  <actuator>
    <motor tendon="t0" gear="3"/>
    <position tendon="t0" kp="20" kv="1" ctrlrange="-1 1" ctrllimited="true"/>
  </actuator>
</mujoco>
"""

PAIR_XML = """
<mujoco>
  <option timestep="0.002" gravity="0 0 -9.81" cone="{cone}"
          noslip_iterations="{ns}"/>
  <worldbody>
    <geom name="floor" type="plane" size="2 2 0.1"/>
    <body name="a" pos="0 0 0.1">
      <joint type="slide" axis="0 0 1"/>
      <joint type="hinge" axis="0 1 0"/>
      <geom name="ga" type="sphere" size="0.1" condim="4"/>
      <geom name="ga2" type="capsule" fromto="0 0 0 0.2 0 0" size="0.03"
            contype="0" conaffinity="0"/>
    </body>
    <body name="b" pos="0.15 0 0.1">
      <joint type="slide" axis="1 0 0"/>
      <joint type="slide" axis="0 0 1"/>
      <geom name="gb" type="sphere" size="0.08" condim="6"/>
    </body>
    <body name="c" pos="-0.2 0 0.1">
      <joint type="slide" axis="1 0 0"/>
      <geom name="gc" type="box" size="0.05 0.05 0.05" contype="0"
            conaffinity="0"/>
    </body>
  </worldbody>
  <contact>
    <exclude body1="a" body2="b"/>
    <pair geom1="ga" geom2="gb" condim="3"/>
    <pair geom1="gc" geom2="floor"/>
    <pair geom1="ga2" geom2="gc" condim="1"/>
    <pair geom1="gc" geom2="ga2" condim="1"/>
    <pair geom1="floor" geom2="gb" condim="1"/>
  </contact>
</mujoco>
"""

INCLINE = """
<mujoco><option timestep="0.002" gravity="0 0 -9.81"
        noslip_iterations="{ns}"/>
<worldbody>
  <geom type="plane" size="2 2 0.1" euler="0 15 0" friction="1 0.005 0.0001"/>
  <body pos="0 0 0.12">
    <joint type="slide" axis="1 0 0"/><joint type="slide" axis="0 1 0"/>
    <joint type="slide" axis="0 0 1"/>
    {hinge}
    <geom type="sphere" size="0.05" condim="3" friction="1 0.005 0.0001"/>
  </body>
</worldbody></mujoco>"""
HINGE = '<joint type="hinge" axis="0 1 0"/>'

SCENES = {
    "condim4": CONDIM_XML.format(condim=4),
    "condim6": CONDIM_XML.format(condim=6),
    "equality": EQ_XML,
    "pin": PIN_XML,
    "weld": WELD_XML,
    "servo": SERVO_XML,
    "ball_free_gears": BALL_XML,
    "tendon_transmission": TENDON_XML,
    "pair_exclude": PAIR_XML.format(cone="pyramidal", ns=0),
    "pair_elliptic_noslip": PAIR_XML.format(cone="elliptic", ns=7),
    "incline_noslip": INCLINE.format(ns=20, hinge=HINGE),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a module's torch operations on one thread.  The eager engine
    issues tens of thousands of small operations a step; torch's thread
    pool buys nothing there, and under the suite's parallel workers it
    oversubscribes the host (test_torch_dapg_relocate.py took 478 s in a
    6-worker run of the suite on an 8-core CPU, 9 s alone on one
    thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_both(xml, **kw):
    """The same MJCF through both packages -> (JAX Model, port Model),
    float64."""
    return (jax_load_mjcf(xml_string=xml).finalize(jnp.float64, **kw),
            load_mjcf(xml_string=xml).finalize(**kw))


def qacc_both(jm, tm, q, v, u=None):
    """qacc_smooth of a batch in both packages -> (JAX, port) numpy."""
    u = np.zeros((len(q), tm.nu)) if u is None else u
    acc = jax.jit(jax.vmap(lambda qq, vv, uu: jax_qacc_smooth(
        jm, JState(qpos=qq, qvel=vv), uu)))
    a = np.asarray(acc(jnp.asarray(q), jnp.asarray(v), jnp.asarray(u)))
    b = qacc_smooth(tm, State(qpos=torch.tensor(q), qvel=torch.tensor(v)),
                    torch.tensor(u)).numpy()
    return a, b


def assert_rel(got, want, tol=TOL, what=""):
    """Every row of ``got`` within ``tol`` of ``want`` relative to the
    row's largest entry (at least 1)."""
    scale = np.maximum(np.abs(want).max(-1, keepdims=True), 1.0)
    err = np.abs(got - want) / scale
    assert err.max() < tol, (what, err.max())


def random_states(tm, n, seed, spread=0.3):
    """n states near qpos0: scalar joints and positions moved by
    U(-spread, spread), quaternions tilted and renormalized; qvel
    U(-1, 1)."""
    rng = np.random.RandomState(seed)
    q = np.tile(tm.qpos0, (n, 1)) + rng.uniform(-spread, spread,
                                                (n, tm.nq))
    for j, jt in enumerate(tm.jnt_type):
        qa = tm.jnt_qposadr[j] + (3 if jt == tmodel.FREE else 0)
        if jt in (tmodel.FREE, tmodel.BALL):
            quat = q[:, qa:qa + 4] + np.array([1.0, 0, 0, 0])
            q[:, qa:qa + 4] = quat / np.linalg.norm(quat, axis=1,
                                                    keepdims=True)
    return q, rng.uniform(-1.0, 1.0, (n, tm.nv)), \
        rng.uniform(-1.0, 1.0, (n, tm.nu))


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("solver", ["penalty", "newton"])
def test_scene_models_match_jax_field_by_field(scene, solver):
    jm, tm = build_both(SCENES[scene], solver=solver)
    for f in FIELDS:
        a, b = getattr(jm, f), getattr(tm, f)
        if isinstance(b, np.ndarray):
            tol = 1e-9 if f in INVW else 1e-12
            np.testing.assert_allclose(b, np.asarray(a, np.float64),
                                       rtol=tol, atol=tol,
                                       err_msg=f"{scene} {f}")
        else:
            assert a == b, (scene, f, a, b)


def test_pairs_excludes_and_condims():
    """What the pair filter keeps: the excluded body pair's dynamic pair
    is gone but its explicit pair stays with its own condim; a pair
    declared twice is kept once; a pair without condim takes the geoms'
    max; the explicit condim beats the dynamic pair's."""
    _, tm = build_both(SCENES["pair_exclude"])
    names = load_mjcf(xml_string=SCENES["pair_exclude"])
    names.finalize()
    g = names.names["geom"]
    pairs = dict(zip(tm.contact_pairs, tm.contact_pair_condim))
    key = lambda a, b: tuple(sorted((g[a], g[b])))
    assert pairs[key("ga", "gb")] == 3
    assert pairs[key("gc", "floor")] == 3
    assert pairs[key("ga2", "gc")] == 1
    assert pairs[key("floor", "gb")] == 1
    assert pairs[key("floor", "ga")] == 4
    assert len(tm.contact_pairs) == len(set(tm.contact_pairs)) == 5


def test_general_and_servo_tables():
    """<general> biastype affine: gain gainprm[0], bias biasprm[:3];
    <position>: (kp, (0, -kp, -kv)); <velocity>: (kv, (0, 0, -kv))."""
    _, tm = build_both(SERVO_XML)
    np.testing.assert_array_equal(tm.actuator_gain, [50.0, 10.0, 40.0])
    np.testing.assert_array_equal(
        tm.actuator_bias, [[0, -50, -3], [0, 0, -10], [0.5, -30, -2]])
    assert not tm.actuator_simple
    _, tb = build_both(BALL_XML)
    np.testing.assert_array_equal(tb.actuator_gearv[0],
                                  [1, 0.5, 0.25, 0, 0, 0])
    np.testing.assert_array_equal(tb.actuator_gearv[2],
                                  [0.5, -0.3, 2, 0.1, 0.2, -0.4])
    _, tt = build_both(TENDON_XML)
    assert tt.actuator_tendon == (0, 0) and tt.actuator_joint == (-1, -1)


def test_collidable_mesh_still_raises_with_the_jax_wording():
    xml = ('<mujoco><asset><mesh name="m" vertex="0 0 0 1 0 0 0 1 0 0 0 1"/>'
           '</asset><worldbody><body><joint type="hinge"/>'
           '<geom type="mesh" mesh="m"/></body></worldbody></mujoco>')
    for load in (jax_load_mjcf, load_mjcf):
        with pytest.raises(NotImplementedError,
                           match="collidable mesh geoms are not supported"
                           ) as e:
            load(xml_string=xml)
        assert "M9" not in str(e.value)
