"""Programmatic model definitions for the mjrl environment suite
(counterpart of ``mjrl_tpu/envs/assets.py``: point mass, swimmer, the
7-DoF reacher and peg insertion).

Each function builds the same physical system as the corresponding mjrl
MJCF asset via the ModelBuilder — no MJCF files are shipped.
"""

import numpy as np

from mjrl_tpu_torch.physics.model import ModelBuilder


def point_mass_model(solver=None, dtype=np.float64):
    """PointMass: 2 slide joints, gravity 0, RK4 dt 0.01
    (assets/point_mass.xml).  Returns the ModelBuilder, or the finalized
    Model when ``solver`` is given, its constants rounded to ``dtype``.

    Defaults: joint armature 0.01, damping 0.1, limited; geom contype 0,
    friction (1, .1, .1); motor ctrlrange [-1, 1].
    """
    b = ModelBuilder(timestep=0.01, gravity=(0, 0, 0), integrator="rk4")
    # arena (world geoms; no active contacts: agent is contype/conaff 1 but
    # all world geoms have conaffinity 0)
    b.add_geom(0, "plane", size=(1.5, 1.5, 0.05), pos=(0, 0, 0),
               contype=0, conaffinity=0, friction=(1, 0.1, 0.1), name="ground")
    for name, fromto in [
            ("sideS", (-1.5, -1.5, .02, 1.5, -1.5, .02)),
            ("sideE", (1.5, -1.5, .02, 1.5, 1.5, .02)),
            ("sideN", (-1.5, 1.5, .02, 1.5, 1.5, .02)),
            ("sideW", (-1.5, -1.5, .02, -1.5, 1.5, .02))]:
        b.add_geom(0, "capsule", size=(0.04,), fromto=fromto, mass=0.1,
                   contype=0, conaffinity=0, friction=(1, 0.1, 0.1), name=name)
    agent = b.add_body(0, pos=(0, 0, 0.05), name="agent")
    jx = b.add_joint(agent, "slide", axis=(1, 0, 0), jnt_range=(-1.4, 1.4),
                     damping=0.1, armature=0.01, name="agent_x")
    jy = b.add_joint(agent, "slide", axis=(0, 1, 0), jnt_range=(-1.4, 1.4),
                     damping=0.1, armature=0.01, name="agent_y")
    b.add_geom(agent, "sphere", size=(0.05,), contype=1, conaffinity=1,
               friction=(1, 0.1, 0.1), name="agent")
    b.add_site(0, pos=(1.0, 0, 0.05), name="target")
    b.add_actuator(jx, gear=10.0, ctrlrange=(-1, 1))
    b.add_actuator(jy, gear=10.0, ctrlrange=(-1, 1))
    return b if solver is None else b.finalize(solver=solver, dtype=dtype)


def swimmer_model(solver=None, dtype=np.float64):
    """Swimmer: planar 5-link chain in viscous fluid, Euler dt 0.005
    (assets/swimmer.xml: viscosity 0.000894, density 1000).  Returns the
    ModelBuilder, or the finalized Model when ``solver`` is given, its
    constants rounded to ``dtype`` (``ModelBuilder.finalize``)."""
    b = ModelBuilder(timestep=0.005, gravity=(0, 0, -9.81),
                     integrator="euler", viscosity=0.000894, density=1000.0)
    b.add_geom(0, "plane", size=(10, 10, 1), contype=0, conaffinity=0,
               name="ground")
    # capsule quat in the XML is (0.707, 0, -0.707, 0) — MuJoCo normalizes
    cquat = np.array([0.707, 0.0, -0.707, 0.0])
    cquat = cquat / np.linalg.norm(cquat)

    torso = b.add_body(0, pos=(0, 0, 0.03), name="torso")
    b.add_site(torso, pos=(-.065, -.045, .02), name="eyeL")
    b.add_site(torso, pos=(-.065, 0.045, .02), name="eyer")
    b.add_site(torso, pos=(0, 0, 0), name="head")
    b.add_joint(torso, "slide", axis=(1, 0, 0), limited=False)
    b.add_joint(torso, "slide", axis=(0, 1, 0), limited=False)
    b.add_joint(torso, "hinge", axis=(0, 0, 1), limited=False)
    b.add_geom(torso, "capsule", size=(0.07, 0.15), pos=(0.15, 0, 0),
               quat=cquat)

    parent = torso
    jids = []
    for i, radius in enumerate([0.065, 0.06, 0.055, 0.05]):
        body = b.add_body(parent, pos=(0.3, 0, 0), name=f"link{i+1}")
        jids.append(b.add_joint(body, "hinge", axis=(0, 0, 1),
                                jnt_range=(-1.5, 1.5), name=f"j{i+1}"))
        b.add_geom(body, "capsule", size=(radius, 0.15), pos=(0.15, 0, 0),
                   quat=cquat)
        parent = body

    b.add_site(0, pos=(-5, 0, 0.15), name="target")
    for j in jids:
        b.add_actuator(j, gear=20.0, ctrlrange=(-1, 1))
    return b if solver is None else b.finalize(solver=solver, dtype=dtype)


def reacher_model(solver=None, dtype=np.float64):
    """Sawyer-style 7-DoF reacher, gravity 0, Euler dt 0.01
    (assets/sawyer.xml).  Defaults: armature 0.004, damping 0.8, limited;
    geom friction (.5, .1, .1), margin 0.002, contype/conaffinity 0 (the
    table plane and the fingertip sphere collide: one frictionless
    contact pair).  Returns the ModelBuilder, or the finalized Model when
    ``solver`` is given."""
    b = ModelBuilder(timestep=0.01, gravity=(0, 0, 0), integrator="euler")
    gdef = dict(contype=0, conaffinity=0, friction=(.5, .1, .1),
                margin=0.002, condim=1)
    b.add_geom(0, "plane", size=(1, 1, 0.1), pos=(0, 0.5, -0.425),
               contype=1, conaffinity=1, friction=(.5, .1, .1), margin=0.002,
               condim=1, name="table")
    b.add_site(0, pos=(0.1, 0.1, 0.1), name="target")

    jdef = dict(armature=0.004)

    b0 = b.add_body(0, pos=(0, -0.6, 0), name="r_shoulder_pan_link")
    b.add_geom(b0, "sphere", size=(0.05,), pos=(-0.06, 0.05, 0.2), **gdef)
    b.add_geom(b0, "sphere", size=(0.05,), pos=(0.06, 0.05, 0.2), **gdef)
    b.add_geom(b0, "sphere", size=(0.03,), pos=(-0.06, 0.09, 0.2), **gdef)
    b.add_geom(b0, "sphere", size=(0.03,), pos=(0.06, 0.09, 0.2), **gdef)
    b.add_geom(b0, "capsule", size=(0.1,), fromto=(0, 0, -0.4, 0, 0, 0.2),
               **gdef)
    j0 = b.add_joint(b0, "hinge", axis=(0, 0, 1),
                     jnt_range=(-2.2854, 1.714602), damping=2.0, **jdef)

    b1 = b.add_body(b0, pos=(0.1, 0, 0), name="r_shoulder_lift_link")
    b.add_geom(b1, "capsule", size=(0.1,), fromto=(0, -0.1, 0, 0, 0.1, 0),
               **gdef)
    j1 = b.add_joint(b1, "hinge", axis=(0, 1, 0),
                     jnt_range=(-0.5236, 1.3963), damping=2.0, **jdef)

    b2 = b.add_body(b1, pos=(0, 0, 0), name="r_upper_arm_roll_link")
    b.add_geom(b2, "capsule", size=(0.02,), fromto=(-0.1, 0, 0, 0.1, 0, 0),
               **gdef)
    j2 = b.add_joint(b2, "hinge", axis=(1, 0, 0), jnt_range=(-1.5, 1.7),
                     damping=0.8, **jdef)

    b3 = b.add_body(b2, pos=(0, 0, 0), name="r_upper_arm_link")
    b.add_geom(b3, "capsule", size=(0.06,), fromto=(0, 0, 0, 0.4, 0, 0),
               **gdef)

    b4 = b.add_body(b3, pos=(0.4, 0, 0), name="r_elbow_flex_link")
    b.add_geom(b4, "capsule", size=(0.06,), fromto=(0, -0.02, 0, 0, 0.02, 0),
               **gdef)
    j4 = b.add_joint(b4, "hinge", axis=(0, 1, 0), jnt_range=(-2.3213, 0),
                     damping=0.8, **jdef)

    b5 = b.add_body(b4, pos=(0, 0, 0), name="r_forearm_roll_link")
    b.add_geom(b5, "capsule", size=(0.02,), fromto=(-0.1, 0, 0, 0.1, 0, 0),
               **gdef)
    j5 = b.add_joint(b5, "hinge", axis=(1, 0, 0), jnt_range=(-1.5, 1.5),
                     damping=0.8, limited=True, **jdef)

    b6 = b.add_body(b5, pos=(0, 0, 0), name="r_forearm_link")
    b.add_geom(b6, "capsule", size=(0.05,), fromto=(0, 0, 0, 0.291, 0, 0),
               **gdef)

    b7 = b.add_body(b6, pos=(0.321, 0, 0), name="r_wrist_flex_link")
    b.add_geom(b7, "capsule", size=(0.01,), fromto=(0, -0.02, 0, 0, 0.02, 0),
               **gdef)
    j7 = b.add_joint(b7, "hinge", axis=(0, 1, 0), jnt_range=(-1.094, 0),
                     damping=0.8, **jdef)

    b8 = b.add_body(b7, pos=(0, 0, 0), name="r_wrist_roll_link")
    j8 = b.add_joint(b8, "hinge", axis=(1, 0, 0), jnt_range=(-1.5, 1.5),
                     damping=0.8, limited=True, **jdef)
    b.add_geom(b8, "sphere", size=(0.08,), pos=(0.03, 0, 0), contype=1,
               conaffinity=1, friction=(.5, .1, .1), margin=0.002, condim=1)
    b.add_site(b8, pos=(0, 0, 0), name="finger")

    for j, gear in [(j0, 20), (j1, 10), (j2, 10), (j4, 10), (j5, 10),
                    (j7, 10), (j8, 10)]:
        b.add_actuator(j, gear=gear, ctrlrange=(-1, 1))
    return b if solver is None else b.finalize(solver=solver, dtype=dtype)


def _axisangle_quat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([[np.cos(angle / 2)], axis * np.sin(angle / 2)])


def peg_insertion_model(solver=None, dtype=np.float64, **finalize):
    """7-DoF arm + peg cylinder + table/hole boxes, RK4 dt 0.01, gravity 0
    (assets/peg_insertion.xml).  Returns the ModelBuilder, or the
    finalized Model when ``solver`` is given, its constants rounded to
    ``dtype`` (further ``finalize`` keywords pass through).  Defaults:
    armature 0.04, damping 1, limited; geom friction (.5, .1, .1), margin
    0.002, contype 0, conaffinity 1, condim 1."""
    b = ModelBuilder(timestep=0.01, gravity=(0, 0, 0), integrator="rk4")
    gdef = dict(contype=0, conaffinity=1, friction=(.5, .1, .1),
                margin=0.002, condim=1)
    jdef = dict(armature=0.04)

    b0 = b.add_body(0, pos=(0, -0.188, 0), name="r_shoulder_pan_link")
    b.add_geom(b0, "sphere", size=(0.05,), pos=(-0.06, 0.05, 0.2), **gdef)
    b.add_geom(b0, "sphere", size=(0.05,), pos=(0.06, 0.05, 0.2), **gdef)
    b.add_geom(b0, "sphere", size=(0.03,), pos=(-0.06, 0.09, 0.2), **gdef)
    b.add_geom(b0, "sphere", size=(0.03,), pos=(0.06, 0.09, 0.2), **gdef)
    b.add_geom(b0, "capsule", size=(0.1,), fromto=(0, 0, -0.4, 0, 0, 0.2),
               **gdef)
    j0 = b.add_joint(b0, "hinge", axis=(0, 0, 1),
                     jnt_range=(-2.2854, 1.714602), damping=10.0, **jdef)

    b1 = b.add_body(b0, pos=(0.1, 0, 0), name="r_shoulder_lift_link")
    b.add_geom(b1, "capsule", size=(0.1,), fromto=(0, -0.1, 0, 0, 0.1, 0),
               **gdef)
    j1 = b.add_joint(b1, "hinge", axis=(0, 1, 0),
                     jnt_range=(-0.5236, 1.3963), damping=10.0, **jdef)

    b2 = b.add_body(b1, pos=(0, 0, 0), name="r_upper_arm_roll_link")
    b.add_geom(b2, "capsule", size=(0.02,), fromto=(-0.1, 0, 0, 0.1, 0, 0),
               **gdef)
    j2 = b.add_joint(b2, "hinge", axis=(1, 0, 0), jnt_range=(-3.9, 0.8),
                     damping=0.1, **jdef)

    b3 = b.add_body(b2, pos=(0, 0, 0), name="r_upper_arm_link")
    b.add_geom(b3, "capsule", size=(0.06,), fromto=(0, 0, 0, 0.4, 0, 0),
               **gdef)

    b4 = b.add_body(b3, pos=(0.4, 0, 0), name="r_elbow_flex_link")
    b.add_geom(b4, "capsule", size=(0.06,), fromto=(0, -0.02, 0, 0, 0.02, 0),
               **gdef)
    j4 = b.add_joint(b4, "hinge", axis=(0, 1, 0), jnt_range=(-2.3213, 0),
                     damping=1.0, **jdef)

    b5 = b.add_body(b4, pos=(0, 0, 0), name="r_forearm_roll_link")
    b.add_geom(b5, "capsule", size=(0.02,), fromto=(-0.1, 0, 0, 0.1, 0, 0),
               **gdef)
    j5 = b.add_joint(b5, "hinge", axis=(1, 0, 0), damping=0.1, limited=False,
                     **jdef)

    b6 = b.add_body(b5, pos=(0, 0, 0), name="r_forearm_link")
    b.add_geom(b6, "capsule", size=(0.05,), fromto=(0, 0, 0, 0.321, 0, 0),
               **gdef)

    b7 = b.add_body(b6, pos=(0.321, 0, 0), name="r_wrist_flex_link")
    b.add_geom(b7, "capsule", size=(0.01,), fromto=(0, -0.02, 0, 0, 0.02, 0),
               **gdef)
    j7 = b.add_joint(b7, "hinge", axis=(0, 1, 0), jnt_range=(-2.094, 0),
                     damping=0.1, **jdef)

    b8 = b.add_body(b7, pos=(0, 0, 0), name="r_wrist_roll_link")
    b.add_geom(b8, "capsule", size=(0.01,), fromto=(-0.02, 0, 0, 0.02, 0, 0),
               **gdef)
    j8 = b.add_joint(b8, "hinge", axis=(1, 0, 0), damping=0.1, limited=False,
                     **jdef)

    palm = b.add_body(b8, pos=(0, 0, 0), name="r_gripper_palm_link")
    b.add_geom(palm, "capsule", size=(0.05,),
               fromto=(0.05, 0, -0.02, 0.05, 0, 0.02), **gdef)

    tool = b.add_body(palm, pos=(0.18, 0, 0), name="r_gripper_tool_frame")
    b.add_site(tool, pos=(0, 0, -0.15), name="leg_bottom")
    b.add_site(tool, pos=(0, 0, 0.15), name="leg_top")

    peg = b.add_body(tool, pos=(0, 0, 0), name="peg")
    b.add_geom(peg, "cylinder", size=(0.028,),
               fromto=(0, 0, -0.15, 0, 0, 0.15), density=2000,
               contype=2, conaffinity=1, friction=(.5, .1, .1), margin=0.002,
               condim=1, name="peg_geom")
    b.add_site(peg, pos=(0, 0, -0.15), name="peg_bottom")

    lf = b.add_body(palm, pos=(0.07691, 0.03, 0),
                    name="r_gripper_l_finger_link")
    b.add_geom(lf, "capsule", size=(0.01,),
               fromto=(0, 0, 0, 0.09137, 0.00495, 0), **gdef)
    lft = b.add_body(lf, pos=(0.09137, 0.00495, 0),
                     name="r_gripper_l_finger_tip_link")
    b.add_geom(lft, "capsule", size=(0.01,),
               fromto=(0, 0, 0, 0.09137, 0.0, 0), **gdef)

    rf = b.add_body(palm, pos=(0.07691, -0.03, 0),
                    name="r_gripper_r_finger_link")
    b.add_geom(rf, "capsule", size=(0.01,),
               fromto=(0, 0, 0, 0.09137, -0.00495, 0), **gdef)
    rft = b.add_body(rf, pos=(0.09137, -0.00495, 0),
                     name="r_gripper_r_finger_tip_link")
    b.add_geom(rft, "capsule", size=(0.01,),
               fromto=(0, 0, 0, 0.09137, 0.0, 0), **gdef)

    # hole fixture + walls (boxes with contype 1, conaffinity 1)
    gbox = dict(contype=1, conaffinity=1, friction=(.5, .1, .1),
                margin=0.002, condim=1)
    g4 = b.add_body(0, pos=(0.0, 0.266, -0.47),
                    quat=_axisangle_quat((1, 0, 0), 0.05), name="g4")
    b.add_geom(g4, "box", size=(0.01, 0.003, 0.05), **gbox)
    fl = b.add_body(0, pos=(0.0, 0.3, -0.55), name="fl")
    b.add_geom(fl, "box", size=(0.2, 0.2, 0.05), **gbox)
    w1 = b.add_body(0, pos=(0.216, 0.3, -0.45), name="w1")
    b.add_geom(w1, "box", size=(0.183, 0.3, 0.05), **gbox)
    w2 = b.add_body(0, pos=(-0.216, 0.3, -0.45), name="w2")
    b.add_geom(w2, "box", size=(0.183, 0.3, 0.05), **gbox)
    w3 = b.add_body(0, pos=(0.0, 0.516, -0.45), name="w3")
    b.add_geom(w3, "box", size=(0.032, 0.183, 0.05), **gbox)
    w4 = b.add_body(0, pos=(0.0, 0.084, -0.45), name="w4")
    b.add_geom(w4, "box", size=(0.032, 0.183, 0.05), **gbox)
    target = b.add_body(0, pos=(0.0, 0.29, -0.5), name="target")
    b.add_site(target, pos=(0, 0, 0), name="target")

    for j, gear in [(j0, 20), (j1, 10), (j2, 10), (j4, 10), (j5, 10),
                    (j7, 10), (j8, 10)]:
        b.add_actuator(j, gear=gear, ctrlrange=(-1, 1))
    return b if solver is None else b.finalize(solver=solver, dtype=dtype,
                                               **finalize)
