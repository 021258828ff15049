"""Programmatic model definitions for the mjrl environment suite
(counterpart of ``mjrl_tpu/envs/assets.py``; the swimmer only so far).

Each function builds the same physical system as the corresponding mjrl
MJCF asset via the ModelBuilder — no MJCF files are shipped.
"""

import numpy as np

from mjrl_tpu_torch.physics.model import ModelBuilder


def swimmer_model(solver=None):
    """Swimmer: planar 5-link chain in viscous fluid, Euler dt 0.005
    (assets/swimmer.xml: viscosity 0.000894, density 1000).  Returns the
    ModelBuilder, or the finalized Model when ``solver`` is given."""
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
    return b if solver is None else b.finalize(solver=solver)
