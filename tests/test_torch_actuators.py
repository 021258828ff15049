"""Port vs JAX package: the affine actuator family (CPU, float64).

f = gain * ctrl + b0 + b1 * length + b2 * velocity through the
transmission, ctrl clipped to ctrlrange where ctrllimited:

- position and velocity servos and a <general> affine actuator on hinge
  and slide joints (``tests/test_actuators.py``'s servo scene plus one);
- vector-gear motors and affine actuators on a ball joint (length = gear .
  rotvec(quaternion)) and on a free joint (no length);
- a motor and a position servo on a fixed tendon (moment = gear x the
  tendon's ten_J row, length = gear x the tendon length).

``actuator_force`` at 1e-9 of the largest entry on random states and
controls beyond the ctrlranges, and ``qacc_smooth`` of each scene (penalty
path) the same way.  The Adroit servo table (30 affine position servos)
is held in ``test_torch_adroit.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.physics import dynamics as jdyn
from mjrl_tpu_torch.physics import dynamics as tdyn

from test_torch_mjcf_m9b import (BALL_XML, SERVO_XML, TENDON_XML, assert_rel,
                                 build_both, qacc_both, random_states)
from test_torch_mjcf_m9b import one_torch_thread  # noqa: F401

SCENES = {"servos": SERVO_XML, "ball_free_gears": BALL_XML,
          "tendon_transmission": TENDON_XML}


@pytest.mark.parametrize("scene", list(SCENES))
def test_actuator_force_matches_jax(scene):
    jm, tm = build_both(SCENES[scene])
    assert not tm.actuator_simple and not jm.actuator_simple
    q, v, u = random_states(tm, 8, seed=3, spread=0.8)
    u = 3.0 * u                          # reach past the ctrlranges
    f = jax.jit(jax.vmap(lambda c, qq, vv: jdyn.actuator_force(jm, c, qq,
                                                               vv)))
    want = np.asarray(f(jnp.asarray(u), jnp.asarray(q), jnp.asarray(v)))
    got = tdyn.actuator_force(tm, torch.tensor(u), torch.tensor(q),
                              torch.tensor(v)).numpy()
    assert_rel(got, want, what=scene)
    assert np.abs(want).max() > 1.0


@pytest.mark.parametrize("scene", list(SCENES))
def test_actuated_qacc_matches_jax(scene):
    jm, tm = build_both(SCENES[scene])
    q, v, u = random_states(tm, 6, seed=4)
    a, b = qacc_both(jm, tm, q, v, 2.0 * u)
    assert_rel(b, a, what=scene)


def test_lengths_and_velocities_enter_the_force():
    """Each bias term acts: the servo's -kp length and -kv velocity, the
    ball actuator's rotation-vector length, the tendon's length."""
    _, tm = build_both(SERVO_XML)
    q = torch.tensor([[0.3, 0.1]], dtype=torch.float64)
    v = torch.tensor([[0.5, -0.2]], dtype=torch.float64)
    u = torch.zeros((1, 3), dtype=torch.float64)
    f = tdyn.actuator_force(tm, u, q, v).numpy()[0]
    # shoulder: gear 2, kp 50, kv 3: f = -50 (2 q) - 3 (2 v), moment 2
    np.testing.assert_allclose(f[0], 2 * (-50 * 0.6 - 3 * 1.0), rtol=1e-12)
    # ext: velocity kv 10, then general (0.5 - 30 q - 2 v)
    np.testing.assert_allclose(f[1], -10 * -0.2 + 0.5 - 30 * 0.1 + 0.4,
                               rtol=1e-12)
