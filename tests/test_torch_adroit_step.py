"""Port vs JAX package: one Adroit relocate control step (CPU, float64).

Two golden grasp states (``tests/golden/contact_adroit.npz``) with drawn
scenery (the ball's table position, the target site), one control step of
5 substeps: affine servos driven by [-1, 1] actions beyond the range (the
env clips them), condim-1/3/4 contacts capped at 64 per class, dry
friction, 44 tendon limits, the primal Newton solver and the noslip pass.
The observation, the reward, the goal flag, qpos and qvel after the step
against the JAX env's ``step`` at 1e-9 (qvel relative to its largest
entry).  The JAX side needs gymnasium_robotics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu_torch.envs.adroit import AdroitRelocateEnv

from test_torch_adroit import GOLDEN, _scenery

from test_torch_mjcf_m9b import one_torch_thread  # noqa: E402,F401

TOL = 1e-9
B = 2


def test_control_step_matches_jax():
    """The JAX step is compiled once for a single state (its vmapped
    compile and batched state set-up cost twice as much here) and run on
    each of the B states."""
    pytest.importorskip("gymnasium_robotics")
    from mjrl_tpu.envs.adroit import AdroitRelocateEnv as JaxAdroit
    from mjrl_tpu.physics.model import State as JState
    jenv = JaxAdroit(dtype=jnp.float64)
    tenv = AdroitRelocateEnv(dtype=torch.float64, device="cpu")
    g = np.load(GOLDEN)
    q, v = g["qpos"][:B], g["qvel"][:B]
    sc = _scenery(B, 3)
    acts = np.random.RandomState(3).uniform(-1.2, 1.2, (B, 30))
    ts = tenv.step(tenv.state_from_qpos_qvel(q, v, sc), torch.tensor(acts))
    j0 = jenv.reset(jax.random.PRNGKey(0))
    step = jax.jit(jenv.step)
    for i in range(B):
        js = step(j0.replace(
            physics=JState(qpos=jnp.asarray(q[i]), qvel=jnp.asarray(v[i])),
            scenery={k: jnp.asarray(x[i]) for k, x in sc.items()}),
            jnp.asarray(acts[i]))
        for k in ("obs", "reward"):
            np.testing.assert_allclose(getattr(ts, k)[i].numpy(),
                                       np.asarray(getattr(js, k)),
                                       rtol=TOL, atol=TOL, err_msg=k)
        np.testing.assert_allclose(ts.physics.qpos[i].numpy(),
                                   np.asarray(js.physics.qpos), rtol=TOL,
                                   atol=TOL)
        want_v = np.asarray(js.physics.qvel)
        np.testing.assert_allclose(ts.physics.qvel[i].numpy(), want_v,
                                   rtol=TOL, atol=TOL * np.abs(want_v).max())
        assert bool(ts.info["goal_achieved"][i]) \
            == bool(js.info["goal_achieved"])
    assert ts.t.tolist() == [1] * B and not ts.done.any()
    assert float((ts.physics.qvel - torch.tensor(v)).abs().max()) > 0.1
