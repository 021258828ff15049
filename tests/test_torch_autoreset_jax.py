"""Port vs JAX package: the autoreset rollout held to the JAX
``rollout_batch(..., autoreset=True)`` itself (CPU, float64).

Hopper-v3, 32 x 12.  The JAX rollout draws its start states from
``env.reset(k_reset)``, its action noise from ``split(k_scan, T)`` and its
fresh states from ``env.reset(fold_in(kt, 1))``; the same draws, taken from
the same keys, are injected into the port's rollout (``state0``,
``noise``, ``resets``).  Every leaf is compared at 1e-9, ``last_obs``
included: the JAX rollout returns its scan's final carry, so a row whose
episode ends at the last step carries a fresh state there.

Three in five of the reset states are tilted to the edge of the healthy range
(angle 0.19 rad, turning at 1.5 rad/s; a subclass of the JAX env draws
them), so rows hold several episodes and some end at the last step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.envs import gym_suite as jsuite
from mjrl_tpu.models import policies as jpol
from mjrl_tpu.models.fc_network import \
    identity_transforms as jax_identity_transforms
from mjrl_tpu.samplers import rollout as jrollout
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.envs import gym_suite as tsuite
from mjrl_tpu_torch.models import policies as tpol
from mjrl_tpu_torch.samplers import rollout as trollout

from test_torch_policy import numpy_params, to_jax

B, T, HID = 32, 12, (8, 8)
TOL = 1e-9


class TiltedHopper(jsuite.HopperEnv):
    """The JAX Hopper with three in five of its reset states at the edge of the
    healthy range."""

    def _reset_qpos_qvel(self, key):
        qpos, qvel = super()._reset_qpos_qvel(key)
        tilt = jax.random.uniform(jax.random.fold_in(key, 7)) < 0.6
        qpos = qpos.at[2].set(jnp.where(tilt, 0.19, qpos[2]))
        qvel = qvel.at[2].set(jnp.where(tilt, 1.5, qvel[2]))
        return qpos, qvel


def jax_draws(jenv, key, act_dim):
    """The start states, action noise and fresh states that
    ``rollout_batch`` draws from ``key`` (``rollout.py:100-152``)."""
    @jax.jit
    def draws(key):               # one program: eagerly, each op compiles
        keys = jax.random.split(key, B)
        k_reset, k_scan = jax.vmap(jax.random.split)(keys).transpose(1, 0,
                                                                     2)
        s0 = jax.vmap(jenv.reset)(k_reset)
        kt = jax.vmap(lambda k: jax.random.split(k, T))(k_scan)  # (B, T)
        noise = jax.vmap(jax.vmap(lambda k: jax.random.normal(
            k, (act_dim,), jnp.float64)))(kt)
        fresh = jax.vmap(jax.vmap(lambda k: jenv.reset(
            jax.random.fold_in(k, 1))))(kt)
        return s0, noise, fresh
    s0, noise, fresh = draws(key)
    tp = lambda a: np.swapaxes(np.asarray(a), 0, 1)             # (T, B, .)
    return ((np.asarray(s0.physics.qpos), np.asarray(s0.physics.qvel)),
            tp(noise), (tp(fresh.physics.qpos), tp(fresh.physics.qvel)))


@pytest.fixture(scope="module")
def rollouts():
    jenv = TiltedHopper(dtype=jnp.float64)
    tenv = tsuite.HopperEnv(dtype=torch.float64, device="cpu")
    p_np = numpy_params(51, HID, obs=11, act=3)
    p_np["log_std"] = np.full(3, -0.5)
    key = jax.random.PRNGKey(7)
    jcfg = jpol.GaussianMLP(11, 3, HID)
    jtr = jax_identity_transforms(11, 3, jnp.float64)
    jb = jrollout.rollout_batch(jenv, jcfg, to_jax(p_np), jtr, key, B,
                                horizon=T, autoreset=True)
    (q0, v0), noise, resets = jax_draws(jenv, key, 3)
    policy = tpol.MLP(tenv.spec, hidden_sizes=HID, dtype=torch.float64,
                      device="cpu")
    convert.policy_params_from_numpy(policy, p_np)
    tb = trollout.rollout_batch(
        tenv, policy.config, policy.params, policy.transforms, None, B,
        horizon=T, autoreset=True,
        state0=tenv.state_from_qpos_qvel(q0, v0),
        noise=torch.tensor(noise), resets=resets)
    jb = jax.tree_util.tree_map(np.asarray, jb)
    return tb, jb, resets


def test_every_leaf_matches_the_jax_rollout(rollouts):
    tb, jb, _ = rollouts
    assert set(tb) == set(jb)
    for k in ("observations", "actions", "rewards", "agent_mean",
              "agent_log_std", "mask", "dones", "last_obs"):
        got = tb[k].numpy()
        assert got.shape == jb[k].shape, k
        np.testing.assert_allclose(got, jb[k], rtol=TOL, atol=TOL,
                                   err_msg=k)
    assert tb["terminated"].tolist() == jb["terminated"].tolist()
    assert set(tb["env_infos"]) == set(jb["env_infos"])
    # rows end, restart and end again inside the grid
    dones = jb["dones"]
    assert dones.sum() >= B and dones.sum(1).max() >= 2


def test_rows_ending_at_the_last_step_carry_a_reset_state(rollouts):
    tb, jb, resets = rollouts
    ends = np.flatnonzero(jb["dones"][:, -1] > 0)
    assert ends.size >= 2
    rq, rv = resets
    fresh = np.concatenate([rq[-1, ends, 1:],
                            np.clip(rv[-1, ends], -10.0, 10.0)], axis=-1)
    np.testing.assert_allclose(tb["last_obs"][ends].numpy(), fresh,
                               rtol=0, atol=0)
    np.testing.assert_allclose(jb["last_obs"][ends], fresh, rtol=TOL,
                               atol=TOL)
