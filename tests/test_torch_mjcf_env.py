"""Port vs JAX package: ``MJCFEnv``, any MJCF file as an env (CPU,
float64).

The ``tests/test_envs.py`` scene (a ball joint and a hinge, one motor) and
the port's copy of gymnasium's inverted pendulum: the reset without noise,
then one control step from the same injected states (normalized
quaternions) through both packages: state, observation, reward and done at
1e-9.  The reset noise comes from the port's generator and leaves the
quaternions as drawn, as the JAX reset does: with the JAX reset's uniform
and normal draws injected, a free joint's reset observation equals the JAX
package's at 1e-12.  The rollout runs through the port's sampler.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.envs import MJCFEnv as JaxMJCFEnv
from mjrl_tpu.physics.model import State as JaxState
from mjrl_tpu_torch.envs import MJCFEnv
from mjrl_tpu_torch.envs import mjcf_env as tmjcf
from mjrl_tpu_torch.models.policies import GaussianMLP
from mjrl_tpu_torch.physics.model import BALL, FREE
from mjrl_tpu_torch.samplers.rollout import rollout_batch

from test_torch_mjcf_m9b import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-9
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PENDULUM = os.path.join(REPO, "mjrl_tpu_torch", "envs", "mjcf",
                        "inverted_pendulum.xml")
XML = """
<mujoco>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <body pos="0 0 1">
      <joint name="b" type="ball" limited="true" range="0 40"
             damping="0.05"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"/>
      <body pos="0.3 0 0">
        <joint name="h" type="hinge" axis="0 1 0" damping="0.02"/>
        <geom type="sphere" size="0.04"/>
      </body>
    </body>
  </worldbody>
  <actuator><motor joint="h" gear="5" ctrlrange="-1 1"/></actuator>
</mujoco>
"""

SCENES = {
    "ball_hinge": dict(
        kw=dict(xml_string=XML, frame_skip=2, horizon=30),
        jax_reward=lambda obs, act: -jnp.sum(obs[:4] ** 2) + act[0],
        torch_reward=lambda obs, act: -torch.sum(obs[..., :4] ** 2, -1)
        + act[..., 0],
        jax_done=lambda obs: obs[-1] > 1.5,
        torch_done=lambda obs: obs[..., -1] > 1.5),
    "pendulum": dict(
        kw=dict(path=PENDULUM, frame_skip=2, horizon=50),
        jax_reward=lambda obs, act: 1.0 - obs[1] ** 2,
        torch_reward=lambda obs, act: 1.0 - obs[..., 1] ** 2,
        jax_done=lambda obs: jnp.abs(obs[1]) > 0.2,
        torch_done=lambda obs: obs[..., 1].abs() > 0.2),
}


def envs(name, reset_noise=0.0):
    sc = SCENES[name]
    j = JaxMJCFEnv(**sc["kw"], reset_noise=reset_noise, dtype=jnp.float64,
                   reward_fn=sc["jax_reward"], done_fn=sc["jax_done"])
    t = MJCFEnv(**sc["kw"], reset_noise=reset_noise, dtype=torch.float64,
                device="cpu", reward_fn=sc["torch_reward"],
                done_fn=sc["torch_done"])
    return j, t


FREE_XML = """
<mujoco>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <body pos="0 0 1">
      <freejoint name="root"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"/>
      <body pos="0.3 0 0">
        <joint name="h" type="hinge" axis="0 1 0" damping="0.02"/>
        <geom type="sphere" size="0.04"/>
      </body>
    </body>
  </worldbody>
  <actuator><motor joint="h" gear="5" ctrlrange="-1 1"/></actuator>
</mujoco>
"""


def quat_adr(model):
    """The first qpos index of every quaternion (ball: its 4 numbers,
    free: the 4 after its position)."""
    return [adr + (3 if jt == FREE else 0)
            for jt, adr in zip(model.jnt_type, model.jnt_qposadr)
            if jt in (BALL, FREE)]


def states(env, B, seed):
    """B states around qpos0, quaternions normalized."""
    rng = np.random.RandomState(seed)
    m = env.model
    qpos = np.asarray(m.qpos0) + rng.uniform(-0.3, 0.3, (B, m.nq))
    for adr in quat_adr(m):
        q = qpos[:, adr:adr + 4]
        qpos[:, adr:adr + 4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qvel = rng.uniform(-1.0, 1.0, (B, m.nv))
    return qpos, qvel


def close(a, b, tol=TOL):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_reset_and_one_control_step_match_jax(name):
    jenv, tenv = envs(name)
    assert tenv.observation_dim == jenv.observation_dim
    assert (tenv.spec.observation_dim, tenv.spec.action_dim,
            tenv.spec.horizon) == (jenv.spec.observation_dim,
                                   jenv.spec.action_dim, jenv.spec.horizon)
    # the reset without noise: qpos0 and zero velocities in both
    B = 5
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    js = jax.vmap(jenv.reset)(keys)
    ts = tenv.reset(B, torch.Generator().manual_seed(0))
    close(ts.obs, js.obs, 0.0)

    qpos, qvel = states(tenv, B, 1)
    act = np.random.RandomState(2).uniform(-1.5, 1.5, (B, tenv.model.nu))
    js = js.replace(physics=JaxState(qpos=jnp.asarray(qpos),
                                     qvel=jnp.asarray(qvel)),
                    obs=jnp.concatenate([qpos, qvel], -1))
    ts = tenv.state_from_qpos_qvel(qpos, qvel)
    close(ts.obs, js.obs, 0.0)
    jn = jax.jit(jax.vmap(jenv.step))(js, jnp.asarray(act))
    tn = tenv.step(ts, torch.tensor(act))
    close(tn.physics.qpos, jn.physics.qpos)
    close(tn.physics.qvel, jn.physics.qvel)
    close(tn.obs, jn.obs)
    close(tn.reward, jn.reward)
    np.testing.assert_array_equal(tn.done.numpy(), np.asarray(jn.done))
    # rewards from observations only, as compute_path_rewards reads them
    obs = np.asarray(jn.obs)[None]
    close(tenv.batched_reward(torch.tensor(obs)),
          jenv.batched_reward(jnp.asarray(obs)))


def test_reset_noise_comes_from_the_generator_and_keeps_unit_quaternions():
    """The reset draws from the generator and leaves the quaternion as
    drawn (qpos0 + uniform noise, not of unit norm), as the JAX reset does;
    the step keeps unit quaternions (the integrator normalizes them)."""
    _, tenv = envs("ball_hinge", reset_noise=0.05)
    a = tenv.reset(64, torch.Generator().manual_seed(3))
    b = tenv.reset(64, torch.Generator().manual_seed(3))
    assert torch.equal(a.obs, b.obs)
    dev = a.physics.qpos - torch.tensor(tenv.model.qpos0)
    assert 0.0 < float(dev.abs().max()) <= 0.05
    assert float(a.physics.qvel.std()) > 0.01
    norm = torch.linalg.vector_norm(a.physics.qpos[:, :4], dim=-1)
    assert float((norm - 1.0).abs().max()) > 1e-3
    after = tenv.step(a, torch.zeros(64, 1, dtype=torch.float64))
    close(torch.linalg.vector_norm(after.physics.qpos[:, :4], dim=-1),
          np.ones(64), 1e-12)


class _InjectedDraws:
    """Stands in for ``torch`` in the port's MJCFEnv module: ``rand`` and
    ``randn`` return the given draws; everything else is torch's."""

    def __init__(self, uniform, normal):
        self.uniform, self.normal = uniform, normal

    def __getattr__(self, name):
        return getattr(torch, name)

    def rand(self, shape, **kw):
        assert tuple(shape) == self.uniform.shape
        return torch.tensor(self.uniform)

    def randn(self, shape, **kw):
        assert tuple(shape) == self.normal.shape
        return torch.tensor(self.normal)


def test_free_joint_reset_with_noise_matches_jax(monkeypatch):
    """The reset of a free joint with noise: the JAX reset's own uniform
    and normal draws injected into the port's, the observation (qpos with
    the free joint's quaternion as drawn, qvel) equal at 1e-12."""
    r, B = 0.1, 6
    jenv = JaxMJCFEnv(xml_string=FREE_XML, reset_noise=r, dtype=jnp.float64)
    tenv = MJCFEnv(xml_string=FREE_XML, reset_noise=r, dtype=torch.float64,
                   device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    js = jax.jit(jax.vmap(jenv.reset))(keys)
    # the reset's keys (base reset: scenery, qpos; then qpos, qvel)
    kq, kv = jax.vmap(lambda k: tuple(jax.random.split(
        jax.random.split(k)[1])))(keys)
    m = tenv.model
    u = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (m.nq,), jnp.float64))(kq))
    n = np.asarray(jax.vmap(lambda k: jax.random.normal(
        k, (m.nv,), jnp.float64))(kv))
    monkeypatch.setattr(tmjcf, "torch", _InjectedDraws(u, n))
    ts = tenv.reset(B, torch.Generator().manual_seed(0))
    monkeypatch.undo()
    close(ts.obs, js.obs, 1e-12)
    quat = ts.physics.qpos[:, 3:7]
    assert float((torch.linalg.vector_norm(quat, dim=-1) - 1).abs().max()) \
        > 1e-3                       # as drawn, not renormalized


def test_rollout_through_the_sampler():
    _, tenv = envs("ball_hinge", reset_noise=0.01)
    pol = GaussianMLP(tenv.observation_dim, 1, hidden_sizes=(8,),
                      dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(1)
    params, tr = pol.init(gen)
    batch = rollout_batch(tenv, pol, params, tr, gen, num_traj=3, horizon=10)
    assert batch["observations"].shape == (3, 10, tenv.observation_dim)
    assert torch.isfinite(batch["rewards"]).all()


def test_needs_actuators():
    with pytest.raises(ValueError, match="actuator"):
        MJCFEnv(xml_string="""
        <mujoco><worldbody><body pos="0 0 1"><joint type="hinge"/>
        <geom type="sphere" size="0.1"/></body></worldbody></mujoco>""",
                device="cpu")
