"""Port vs JAX package: the planar gym locomotion environments (CPU,
float64): Hopper-v3, Walker2d-v3, HalfCheetah-v3.

The same states and actions (numpy-seeded) go through ``env.step`` of both
packages: positions, observation, reward at 1e-9, velocities at 1e-9 of the
state set's largest velocity (one control step is up to 20 chained dual
solves), ``done`` exactly.  A Hopper ``rollout_batch`` of 10 control steps
runs in both from the same table of start states (injected through the
reset) with the same deterministic policy: every leaf at 1e-8, the mask and
``terminated`` exactly.
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
from mjrl_tpu.physics.model import State as JState
from mjrl_tpu.samplers import rollout as jrollout
from mjrl_tpu_torch import convert, envs as tenvs
from mjrl_tpu_torch.envs import gym_suite as tsuite
from mjrl_tpu_torch.models import policies as tpol
from mjrl_tpu_torch.models.fc_network import identity_transforms
from mjrl_tpu_torch.physics.collision import find_contacts
from mjrl_tpu_torch.physics.kinematics import body_frames
from mjrl_tpu_torch.samplers import rollout as trollout

from test_torch_kernel_host import cheetah_explosion_states, contact_states
from test_torch_policy import numpy_params, to_jax
from test_torch_mjcf_m9b import one_torch_thread  # noqa: F401

ENVS = {"Hopper-v3": (jsuite.HopperEnv, tsuite.HopperEnv, 11, 3, 4),
        "Walker2d-v3": (jsuite.Walker2dEnv, tsuite.Walker2dEnv, 17, 6, 4),
        "HalfCheetah-v3": (jsuite.HalfCheetahEnv, tsuite.HalfCheetahEnv,
                           17, 6, 5)}
B, T, HID = 8, 10, (16, 16)


def close(a, b, tol, scale=1.0):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol * scale)


def make_pair(env_id):
    jcls, tcls = ENVS[env_id][:2]
    return jcls(dtype=jnp.float64), tcls(dtype=torch.float64, device="cpu")


def step_states(tenv):
    """resting / penetrating / limit-violating states, 3 each, two resting
    states tilted by +-1.3 rad (unhealthy for Hopper and Walker2d), plus
    for the half-cheetah the captured explosion states that are still
    finite."""
    p = tenv._planar
    parts = [contact_states(p, tenv.model.qpos0, k, B=3, seed=20 + i)
             for i, k in enumerate(("resting", "penetrating", "limits"))]
    tilted = tuple(a[:2].copy() for a in parts[0])
    tilted[0][:, 2] += [1.3, -1.3]
    parts.append(tilted)
    if isinstance(tenv, tsuite.HalfCheetahEnv):
        parts.append(tuple(a[[0, 1, 4]] for a in cheetah_explosion_states()))
    return tuple(np.concatenate([x[i] for x in parts]) for i in range(3))


def jax_state(jenv, qpos, qvel):
    """Traced as one program (eagerly, each operation compiles alone)."""
    def state(qpos, qvel):
        s = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0),
                                                  qpos.shape[0]))
        physics = JState(qpos=qpos, qvel=qvel)
        obs = jax.vmap(lambda ph: jenv._obs(None, {}, ph))(physics)
        return s.replace(physics=physics, obs=obs)
    return jax.jit(state)(jnp.asarray(qpos), jnp.asarray(qvel))


@pytest.mark.parametrize("env_id", list(ENVS))
def test_registry_spec_and_model(env_id):
    jenv, tenv = make_pair(env_id)
    _, tcls, obs_dim, act_dim, frame_skip = ENVS[env_id]
    assert env_id in tenvs.registered_ids()
    assert env_id.replace("-v3", "-v4") in tenvs.registered_ids()
    made = tenvs.make(env_id, dtype=torch.float64, device="cpu")
    assert type(made) is tcls
    spec = tenv.spec
    assert (spec.observation_dim, spec.action_dim, spec.horizon) \
        == (obs_dim, act_dim, 1000) \
        == (jenv.spec.observation_dim, jenv.spec.action_dim,
            jenv.spec.horizon)
    assert tenv.frame_skip == jenv.frame_skip == frame_skip
    assert tenv.dt == pytest.approx(jenv.dt, abs=1e-15)
    close(tenv.init_qpos, jenv.init_qpos, 1e-15)
    close(tenv.act_low, jenv.act_low, 0.0)
    close(tenv.act_high, jenv.act_high, 0.0)
    assert tenv._planar is not None and jenv._planar is not None
    assert tenv._planar.integrator == jenv._planar.integrator


@pytest.mark.parametrize("env_id", list(ENVS))
def test_env_step_matches_jax(env_id):
    jenv, tenv = make_pair(env_id)
    q, v, u = step_states(tenv)
    u = u * 1.3                        # partly outside the control range
    js = jax.jit(jax.vmap(jenv.step))(jax_state(jenv, q, v), jnp.asarray(u))
    ts = tenv.step(tenv.state_from_qpos_qvel(q, v), torch.tensor(u))
    vmax = max(1.0, float(np.abs(np.asarray(js.physics.qvel)).max()))
    close(ts.physics.qpos, js.physics.qpos, 1e-9)
    close(ts.physics.qvel, js.physics.qvel, 1e-9, vmax)
    close(ts.obs, js.obs, 1e-9, vmax)
    close(ts.reward, js.reward, 1e-9, vmax)
    assert ts.done.dtype == torch.bool
    assert ts.done.tolist() == np.asarray(js.done).tolist()
    assert ts.t.tolist() == [1] * len(q)
    assert tuple(ts.obs.shape) == (len(q), ENVS[env_id][2])
    if env_id == "HalfCheetah-v3":
        assert not bool(ts.done.any())
    else:
        assert bool(ts.done.any()) and not bool(ts.done.all())


def test_reset_draws_from_the_generator():
    """qpos = init_qpos + U(-r, r), qvel = U(-r, r) (Hopper) or 0.1 N(0, 1)
    (HalfCheetah), in that order from the generator handed in."""
    hop = tsuite.HopperEnv(dtype=torch.float64, device="cpu")
    s = hop.reset(500, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    dq = torch.rand((500, 6), generator=g, dtype=torch.float64) * 0.01 - 0.005
    dv = torch.rand((500, 6), generator=g, dtype=torch.float64) * 0.01 - 0.005
    close(s.physics.qpos, hop.init_qpos + dq, 1e-15)
    close(s.physics.qvel, dv, 1e-15)
    assert float((s.physics.qpos - hop.init_qpos).abs().max()) <= 5e-3
    close(s.obs, torch.cat([s.physics.qpos[:, 1:], s.physics.qvel], -1), 0.0)
    assert not bool(s.done.any()) and float(s.reward.abs().sum()) == 0.0
    chee = tsuite.HalfCheetahEnv(dtype=torch.float64, device="cpu")
    s = chee.reset(2000, torch.Generator().manual_seed(4))
    assert 0.09 < float(s.physics.qvel.std()) < 0.11
    assert 0.09 < float((s.physics.qpos - chee.init_qpos).abs().max()) <= 0.1


def test_hopper_terminates_when_fallen():
    hop = tsuite.HopperEnv(dtype=torch.float64, device="cpu")
    walker = tsuite.Walker2dEnv(dtype=torch.float64, device="cpu")
    q = np.tile(hop.model.qpos0, (5, 1))
    v = np.zeros((5, 6))
    q[1, 1] = 0.69            # too low
    q[2, 2] = 0.21            # tilted
    v[3, 4] = 101.0           # a state coordinate beyond 100
    s = hop.state_from_qpos_qvel(q, v)
    assert hop._done(s.obs, s.physics).tolist() \
        == [False, True, True, True, False]
    bad = s.obs.clone()
    bad[4, 0] = float("nan")
    assert hop._done(bad, s.physics).tolist()[4] is True
    qw = np.tile(walker.model.qpos0, (3, 1))
    qw[1, 1] = 0.79
    qw[2, 2] = -1.01
    sw = walker.state_from_qpos_qvel(qw, np.full((3, 9), 150.0))
    assert walker._done(sw.obs, sw.physics).tolist() == [False, True, True]


def test_cone_and_solver_arguments():
    ell = tsuite.HopperEnv(dtype=torch.float64, device="cpu",
                           cone="elliptic")
    assert ell._planar.cone == 1 and ell.model.cone == 1
    assert tsuite.HopperEnv(dtype=torch.float64, device="cpu",
                            cone="pyramidal")._planar.cone == 0
    # the penalty solver does not take the planar fast path: the general
    # engine steps it (capsule-plane contacts included), as the JAX package
    pen = tsuite.HopperEnv(dtype=torch.float64, device="cpu",
                           solver="penalty")
    assert pen._planar is None and pen.model.solver == 0
    jpen = jsuite.HopperEnv(dtype=jnp.float64, solver="penalty")
    rng = np.random.RandomState(4)
    q = pen.model.qpos0 + rng.uniform(-0.05, 0.05, (3, 6))
    q[:, 1] = (1.17, 1.19, 1.3)           # two feet pressed into the floor
    depths = find_contacts(pen.model, body_frames(pen.model,
                                                  torch.tensor(q)))[0]
    assert (depths.max(1).values > 0).tolist() == [True, True, False]
    v = rng.uniform(-0.5, 0.5, (3, 6))
    a = rng.uniform(-1, 1, (3, 3))
    ts = pen.step(pen.state_from_qpos_qvel(q, v), torch.tensor(a))
    js = jax.vmap(jpen.reset)(jax.random.split(jax.random.PRNGKey(0), 3))
    js = jax.vmap(jpen.set_env_state)(js, dict(qp=jnp.asarray(q),
                                               qv=jnp.asarray(v)))
    js = jax.jit(jax.vmap(jpen.step))(js, jnp.asarray(a))
    np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs),
                               rtol=1e-9, atol=1e-9)
    # a float32 env rounds the model's constants to float32, like the JAX
    # package's float32 model
    f32 = tsuite.HopperEnv(device="cpu")
    assert f32._planar.timestep == float(np.float32(0.002)) != 0.002
    assert f32.reset(2, torch.Generator().manual_seed(0)).obs.dtype \
        == torch.float32


# ---- a Hopper rollout in both packages --------------------------------------

def _start_table():
    """8 Hopper starts (x = 0): four near standing, four about to leave the
    healthy range (tilting at ~0.19 rad with angular velocity, or dropping
    through z = 0.7 + a little)."""
    rng = np.random.RandomState(42)
    hop = tsuite.HopperEnv(dtype=torch.float64, device="cpu")
    q = np.tile(hop.model.qpos0, (8, 1)) + rng.uniform(-5e-3, 5e-3, (8, 6))
    v = rng.uniform(-5e-3, 5e-3, (8, 6))
    q[:, 0] = 0.0
    q[4:6, 2] = [0.19, -0.185]
    v[4:6, 2] = [1.5, -2.0]
    q[6:, 1] = [0.74, 0.72]
    q[6:, 3:5] = -0.9          # knees bent, so the foot is off the floor
    v[6:, 1] = -1.0
    return q, v


class _TableHopper(jsuite.HopperEnv):
    """JAX Hopper whose reset picks a row of the start table."""
    table = _start_table()

    def _reset_qpos_qvel(self, key):
        i = jax.random.randint(key, (), 0, 8)
        return (jnp.asarray(self.table[0])[i], jnp.asarray(self.table[1])[i])


@pytest.fixture(scope="module")
def hopper_rollouts():
    jenv = _TableHopper(dtype=jnp.float64)
    tenv = tsuite.HopperEnv(dtype=torch.float64, device="cpu")
    p_np = numpy_params(31, HID, obs=11, act=3)
    jcfg = jpol.GaussianMLP(11, 3, HID)
    jtr = jax_identity_transforms(11, 3, jnp.float64)
    tcfg = tpol.GaussianMLP(11, 3, HID, dtype=torch.float64, device="cpu")
    tp = convert.params_from_numpy(p_np, torch.float64)
    jb = jax.jit(lambda k: jrollout.rollout_batch(
        jenv, jcfg, to_jax(p_np), jtr, k, B, horizon=T, eval_mode=True))(
            jax.random.PRNGKey(5))
    obs0 = np.asarray(jb["observations"][:, 0])
    q0 = np.concatenate([np.zeros((B, 1)), obs0[:, :5]], axis=1)
    tb = trollout.rollout_batch(
        tenv, tcfg, tp, identity_transforms(11, 3, torch.float64), None, B,
        horizon=T, eval_mode=True,
        state0=tenv.state_from_qpos_qvel(q0, obs0[:, 5:]))
    return jb, tb


@pytest.mark.parametrize("leaf", ["observations", "actions", "rewards",
                                  "agent_mean", "agent_log_std", "mask",
                                  "terminated", "last_obs"])
def test_hopper_rollout_matches_jax(hopper_rollouts, leaf):
    jb, tb = hopper_rollouts
    assert tuple(tb[leaf].shape) == tuple(jb[leaf].shape)
    if leaf in ("terminated", "mask"):
        assert tb[leaf].tolist() == np.asarray(jb[leaf]).tolist()
    else:
        close(tb[leaf], jb[leaf], 1e-8)


def test_hopper_rollout_has_episodes_of_unequal_length(hopper_rollouts):
    jb, tb = hopper_rollouts
    assert set(tb) == set(jb)
    mask = tb["mask"]
    lengths = mask.sum(1).long()
    assert bool((mask[:, :-1] >= mask[:, 1:]).all())       # non-increasing
    assert 0 < int(tb["terminated"].sum()) < B
    assert int(lengths.min()) < T and int(lengths.max()) == T
    assert bool((tb["terminated"] == (lengths < T)).all())
    close(tb["rewards"] * (1 - mask), torch.zeros_like(mask), 0.0)
    paths = trollout.paths_to_list(tb)
    assert [len(p["rewards"]) for p in paths] == lengths.tolist()
    assert [p["terminated"] for p in paths] == tb["terminated"].tolist()
