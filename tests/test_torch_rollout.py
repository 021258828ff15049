"""Port vs JAX package: environment step and batched rollouts (CPU, float64).

The same start states, weights and noise go through both packages.  The JAX
side runs on the CPU, where its rollout takes the vmapped path whose control
step is the plain reference of the Pallas kernel.  Tolerances: 1e-10 for one
``env.step``; 1e-8 for 20-step rollouts, where last-digit differences of one
step are fed back through the policy and the physics 20 times.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.envs import base as jbase
from mjrl_tpu.envs.swimmer import SwimmerEnv as JaxSwimmerEnv
from mjrl_tpu.models import policies as jpol
from mjrl_tpu.models.fc_network import \
    identity_transforms as jax_identity_transforms
from mjrl_tpu.physics.model import State as JState
from mjrl_tpu.samplers import rollout as jrollout
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.envs import base as tbase
from mjrl_tpu_torch.envs.swimmer import SwimmerEnv
from mjrl_tpu_torch.models import policies as tpol
from mjrl_tpu_torch.models.fc_network import identity_transforms
from mjrl_tpu_torch.parallel import make_mesh
from mjrl_tpu_torch.physics.model import State
from mjrl_tpu_torch.samplers import rollout as trollout

from test_torch_kernel_host import golden_env_states, limit_active_states
from test_torch_policy import numpy_params, to_jax
from test_torch_mjcf_m9b import one_torch_thread  # noqa: F401
from test_torch_parallel_mesh import RowsOnly

B, T, HID = 16, 20, (16, 16)
STEP_TOL, ROLLOUT_TOL = 1e-10, 1e-8


def close(a, b, tol):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def envs():
    return (JaxSwimmerEnv(dtype=jnp.float64),
            SwimmerEnv(dtype=torch.float64, device="cpu"))


@pytest.fixture(scope="module")
def policies():
    """The same 16-16 policy in both packages; log_std about -0.5 so the
    stochastic rollout explores without leaving the float64-tight regime."""
    p_np = numpy_params(21, HID)
    p_np["log_std"] = np.full(4, -0.5)
    jcfg = jpol.GaussianMLP(12, 4, HID)
    jtr = jax_identity_transforms(12, 4, jnp.float64)
    tcfg = tpol.GaussianMLP(12, 4, HID, dtype=torch.float64, device="cpu")
    return ((jcfg, to_jax(p_np), jtr),
            (tcfg, convert.params_from_numpy(p_np, torch.float64),
             identity_transforms(12, 4, torch.float64)))


@pytest.fixture(scope="module")
def jax_step(envs):
    """jitted, vmapped JAX env.step on a batched EnvState (compiled once)."""
    return jax.jit(jax.vmap(envs[0].step))


def jax_state(jenv, qpos, qvel):
    s = jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(0),
                                              qpos.shape[0]))
    physics = JState(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel))
    return s.replace(physics=physics,
                     obs=jnp.concatenate([physics.qpos[:, 2:], physics.qvel],
                                         axis=-1))


@pytest.mark.parametrize("states", [golden_env_states, limit_active_states],
                         ids=["golden_env_swimmer", "limit_active"])
def test_env_step_matches_jax(envs, jax_step, states):
    jenv, tenv = envs
    q, v, u = (np.asarray(a[:B], np.float64) for a in states())
    js = jax_step(jax_state(jenv, q, v), jnp.asarray(u))
    ts = tenv.step(tenv.state_from_qpos_qvel(q, v), torch.tensor(u))
    close(ts.physics.qpos, js.physics.qpos, STEP_TOL)
    close(ts.physics.qvel, js.physics.qvel, STEP_TOL)
    close(ts.obs, js.obs, STEP_TOL)
    close(ts.reward, js.reward, STEP_TOL)
    assert ts.obs.shape == (B, 12) and ts.reward.shape == (B,)
    assert not bool(ts.done.any()) and not bool(np.asarray(js.done).any())
    assert ts.t.tolist() == [1] * B == np.asarray(js.t).tolist()


def test_env_step_matches_mujoco_golden(envs):
    """One control step from the recorded MuJoCo states lands on the
    recorded next observation and reward (2e-3: the fast path's limit dual
    is MuJoCo's soft constraint solved by 12 Gauss-Seidel sweeps, held to
    MuJoCo at this level by the JAX package's own golden tests)."""
    _, tenv = envs
    d = np.load(os.path.join(os.path.dirname(__file__), "golden",
                             "env_swimmer.npz"))
    q, v, u = golden_env_states()
    obs = np.concatenate([d[f"ep{e}_obs"] for e in range(3)])
    rew = np.concatenate([d[f"ep{e}_rewards"] for e in range(3)])
    clean = np.concatenate([d[f"ep{e}_clean"] for e in range(3)]) > 0
    ts = tenv.step(tenv.state_from_qpos_qvel(q, v), torch.tensor(u))
    close(ts.obs[clean], obs[clean], 2e-3)
    close(ts.reward[clean], rew[clean], 2e-3)


def test_rescue_divergence_matches_jax():
    """Rows that come out non-finite or beyond 1e10 keep the pre-step qpos
    and get zero qvel; the others pass (exact)."""
    rng = np.random.RandomState(0)
    old_q, old_v, new_q, new_v = (rng.normal(size=(6, 7)) for _ in range(4))
    new_q[1, 2] = np.nan
    new_v[2, 0] = np.inf
    new_q[3, 4] = 2e10
    new_v[4, 6] = -1e10
    jr = jax.vmap(jbase._rescue_divergence)(
        JState(jnp.asarray(old_q), jnp.asarray(old_v)),
        JState(jnp.asarray(new_q), jnp.asarray(new_v)))
    tr = tbase._rescue_divergence(
        State(torch.tensor(old_q), torch.tensor(old_v)),
        State(torch.tensor(new_q), torch.tensor(new_v)))
    close(tr.qpos, jr.qpos, 0.0)
    close(tr.qvel, jr.qvel, 0.0)
    assert float(tr.qvel[1:5].abs().sum()) == 0.0
    close(tr.qpos[1:5], old_q[1:5], 0.0)
    close(tr.qpos[[0, 5]], new_q[[0, 5]], 0.0)


def test_reset_distribution(envs):
    """Reset randomizes only the heading, uniformly in (-pi, pi), from the
    generator handed in."""
    _, tenv = envs
    g = torch.Generator().manual_seed(0)
    s = tenv.reset(4000, g)
    q = s.physics.qpos
    assert float(q[:, :2].abs().sum()) == 0 and float(q[:, 3:].abs().sum()) == 0
    assert float(s.physics.qvel.abs().sum()) == 0
    h = q[:, 2]
    assert -np.pi <= float(h.min()) < -3.0 and 3.0 < float(h.max()) <= np.pi
    assert abs(float(h.mean())) < 0.15
    close(s.obs, torch.cat([q[:, 2:], s.physics.qvel], -1), 0.0)
    s2 = tenv.reset(4000, torch.Generator().manual_seed(0))
    close(s2.physics.qpos, q, 0.0)


@pytest.fixture(scope="module")
def eval_rollouts(envs, policies):
    """JAX eval-mode rollout_batch and the port's from the same starts (read
    back from the JAX rollout's first observations: the swimmer resets to
    qpos = [0, 0, heading, 0...], qvel = 0)."""
    (jenv, tenv), ((jcfg, jp, jt), (tcfg, tp, tt)) = envs, policies
    jb = jax.jit(lambda k: jrollout.rollout_batch(
        jenv, jcfg, jp, jt, k, B, horizon=T, eval_mode=True))(
            jax.random.PRNGKey(3))
    obs0 = np.asarray(jb["observations"][:, 0])
    q0 = np.concatenate([np.zeros((B, 2)), obs0[:, :5]], axis=1)
    tb = trollout.rollout_batch(
        tenv, tcfg, tp, tt, None, B, horizon=T, eval_mode=True,
        state0=tenv.state_from_qpos_qvel(q0, obs0[:, 5:]))
    return jb, tb


@pytest.mark.parametrize("leaf", ["observations", "actions", "rewards",
                                  "agent_mean", "agent_log_std", "mask",
                                  "terminated", "last_obs"])
def test_eval_rollout_matches_jax(eval_rollouts, leaf):
    jb, tb = eval_rollouts
    assert tuple(tb[leaf].shape) == tuple(jb[leaf].shape)
    if leaf == "terminated":
        assert tb[leaf].dtype == torch.bool
        assert tb[leaf].tolist() == np.asarray(jb[leaf]).tolist()
    else:
        close(tb[leaf], jb[leaf], ROLLOUT_TOL)


def test_eval_rollout_schema(eval_rollouts):
    jb, tb = eval_rollouts
    assert set(tb) == set(jb)
    assert tb["env_infos"] == {} and dict(jb["env_infos"]) == {}
    assert tb["observations"].shape == (B, T, 12)
    close(tb["actions"], tb["agent_mean"], 0.0)     # eval mode: the mean


def test_stochastic_rollout_with_injected_noise_matches_jax(envs, policies,
                                                            jax_step):
    """The port's rollout with injected (T, B, act) noise against a short
    JAX loop: action = mean + exp(log_std) * noise, then env.step."""
    (jenv, tenv), ((jcfg, jp, jt), (tcfg, tp, tt)) = envs, policies
    rng = np.random.RandomState(5)
    noise = rng.normal(size=(T, B, 4))
    q0 = np.zeros((B, 7))
    q0[:, 2] = rng.uniform(-np.pi, np.pi, B)
    v0 = np.zeros((B, 7))

    s = jax_state(jenv, q0, v0)
    dist_info = jax.jit(lambda o: jcfg.dist_info(jp, jt, o))
    j_obs, j_act, j_rew = [], [], []
    for t in range(T):
        mean, log_std = dist_info(s.obs)
        action = mean + jnp.exp(log_std) * noise[t]
        j_obs.append(s.obs)
        j_act.append(action)
        s = jax_step(s, action)
        j_rew.append(s.reward)

    tb = trollout.rollout_batch(
        tenv, tcfg, tp, tt, None, B, horizon=T,
        state0=tenv.state_from_qpos_qvel(q0, v0), noise=torch.tensor(noise))
    close(tb["observations"], np.stack(j_obs, 1), ROLLOUT_TOL)
    close(tb["actions"], np.stack(j_act, 1), ROLLOUT_TOL)
    close(tb["rewards"], np.stack(j_rew, 1), ROLLOUT_TOL)
    close(tb["last_obs"], s.obs, ROLLOUT_TOL)
    # really stochastic: actions leave the mean by the injected noise
    close(tb["actions"] - tb["agent_mean"], np.exp(-0.5)
          * noise.transpose(1, 0, 2), 1e-12)


def test_drawn_noise_is_per_step_and_batch_from_the_generator(envs, policies):
    """Without injected noise the rollout draws randn(B, act) once per step
    from the generator, after the reset draw."""
    _, tenv = envs
    _, (tcfg, tp, tt) = policies
    tb = trollout.rollout_batch(tenv, tcfg, tp, tt,
                                torch.Generator().manual_seed(11), 4,
                                horizon=3)
    g = torch.Generator().manual_seed(11)
    torch.rand((4,), generator=g, dtype=torch.float64)        # the reset
    for t in range(3):
        eps = torch.randn((4, 4), generator=g, dtype=torch.float64)
        close(tb["actions"][:, t] - tb["agent_mean"][:, t],
              np.exp(-0.5) * eps, 1e-12)
    assert bool(tb["mask"].eq(1).all()) and not bool(tb["terminated"].any())


class _TerminatingSwimmer(SwimmerEnv):
    """Swimmer that ends an episode once |x| > 2 cm (test only)."""

    def _done(self, obs, physics):
        return physics.qpos[..., 0].abs() > 0.02


def test_freeze_after_done_mask(policies):
    """Early-terminating env: the mask is a prefix of ones, rewards are zero
    after the end, the frozen tail repeats the terminal observation, and the
    valid prefix equals the never-terminating rollout."""
    _, (tcfg, tp, tt) = policies
    rng = np.random.RandomState(6)
    noise = torch.tensor(rng.normal(size=(T, B, 4)) * 3.0)
    q0 = np.zeros((B, 7))
    q0[:, 2] = rng.uniform(-np.pi, np.pi, B)
    env_t = _TerminatingSwimmer(dtype=torch.float64, device="cpu")
    env_n = SwimmerEnv(dtype=torch.float64, device="cpu")
    bt = trollout.rollout_batch(env_t, tcfg, tp, tt, None, B, horizon=T,
                                state0=env_t.state_from_qpos_qvel(
                                    q0, np.zeros((B, 7))), noise=noise)
    bn = trollout.rollout_batch(env_n, tcfg, tp, tt, None, B, horizon=T,
                                state0=env_n.state_from_qpos_qvel(
                                    q0, np.zeros((B, 7))), noise=noise)
    mask = bt["mask"]
    lengths = mask.sum(1).long()
    assert bool((mask[:, :-1] >= mask[:, 1:]).all())          # a prefix
    assert 0 < int(bt["terminated"].sum()) and int(lengths.min()) < T
    assert bool((bt["terminated"] | (lengths == T)).all())
    close(bt["rewards"] * (1 - mask), torch.zeros_like(mask), 0.0)
    for i in range(B):
        n = int(lengths[i])
        close(bt["observations"][i, :n], bn["observations"][i, :n], 0.0)
        close(bt["rewards"][i, :n], bn["rewards"][i, :n], 0.0)
        if n < T:
            close(bt["observations"][i, n:],
                  bt["last_obs"][i].expand(T - n, 12), 0.0)
    paths = trollout.paths_to_list(bt)
    assert [len(p["rewards"]) for p in paths] == lengths.tolist()
    assert [p["terminated"] for p in paths] == bt["terminated"].tolist()


def test_sample_paths_and_samples_mode(envs):
    _, tenv = envs
    pol = tpol.MLP(tenv.spec, hidden_sizes=HID, dtype=torch.float64,
                   device="cpu")
    paths = trollout.sample_paths(3, tenv, pol, horizon=5, base_seed=1)
    assert len(paths) == 3
    p = paths[0]
    assert p["observations"].shape == (5, 12) and p["actions"].shape == (5, 4)
    assert p["rewards"].shape == (5,) and p["terminated"] is False
    assert set(p["agent_infos"]) == {"mean", "log_std", "evaluation"}
    again = trollout.sample_paths(3, tenv, pol, horizon=5, base_seed=1)
    close(again[2]["actions"], paths[2]["actions"], 0.0)
    ev = trollout.sample_paths(2, tenv, pol, horizon=5, eval_mode=True)
    close(ev[0]["actions"], ev[0]["agent_infos"]["mean"], 0.0)
    assert trollout.num_traj_for_samples(95, 10) == 10
    assert trollout.num_traj_for_samples(1, 10) == 1
    got = trollout.sample_data_batch(23, tenv, pol, horizon=5)
    assert sum(len(p["rewards"]) for p in got) >= 23


@pytest.mark.parametrize("kwargs, match", [
    pytest.param({"autoreset": True}, None, id="kwargs0-queue 1"),
    pytest.param({"mesh": 2}, "M11", id="kwargs1-M11")])
def test_unported_rollout_options_raise(envs, policies, kwargs, match):
    """Both options, once refused, run.  ``autoreset`` (queue 1): on the
    Swimmer, which never ends an episode, it is the plain rollout with a
    ``dones`` grid of zeros.  ``mesh`` (M11): the rows of rank r of 2 are
    the plain rollout's rows r * B / 2 ... (r + 1) * B / 2 exactly (the
    drawn resets and noise are the whole batch's) and issue no collective,
    and a one-rank mesh is the plain rollout."""
    _, tenv = envs
    _, (tcfg, tp, tt) = policies
    roll = lambda n=2, **kw: trollout.rollout_batch(
        tenv, tcfg, tp, tt, torch.Generator().manual_seed(3), n, horizon=2,
        **kw)
    if match is not None:     # B rows: a rank's policy forward is a GEMM
        plain = roll(B)
        halves = [roll(B, mesh=RowsOnly(r, kwargs["mesh"]))
                  for r in range(kwargs["mesh"])]
        for k in ("observations", "actions", "rewards", "mask", "last_obs"):
            close(torch.cat([h[k] for h in halves]), plain[k], 0.0)
            close(roll(B, mesh=make_mesh(device="cpu"))[k], plain[k], 0.0)
        return
    got, plain = roll(**kwargs), roll()
    assert got["dones"].shape == (2, 2)
    assert float(got["dones"].abs().sum()) == 0.0
    for k in ("observations", "actions", "rewards", "mask", "last_obs"):
        close(got[k], plain[k], 0.0)
