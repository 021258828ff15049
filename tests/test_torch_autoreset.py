"""Port vs JAX package: autoreset rollouts and their processing (CPU,
float64).

- The four done-aware scans against the JAX package's on the same
  numpy-seeded grid (1e-12: the same recurrences in the same order).
- The autoreset rollout on the Swimmer (no episode ends) and on Hopper-v3
  (episodes end and restart inside the grid), horizon 8, against a loop over
  the JAX env's vmapped ``step`` that follows the JAX rollout's autoreset
  branch (a fresh state taken row by row where ``done``), with the same
  injected action noise and fresh states (1e-8: a step's last-digit
  differences fed back through policy and physics 8 times).
- ``paths_to_list`` on the same numpy autoreset batch (exact).
- The autoreset ``process`` (values over [obs, last_obs], done-aware GAE,
  unmasked whitening, per-episode mean return) against the JAX agent's
  ``_get_phases(...)[1]`` on the same batch with an MLP baseline carried
  across (1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import baselines as jhost
from mjrl_tpu.algos.npg_cg import NPG as JaxNPG
from mjrl_tpu.envs import gym_suite as jsuite
from mjrl_tpu.envs.swimmer import SwimmerEnv as JaxSwimmerEnv
from mjrl_tpu.models import policies as jpol
from mjrl_tpu.models.fc_network import \
    identity_transforms as jax_identity_transforms
from mjrl_tpu.ops import gae as jgae
from mjrl_tpu.physics.model import State as JState
from mjrl_tpu.samplers import rollout as jrollout
from mjrl_tpu_torch import baselines as thost
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos import NPG
from mjrl_tpu_torch.envs import gym_suite as tsuite
from mjrl_tpu_torch.envs.swimmer import SwimmerEnv
from mjrl_tpu_torch.models import policies as tpol
from mjrl_tpu_torch.ops import gae as tgae
from mjrl_tpu_torch.samplers import rollout as trollout

from test_torch_gym_suite import _start_table
from test_torch_policy import numpy_params, to_jax
from test_torch_mjcf_m9b import one_torch_thread  # noqa: F401

B, T, HID = 16, 8, (8, 8)
SCAN_TOL, ROLLOUT_TOL, PROCESS_TOL = 1e-12, 1e-8, 1e-10
GAMMA, LAM = 0.995, 0.97


def close(a, b, tol):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# done-aware scans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid():
    """rewards, values, dones (several episodes per row, some rows with
    none, one ending on the last step), v_last."""
    rng = np.random.RandomState(3)
    r = rng.normal(size=(6, 12))
    v = rng.normal(size=(6, 12))
    d = (rng.uniform(size=(6, 12)) < 0.25).astype(np.float64)
    d[0] = 0.0
    d[1, -1] = 1.0
    return r, v, d, rng.normal(size=6)


SCANS = {
    "returns_with_dones": (
        lambda r, v, d, vl: tgae.returns_with_dones(r, d, 0.97),
        lambda r, v, d, vl: jax.vmap(jgae.returns_with_dones,
                                     (0, 0, None))(r, d, 0.97)),
    "gae_with_dones": (
        lambda r, v, d, vl: tgae.gae_with_dones(r, v, d, vl, 0.97, 0.9),
        lambda r, v, d, vl: jax.vmap(jgae.gae_with_dones,
                                     (0, 0, 0, 0, None, None))(
            r, v, d, vl, 0.97, 0.9)),
    "batched_returns_dones": (
        lambda r, v, d, vl: tgae.batched_returns_dones(r, d, 0.99),
        lambda r, v, d, vl: jgae.batched_returns_dones(r, d, 0.99)),
    "batched_gae_dones": (
        lambda r, v, d, vl: tgae.batched_gae_dones(r, v, d, vl, 0.99, 0.95),
        lambda r, v, d, vl: jgae.batched_gae_dones(r, v, d, vl, 0.99, 0.95)),
}


@pytest.mark.parametrize("name", list(SCANS))
def test_done_aware_scans_match_jax(grid, name):
    port, ref = SCANS[name]
    got = port(*(torch.tensor(a) for a in grid))
    want = ref(*(jnp.asarray(a) for a in grid))
    assert got.shape == grid[0].shape
    close(got, want, SCAN_TOL)
    if name.endswith("returns_with_dones"):
        # the chain is cut at every episode end: the return there is its
        # own reward
        r, _, d, _ = grid
        close(got[torch.tensor(d) > 0], r[d > 0], 0.0)


# ---------------------------------------------------------------------------
# autoreset rollouts against a JAX loop
# ---------------------------------------------------------------------------

_JAX_STATES = {}          # id(jenv) -> (jenv, its jitted jax_states)


def jax_states(jenv, qpos, qvel):
    """A batched JAX EnvState at (qpos, qvel): a fresh reset (t = 0, reward
    0, done False) with the physics and observation replaced; traced once
    per env (the loop below takes a fresh batch at every step)."""
    if id(jenv) not in _JAX_STATES:
        def states(qpos, qvel):
            s = jax.vmap(jenv.reset)(jax.random.split(
                jax.random.PRNGKey(0), qpos.shape[0]))
            physics = JState(qpos=qpos, qvel=qvel)
            obs = jax.vmap(lambda p: jenv._obs(None, {}, p))(physics)
            return s.replace(physics=physics, obs=obs)
        _JAX_STATES[id(jenv)] = (jenv, jax.jit(states))
    return _JAX_STATES[id(jenv)][1](jnp.asarray(qpos), jnp.asarray(qvel))


def jax_autoreset_loop(jenv, jcfg, jparams, jtr, state0, noise, resets):
    """The autoreset branch of the JAX rollout (``rollout.py:114-129``) as a
    host loop over the vmapped env step, with injected noise and fresh
    states."""
    step = jax.jit(jax.vmap(jenv.step))
    where = jax.jit(jax.vmap(lambda d, a, b: jax.tree_util.tree_map(
        lambda x, y: jnp.where(d, x, y), a, b)))
    s = state0
    out = {k: [] for k in ("observations", "actions", "rewards",
                           "agent_mean", "dones")}
    for t in range(noise.shape[0]):
        mean, log_std = jcfg.dist_info(jparams, jtr, s.obs)
        action = mean + jnp.exp(log_std) * jnp.asarray(noise[t])
        ns = step(s, action)
        for k, v in (("observations", s.obs), ("actions", action),
                     ("rewards", ns.reward), ("agent_mean", mean),
                     ("dones", ns.done.astype(jnp.float64))):
            out[k].append(np.asarray(v))
        s = where(ns.done, jax_states(jenv, resets[0][t], resets[1][t]), ns)
    out = {k: np.stack(v, axis=1) for k, v in out.items()}
    # the final carry: rows that end at the last step carry a fresh state
    out["last_obs"] = np.asarray(s.obs)
    out["terminated"] = out["dones"][:, -1] > 0
    return out


def compare_rollouts(tb, jb):
    for k in ("observations", "actions", "rewards", "agent_mean", "dones",
              "last_obs"):
        close(tb[k], jb[k], ROLLOUT_TOL)
    assert tb["terminated"].tolist() == jb["terminated"].tolist()
    assert float(tb["mask"].min()) == 1.0


def rollout_pair(jenv, tenv, obs_dim, act_dim, q0, v0, resets, seed):
    p_np = numpy_params(seed, HID, obs=obs_dim, act=act_dim)
    p_np["log_std"] = np.full(act_dim, -1.0)
    for k in ("w", "b"):                # gentle actions
        p_np["layers"][-1][k] = 0.1 * p_np["layers"][-1][k]
    noise = np.random.RandomState(seed).normal(size=(T, B, act_dim))
    jcfg = jpol.GaussianMLP(obs_dim, act_dim, HID)
    jtr = jax_identity_transforms(obs_dim, act_dim, jnp.float64)
    jb = jax_autoreset_loop(jenv, jcfg, to_jax(p_np), jtr,
                            jax_states(jenv, q0, v0), noise, resets)
    tpolicy = tpol.MLP(tenv.spec, hidden_sizes=HID, dtype=torch.float64,
                       device="cpu")
    convert.policy_params_from_numpy(tpolicy, p_np)
    tb = trollout.rollout_batch(
        tenv, tpolicy.config, tpolicy.params, tpolicy.transforms, None, B,
        horizon=T, autoreset=True, state0=tenv.state_from_qpos_qvel(q0, v0),
        noise=torch.tensor(noise), resets=resets)
    return tb, jb, p_np


def hopper_resets():
    """Fresh states for every (step, environment), from the start table:
    half of its rows leave the healthy range within a few steps, so rows
    hold several episodes."""
    q, v = _start_table()
    idx = (np.arange(T)[:, None] * 3 + np.arange(B)[None] * 5) % 8
    return q[idx], v[idx]


@pytest.fixture(scope="module")
def hopper_batch():
    jenv = jsuite.HopperEnv(dtype=jnp.float64)
    tenv = tsuite.HopperEnv(dtype=torch.float64, device="cpu")
    q0, v0 = (np.tile(a, (B // 8, 1)) for a in _start_table())
    return rollout_pair(jenv, tenv, 11, 3, q0, v0, hopper_resets(), 41)


def test_hopper_autoreset_rollout_matches_jax_loop(hopper_batch):
    tb, jb, _ = hopper_batch
    compare_rollouts(tb, jb)
    dones = tb["dones"]
    # episodes end and restart inside the grid, several in some rows
    assert int(dones.sum()) >= B // 2 and float(dones.sum(1).max()) >= 2
    assert tb["terminated"].tolist() == (dones[:, -1] > 0).tolist()
    # after a done the next observation is the injected fresh state's
    rq, rv = hopper_resets()
    b, t = map(int, torch.nonzero(dones[:, :-1] > 0)[0])
    fresh = np.concatenate([rq[t, b, 1:], np.clip(rv[t, b], -10, 10)])
    close(tb["observations"][b, t + 1], fresh, 0.0)


def test_swimmer_autoreset_rollout_matches_jax_loop():
    """The Swimmer never ends an episode: the autoreset grid is the plain
    rollout's, with dones all zero."""
    jenv = JaxSwimmerEnv(dtype=jnp.float64)
    tenv = SwimmerEnv(dtype=torch.float64, device="cpu")
    rng = np.random.RandomState(2)
    q0 = rng.uniform(-0.3, 0.3, (B, 7))
    v0 = rng.uniform(-0.5, 0.5, (B, 7))
    resets = (np.zeros((T, B, 7)), np.zeros((T, B, 7)))
    tb, jb, p_np = rollout_pair(jenv, tenv, 12, 4, q0, v0, resets, 43)
    compare_rollouts(tb, jb)
    assert float(tb["dones"].abs().sum()) == 0.0
    assert not bool(tb["terminated"].any())
    policy = tpol.MLP(tenv.spec, hidden_sizes=HID, dtype=torch.float64,
                      device="cpu")
    convert.policy_params_from_numpy(policy, p_np)
    plain = trollout.rollout_batch(
        tenv, policy.config, policy.params, policy.transforms, None, B,
        horizon=T, state0=tenv.state_from_qpos_qvel(q0, v0),
        noise=tb["actions"].new_tensor(
            np.random.RandomState(43).normal(size=(T, B, 4))))
    for k in ("observations", "actions", "rewards", "last_obs"):
        close(tb[k], plain[k], 0.0)


def test_resets_hook_takes_a_callable(hopper_batch):
    tb, _, p_np = hopper_batch
    tenv = tsuite.HopperEnv(dtype=torch.float64, device="cpu")
    policy = tpol.MLP(tenv.spec, hidden_sizes=HID, dtype=torch.float64,
                      device="cpu")
    convert.policy_params_from_numpy(policy, p_np)
    rq, rv = hopper_resets()
    q0, v0 = (np.tile(a, (B // 8, 1)) for a in _start_table())
    again = trollout.rollout_batch(
        tenv, policy.config, policy.params, policy.transforms, None, B,
        horizon=T, autoreset=True, state0=tenv.state_from_qpos_qvel(q0, v0),
        noise=torch.tensor(np.random.RandomState(41).normal(size=(T, B, 3))),
        resets=lambda t: tenv.state_from_qpos_qvel(rq[t], rv[t]))
    for k in ("observations", "rewards", "dones"):
        close(again[k], tb[k], 0.0)


# ---------------------------------------------------------------------------
# paths_to_list and process
# ---------------------------------------------------------------------------

def test_paths_to_list_splits_episodes_as_jax(hopper_batch):
    tb, _, _ = hopper_batch
    nb = {k: (v.numpy() if torch.is_tensor(v) else
              {kk: vv.numpy() for kk, vv in v.items()})
          for k, v in tb.items()}
    got = trollout.paths_to_list(tb)
    want = jrollout.paths_to_list(nb)
    assert len(got) == len(want) == int(tb["dones"].sum()) + int(
        (tb["dones"][:, -1] == 0).sum())
    assert sum(len(p["rewards"]) for p in got) == B * T
    for g, w in zip(got, want):
        assert g["terminated"] == w["terminated"]
        assert set(g) == set(w) and set(g["agent_infos"]) == \
            set(w["agent_infos"])
        for k in ("observations", "actions", "rewards"):
            close(g[k], w[k], 0.0)
        close(g["agent_infos"]["mean"], w["agent_infos"]["mean"], 0.0)
        close(g["agent_infos"]["log_std"], w["agent_infos"]["log_std"], 0.0)


def mlp_baseline_layers(seed):
    rng = np.random.RandomState(seed)
    sizes = (15, 16, 16, 1)
    return [{"w": rng.normal(0, 0.4, (sizes[i], sizes[i + 1])),
             "b": rng.normal(0, 0.5, (sizes[i + 1],))}
            for i in range(3)]


@pytest.mark.parametrize("lam", [LAM, None], ids=["gae", "standard"])
def test_autoreset_process_matches_jax_agent(hopper_batch, lam):
    tb, _, p_np = hopper_batch
    jenv = jsuite.HopperEnv(dtype=jnp.float64)
    tenv = tsuite.HopperEnv(dtype=torch.float64, device="cpu")
    layers = mlp_baseline_layers(44)
    jbl = jhost.MLPBaseline(jenv.spec, hidden_sizes=(16, 16))
    jp = jax.tree_util.tree_map(jnp.asarray, layers)
    jbl.state = (jp, jbl.cfg._optimizer().init(jp))
    jpolicy = jpol.MLP(jenv.spec, hidden_sizes=HID)
    jpolicy.params = jpolicy.old_params = to_jax(p_np)
    jagent = JaxNPG(jenv, jpolicy, jbl, autoreset=True)
    tbl = thost.MLPBaseline(tenv.spec, hidden_sizes=(16, 16),
                            dtype=torch.float64, device="cpu")
    convert.mlp_baseline_from_numpy(tbl, layers)
    tpolicy = tpol.MLP(tenv.spec, hidden_sizes=HID, dtype=torch.float64,
                       device="cpu")
    tagent = NPG(tenv, tpolicy, tbl, autoreset=True, device="cpu")
    assert tagent.autoreset and jagent.autoreset

    jbatch = {k: jnp.asarray(v.numpy()) for k, v in tb.items()
              if torch.is_tensor(v)}
    jret, jadv, jpr = jagent._get_phases(B, T, GAMMA, lam)[1](
        jbl.state, jbatch)
    tret, tadv, tpr = tagent._get_phases(B, T, GAMMA, lam)[1](
        tbl.state, tb)
    close(tret, jret, PROCESS_TOL)
    close(tadv, jadv, PROCESS_TOL)
    close(tpr, jpr, PROCESS_TOL)
    assert abs(float(tadv.mean())) < 1e-12
    assert float(tadv.std(unbiased=False)) == pytest.approx(1.0, abs=1e-5)
