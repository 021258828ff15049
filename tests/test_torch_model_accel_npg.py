"""Port vs JAX package: ``ModelAccelNPG`` on imagined rollouts (CPU,
float64).

Two agents around the same point-mass policy, the same two-member world
model ensemble, the registry's point-mass reward and a linear baseline;
each ``train_step`` starts from the same given states, and every member's
action noise is the JAX draw of the key that member's rollout takes
(``noise=``).  The JAX modules run at float64 under ``jax_f64``.

- ``_disagreement_truncation`` on the same paths at three limits: no cut,
  cuts past the floor, and first violations before step 3 held at the
  4-step floor, with the bonus on the last kept step (exact);
- two ``train_step``s with truncation: the new policy and every logged
  statistic (1e-7: ten CG iterations and a least-squares fit amplify
  last-digit differences, to 1.4e-8 in the first step's weights; the
  second step's paths follow from them); the baseline's values off its
  data (1e-5, the least-squares solve's conditioning).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import baselines as jhost
from mjrl_tpu.algos.model_accel import model_accel_npg as jmanpg
from mjrl_tpu.algos.model_accel import nn_dynamics as jnd
from mjrl_tpu.algos.model_accel import reward_functions as jrf
from mjrl_tpu.algos.model_accel import sampling as jsampling
from mjrl_tpu.envs.point_mass import PointMassEnv as JaxPointMass
from mjrl_tpu.models import policies as jpol
from mjrl_tpu.models.fc_network import Transforms as JTransforms
from mjrl_tpu_torch import baselines as thost
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos.model_accel import nn_dynamics as tnd
from mjrl_tpu_torch.algos.model_accel import reward_functions as trf
from mjrl_tpu_torch.algos.model_accel.model_accel_npg import ModelAccelNPG
from mjrl_tpu_torch.envs.point_mass import PointMassEnv
from mjrl_tpu_torch.models import policies as tpol

from test_torch_model_sampling import jax_rollout_noise
from test_torch_nn_dynamics import Float64Numpy, close, numpy_layers
from test_torch_npg import close_tree

OBS, ACT, M, N, T = 6, 2, 2, 6, 8
UPDATE_TOL = 1e-7


@pytest.fixture
def jax_f64(monkeypatch):
    for mod in (jnd, jsampling, jmanpg):
        monkeypatch.setattr(mod, "jnp", Float64Numpy())


def ensembles(num_models=M):
    jens = jnd.WorldModelEnsemble(num_models, OBS, ACT, seed=0,
                                  hidden_size=(16,))
    tens = tnd.WorldModelEnsemble(num_models, OBS, ACT, seed=0,
                                  hidden_size=(16,),
                                  device="cpu", dtype=torch.float64)
    for i, (jm, tm) in enumerate(zip(jens, tens)):
        rng = np.random.RandomState(30 + i)
        layers = numpy_layers(40 + i, OBS + ACT, OBS, (16,))
        for l in layers:
            l["w"] *= 0.4
        tr = {"s_shift": rng.normal(0, 0.2, OBS),
              "s_scale": rng.uniform(0.5, 1.5, OBS),
              "a_shift": np.zeros(ACT), "a_scale": np.ones(ACT),
              "out_shift": rng.normal(0, 0.02, OBS),
              "out_scale": rng.uniform(0.02, 0.1, OBS)}
        jm.dyn_params = jax.tree_util.tree_map(jnp.asarray, layers)
        jm.dyn_tr = jax.tree_util.tree_map(jnp.asarray, tr)
        convert.world_model_from_numpy(tm, layers, tr)
    return jens, tens


@pytest.fixture
def agents(jax_f64):
    jens, tens = ensembles()
    spec = PointMassEnv(device="cpu").spec
    rng = np.random.RandomState(1)
    sizes = (OBS, 16, ACT)
    p_np = {"layers": [{"w": rng.normal(0, 0.5, (sizes[i], sizes[i + 1])),
                        "b": rng.normal(0, 0.1, (sizes[i + 1],))}
                       for i in range(2)],
            "log_std": np.array([-0.5, -0.2])}
    jp = jpol.MLP(spec, hidden_sizes=(16,))
    jp.params = jp.old_params = jax.tree_util.tree_map(jnp.asarray, p_np)
    jp.transforms = JTransforms(*(jnp.asarray(np.asarray(t, np.float64))
                                  for t in jp.transforms))
    tp = tpol.MLP(spec, hidden_sizes=(16,), dtype=torch.float64,
                  device="cpu")
    convert.policy_params_from_numpy(tp, p_np)
    kw = dict(normalized_step_size=0.05, seed=0, save_logs=True)
    jagent = jmanpg.ModelAccelNPG(
        learned_model=jens, env=JaxPointMass(dtype=jnp.float64), policy=jp,
        baseline=jhost.LinearBaseline(spec),
        reward_function=jrf.point_mass_reward, **kw)
    tagent = ModelAccelNPG(
        learned_model=tens,
        env=PointMassEnv(dtype=torch.float64, device="cpu"), policy=tp,
        baseline=thost.LinearBaseline(spec, dtype=torch.float64,
                                      device="cpu"),
        reward_function=trf.point_mass_reward, device="cpu", **kw)
    return jagent, tagent


def start_states(seed):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.uniform(-1, 1, (N, 2)),
                           rng.normal(0, 0.3, (N, 2)),
                           rng.uniform(-1, 1, (N, 2))], axis=1)


def next_keys(key, n):
    """The keys n calls of the agent's ``_next_key`` give, and the key
    after them."""
    out = []
    for _ in range(n):
        key, k = jax.random.split(key)
        out.append(k)
    return out, key


def test_disagreement_truncation_matches_jax_with_floor_and_bonus(agents):
    jagent, tagent = agents
    rng = np.random.RandomState(2)
    obs = rng.normal(0, 0.5, (12, T, OBS))
    obs[:, 1:] = obs[:, :-1] + rng.normal(0, 0.05, (12, T - 1, OBS))
    act = rng.normal(0, 1, (12, T, ACT))
    rew = rng.normal(size=(12, T))
    T64 = lambda x: torch.tensor(x, dtype=torch.float64)
    mask = np.ones((12, T))
    err = np.max([np.mean((obs[:, 1:] - m.predict(
        obs[:, :-1].reshape(-1, OBS), act[:, :-1].reshape(-1, ACT)
    ).reshape(12, T - 1, OBS)) ** 2, -1) for m in tagent.learned_model],
        axis=0)
    seen_floor = seen_cut = False
    for lim in (err.max() + 1.0, np.quantile(err, 0.8),
                np.quantile(err, 0.3)):
        want = jagent._disagreement_truncation(
            jnp.asarray(obs), jnp.asarray(act), jnp.asarray(rew),
            jnp.asarray(mask), jnp.zeros(12, bool), lim, -2.5)
        got = tagent._disagreement_truncation(
            T64(obs), T64(act), T64(rew), T64(mask),
            torch.zeros(12, dtype=torch.bool), lim, -2.5)
        for g, w in zip(got, want):
            close(g.to(torch.float64), np.asarray(w, np.float64), 0.0)
        first = np.argmax(err > lim, axis=1)
        hit = (err > lim).any(1)
        kept = got[1].sum(1).numpy()
        np.testing.assert_array_equal(
            kept, np.where(hit, np.maximum(first + 1, 4), T))
        seen_floor |= bool((hit & (first < 3)).any())
        seen_cut |= bool((hit & (first >= 3) & (first + 1 < T)).any())
        bonus = (got[0] - T64(rew)).numpy()
        np.testing.assert_array_equal(
            bonus.sum(1), np.where(hit & (kept < T), -2.5, 0.0))
        assert got[2].numpy().tolist() == (hit & (kept < T)).tolist()
    assert seen_floor and seen_cut


def test_train_step_matches_jax(agents):
    jagent, tagent = agents
    for it in range(2):
        s0 = start_states(10 + it)
        keys, _ = next_keys(jagent.key, M)
        noise = np.stack([jax_rollout_noise(k, N, T) for k in keys])
        kw = dict(N=N, init_states=s0, horizon=T, gamma=0.95,
                  gae_lambda=0.97, truncate_lim=5e-4, truncate_reward=-1.0)
        want = jagent.train_step(**kw)
        got = tagent.train_step(noise=noise, **kw)
        close(got, want, UPDATE_TOL)
        assert got[-1] == N
        close_tree(tagent.policy.params, jagent.policy.params,
                   UPDATE_TOL)
        # the baseline's values away from its data, at 1e-5: the time
        # features (t / 1000)^k of an 8-step path are tiny, and the solve's
        # condition number (~1e10) amplifies last-digit differences in its
        # coefficients (on its data: VF_error_after, below, at 1e-7)
        probe = np.random.RandomState(it).normal(size=(3, T, OBS))
        close(tagent.baseline.cfg.predict(tagent.baseline.state,
                                          torch.tensor(probe)),
              jagent.baseline.cfg.predict(jagent.baseline.state,
                                          jnp.asarray(probe)), 1e-5)
        jl, tl = jagent.logger.log, tagent.logger.log
        assert sorted(jl) == sorted(tl)
        for k in ("alpha", "delta", "kl_dist", "surr_improvement",
                  "stoc_pol_mean", "stoc_pol_std", "stoc_pol_min",
                  "stoc_pol_max", "running_score", "VF_error_before",
                  "VF_error_after"):
            close(tl[k][-1], jl[k][-1], UPDATE_TOL)
        assert tl["num_samples"][-1] == jl["num_samples"][-1]
    # the limit cut some of the M * N imagined paths, none below 4 steps
    assert M * N * 4 <= tl["num_samples"][-1] < M * N * T


def test_train_step_from_resets_and_learned_reward():
    """Without init states the env resets; with a reward head the rewards
    are the head's.  N * M * T samples, finite statistics."""
    tens = tnd.WorldModelEnsemble(M, OBS, ACT, seed=3, hidden_size=(8,),
                                  learn_reward=True, device="cpu",
                                  dtype=torch.float64)
    env = PointMassEnv(dtype=torch.float64, device="cpu")
    policy = tpol.MLP(env.spec, hidden_sizes=(8,), dtype=torch.float64,
                      device="cpu")
    agent = ModelAccelNPG(
        learned_model=tens, env=env, policy=policy,
        baseline=thost.LinearBaseline(env.spec, dtype=torch.float64,
                                      device="cpu"),
        normalized_step_size=0.05, save_logs=True, device="cpu")
    stats = agent.train_step(N=3, horizon=5)
    assert agent.logger.log["num_samples"] == [M * 3 * 5]
    assert np.all(np.isfinite(stats))
    with pytest.raises(ValueError, match="learned dynamics"):
        ModelAccelNPG(env=env, policy=policy, baseline=agent.baseline,
                      device="cpu")
