"""Port vs JAX package: model-space rollouts, the MPPI perturbations and the
reward registry (CPU, float64).

The JAX modules run at float64 under the ``jax_f64`` fixture of
``test_torch_nn_dynamics``; every random draw is the JAX package's own
(``noise=``, ``eps=``), taken from the key as the JAX function splits it.
Tolerance 1e-12: the same forwards step by step (the perturbation filter
is a recurrence in the JAX package and one (H, H) matrix in the port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.algos.model_accel import reward_functions as jrf
from mjrl_tpu.algos.model_accel import sampling as jsampling
from mjrl_tpu.envs.point_mass import PointMassEnv as JaxPointMass
from mjrl_tpu.models import policies as jpol
from mjrl_tpu.models.fc_network import Transforms as JTransforms
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos.model_accel import reward_functions as trf
from mjrl_tpu_torch.algos.model_accel import sampling as tsampling
from mjrl_tpu_torch.envs.base import EnvSpec
from mjrl_tpu_torch.envs.point_mass import PointMassEnv
from mjrl_tpu_torch.models import policies as tpol

from test_torch_nn_dynamics import (A, D, EXACT, Float64Numpy, close, data,
                                    pair)

N, H = 5, 6


@pytest.fixture
def jax_f64(monkeypatch):
    from mjrl_tpu.algos.model_accel import nn_dynamics as jnd
    for mod in (jnd, jsampling):
        monkeypatch.setattr(mod, "jnp", Float64Numpy())


def policy_pair(seed=0):
    spec = EnvSpec(D, A, 25)
    rng = np.random.RandomState(seed)
    sizes = (D, 8, A)
    p_np = {"layers": [{"w": rng.normal(0, 0.5, (sizes[i], sizes[i + 1])),
                        "b": rng.normal(0, 0.2, (sizes[i + 1],))}
                       for i in range(2)],
            "log_std": np.array([-0.3, 0.2])}
    tr = (rng.normal(0, 0.3, D), rng.uniform(0.5, 2, D), np.zeros(A),
          np.ones(A))
    jp = jpol.MLP(spec, hidden_sizes=(8,))
    jp.params = jax.tree_util.tree_map(jnp.asarray, p_np)
    jp.transforms = JTransforms(*(jnp.asarray(t) for t in tr))
    tp = tpol.MLP(spec, hidden_sizes=(8,), dtype=torch.float64, device="cpu")
    convert.policy_params_from_numpy(tp, p_np, tr)
    return jp, tp


def jax_rollout_noise(key, n, horizon):
    """The action noise ``policy_rollout`` draws from ``key`` (n, H, A)."""
    return np.stack([np.stack([np.asarray(jax.random.normal(kt, (A,),
                                                            jnp.float64))
                               for kt in jax.random.split(k, horizon)])
                     for k in jax.random.split(key, n)])


@pytest.mark.parametrize("eval_mode", [False, True],
                         ids=["stochastic", "eval"])
def test_policy_rollout_with_bounds_matches_jax(jax_f64, eval_mode):
    jm, tm = pair(seed=1)
    jp, tp = policy_pair()
    s0, _, _ = data(11, N)
    key = jax.random.PRNGKey(5)
    bounds = dict(s_min=-0.8 * np.ones(D), s_max=np.full(D, 0.9),
                  a_min=np.array([-0.5, -2.0]), a_max=np.array([0.4, 2.0]))
    jenv = JaxPointMass(dtype=jnp.float64)
    want = jsampling.policy_rollout(N, jenv, jp, jm, init_state=s0,
                                    eval_mode=eval_mode, horizon=H, key=key,
                                    **bounds)
    got = tsampling.policy_rollout(
        N, PointMassEnv(dtype=torch.float64, device="cpu"), tp, tm,
        init_state=s0, eval_mode=eval_mode, horizon=H,
        noise=jax_rollout_noise(key, N, H), **bounds)
    for k in ("observations", "actions"):
        assert tuple(got[k].shape) == want[k].shape
        close(got[k], want[k], EXACT)
    acts = got["actions"].numpy()
    assert (acts[..., 0] == 0.4).any() or (acts[..., 0] == -0.5).any()
    assert (got["observations"].numpy()[:, 1:] <= 0.9).all()
    # without bounds: the +-1e2 default, and a single start state
    want = jsampling.policy_rollout(N, jenv, jp, jm, init_state=s0[0],
                                    eval_mode=eval_mode, horizon=H, key=key)
    got = tsampling.policy_rollout(
        N, PointMassEnv(dtype=torch.float64, device="cpu"), tp, tm,
        init_state=s0[0], eval_mode=eval_mode, horizon=H,
        noise=jax_rollout_noise(key, N, H))
    close(got["observations"], want["observations"], EXACT)


def test_trajectory_rollout_and_discount_sum_match_jax(jax_f64):
    jm, tm = pair(seed=2)
    acts = np.random.RandomState(3).normal(size=(N, H, A))
    s0 = data(4, N)[0]
    for start in (s0, s0[2]):
        want = jsampling.trajectory_rollout(acts, jm, start)
        got = tsampling.trajectory_rollout(acts, tm, start)
        close(got["observations"], want["observations"], EXACT)
        close(got["actions"], acts, 0.0)
    x = np.random.RandomState(5).normal(size=9)
    close(tsampling.discount_sum(x, 0.9, 0.3),
          jsampling.discount_sum(x, 0.9, 0.3), 0.0)


@pytest.mark.parametrize("h", [1, 2, 10])
def test_perturbed_actions_match_jax(jax_f64, h):
    rng = np.random.RandomState(h)
    base = rng.normal(size=(h, A))
    coefs = [np.array([0.7, 1.3]), 0.6, 0.3, 0.1]
    # numpy: the same stream under one RandomState; like the JAX
    # package's, it needs two steps at least
    if h == 1:
        for fn in (tsampling.generate_perturbed_actions,
                   jsampling.generate_perturbed_actions):
            with pytest.raises(IndexError):
                fn(base.copy(), coefs, np.random.RandomState(7))
    else:
        close(tsampling.generate_perturbed_actions(
                  base.copy(), coefs, np.random.RandomState(7)),
              jsampling.generate_perturbed_actions(
                  base.copy(), coefs, np.random.RandomState(7)), 0.0)
    # batched: the JAX draws injected
    P, key = 6, jax.random.PRNGKey(h)
    want = jsampling.generate_perturbed_actions_batch(
        key, jnp.asarray(base), coefs, P)
    eps = np.asarray(jax.random.normal(key, (P, h, A), jnp.float64))
    got = tsampling.generate_perturbed_actions_batch(
        None, torch.tensor(base), coefs, P, eps=eps)
    assert tuple(got.shape) == want.shape == (P, h, A)
    close(got, want, EXACT)
    # the filter applied row by row, as the numpy version does
    raw = base + eps * coefs[0]
    close(got[:, 0], raw[:, 0] * 1.0, EXACT)
    if h > 1:
        close(got[:, 1], 0.6 * raw[:, 1] + 0.4 * raw[:, 0], EXACT)
    # drawn from a generator: finite, the right shape
    drawn = tsampling.generate_perturbed_actions_batch(
        torch.Generator().manual_seed(0), torch.tensor(base), coefs, P)
    assert drawn.shape == (P, h, A) and torch.isfinite(drawn).all()


def test_reward_registry_matches_jax():
    rng = np.random.RandomState(6)
    pm = rng.normal(size=(3, 7, 6))
    jpaths = jrf.get_reward_function("mjrl_point_mass-v0")(
        {"observations": jnp.asarray(pm)})
    tpaths = trf.get_reward_function("mjrl_point_mass-v0")(
        {"observations": torch.tensor(pm)})
    close(tpaths["rewards"], jpaths["rewards"], EXACT)
    # the r(s, a) = r(s') shift, the last step its own
    plain = PointMassEnv.reward_fn(torch.tensor(pm)).numpy()
    close(tpaths["rewards"][:, :-1], plain[:, 1:], 0.0)
    close(tpaths["rewards"][:, -1], plain[:, -1], 0.0)
    # the env's own batched reward is the same function
    env = PointMassEnv(dtype=torch.float64, device="cpu")
    close(env.compute_path_rewards({"observations": torch.tensor(pm)})[
        "rewards"], jpaths["rewards"], EXACT)

    re = rng.normal(0, 4, size=(2, 5, 20))
    close(trf.get_reward_function("mjrl_reacher_7dof-v0")(
              {"observations": torch.tensor(re)})["rewards"],
          jrf.get_reward_function("mjrl_reacher_7dof-v0")(
              {"observations": jnp.asarray(re)})["rewards"], EXACT)
    # peg insertion: some peg bottoms within the 0.06 bonus radius of the
    # target, some beyond the [-10, 10] clip
    pg = rng.normal(0, 4, size=(3, 6, 20))
    pg[:, ::2, -3:] = pg[:, ::2, -6:-3] + rng.normal(0, 0.02, (3, 3, 3))
    pg[:, ::2, -6:-3] = np.clip(pg[:, ::2, -6:-3], -9.0, 9.0)
    pg[:, ::2, -3:] = np.clip(pg[:, ::2, -3:], -9.0, 9.0)
    want = jrf.get_reward_function("mjrl_peg_insertion-v0")(
        {"observations": jnp.asarray(pg)})["rewards"]
    assert 0 < int((np.asarray(want) > 0).sum()) < want.size
    close(trf.get_reward_function("mjrl_peg_insertion-v0")(
              {"observations": torch.tensor(pg)})["rewards"], want, EXACT)
    assert trf.get_reward_function("no-such-env") is None
