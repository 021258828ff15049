"""Port vs JAX package: MPPI planning over learned models (``MPCPolicy``)
and in the real engine (``MPCActor``) on the point mass (CPU, float64).

Every candidate set is the JAX package's own draw (``eps=``: the normal
draws of the key each ``get_action`` splits off); the JAX modules run at
float64 under ``jax_f64``.

- ``MPCPolicy`` with one member and with three (the disagreement bonus:
  the std over members, ddof 0, summed over time and state), three
  warm-started actions each: actions and the shifted sequence at 1e-12;
- ``MPCActor``: three actions from two real-env states, shooting 6
  candidates x 4 RK4 control steps of the general engine: 1e-9, the
  engine's own tolerance over a few steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.algos.model_accel import model_learning_mpc as jmpc
from mjrl_tpu.algos.model_accel import nn_dynamics as jnd
from mjrl_tpu.algos.model_accel import sampling as jsampling
from mjrl_tpu.envs.point_mass import PointMassEnv as JaxPointMass
from mjrl_tpu.models import mpc_actor as jactor
from mjrl_tpu_torch.algos.model_accel.model_learning_mpc import MPCPolicy
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.envs.point_mass import PointMassEnv
from mjrl_tpu_torch.envs.swimmer import SwimmerEnv
from mjrl_tpu_torch.models.mpc_actor import MPCActor

from test_torch_model_accel_npg import ensembles
from test_torch_nn_dynamics import EXACT, Float64Numpy, close

ACT, P, H = 2, 7, 5
COEFS = [np.array([0.8, 1.2]), 0.6, 0.3, 0.1]


@pytest.fixture
def jax_f64(monkeypatch):
    for mod in (jnd, jsampling, jmpc, jactor):
        monkeypatch.setattr(mod, "jnp", Float64Numpy())


def next_eps(holder, shape):
    """The normal draws of the key ``holder``'s next ``get_action`` splits
    off (the holder's key is left as it is)."""
    _, sub = jax.random.split(holder._key)
    return np.asarray(jax.random.normal(sub, shape, jnp.float64))


@pytest.mark.parametrize("members", [1, 3])
def test_mpc_policy_matches_jax(jax_f64, members):
    jens, tens = ensembles(members)
    jfit = jens[0] if members == 1 else jens
    tfit = tens[0] if members == 1 else tens
    kw = dict(plan_horizon=H, plan_paths=P, kappa=5.0, gamma=0.9,
              mean=np.array([0.1, -0.2]), filter_coefs=COEFS, omega=2.0,
              seed=3)
    jp = jmpc.MPCPolicy(JaxPointMass(dtype=jnp.float64), fitted_model=jfit,
                        **kw)
    tp = MPCPolicy(PointMassEnv(dtype=torch.float64, device="cpu"),
                   fitted_model=tfit, **kw)
    rng = np.random.RandomState(members)
    for step in range(3):
        obs = np.concatenate([rng.uniform(-1, 1, 2), rng.normal(0, 0.3, 2),
                              rng.uniform(-1, 1, 2)])
        eps = next_eps(jp, (P, H, ACT))
        want = jp.get_action(obs)
        got = tp.get_action(obs, eps=eps)
        close(got, want, EXACT)
        close(tp.act_sequence, jp.act_sequence, EXACT)
    close(tp.act_sequence[-1], kw["mean"], 0.0)


def state_of(seed):
    env = GymEnv("mjrl_point_mass-v0", device="cpu",
                 env_kwargs={"dtype": torch.float64})
    env.reset(seed=seed)
    for a in ([0.7, -0.4], [-0.2, 0.9]):
        env.step(np.array(a))
    return env.get_env_state()


def test_mpc_actor_matches_jax(jax_f64):
    kw = dict(H=4, paths_per_cpu=3, num_cpu=2, kappa=3.0, gamma=0.95,
              filter_coefs=COEFS, seed=5)
    ja = jactor.MPCActor(JaxPointMass(dtype=jnp.float64), **kw)
    ta = MPCActor(PointMassEnv(dtype=torch.float64, device="cpu"), **kw)
    assert ta.num_candidates == 6
    for seed in (0, 1, 1):
        s = state_of(seed)
        eps = next_eps(ja, (6, 4, ACT))
        want = ja.get_action(s)
        got = ta.get_action(s, eps=eps)
        assert got.shape == (ACT,)
        close(got, want, 1e-9)
    assert ta.ctr == ja.ctr == 4


def test_mpc_actor_on_the_swimmer_and_drawn_candidates():
    """The planar path (the smooth step's plain version here; K1 on the
    card): drawn candidates, a finite first action."""
    env = GymEnv("mjrl_swimmer-v0", device="cpu")
    env.reset(seed=0)
    actor = MPCActor(env, H=3, paths_per_cpu=4, kappa=10.0,
                     filter_coefs=[np.ones(env.action_dim), 0.05, 0.0, 0.0])
    a = actor.get_action(env.get_env_state())
    assert a.shape == (env.action_dim,) and np.isfinite(a).all()
    assert isinstance(actor.fenv, SwimmerEnv)
