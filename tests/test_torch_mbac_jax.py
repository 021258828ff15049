"""Port vs JAX package: MBAC on the point mass (CPU, float64).

Both packages' ``MBAC`` run three ``train_step(num_traj=1)`` with a FIFO
buffer of two paths, over four-step episodes and a small planner (3
steps, 4 candidates).  Every draw of the port is the JAX package's own,
taken from the JAX run as it happens: the reset state of each episode,
the policy's normal draws (from its action, mean and log_std), each
planner call's candidate draws (``eps=``) and each fit's minibatch
indices (``idxs=``).  The JAX modules run at float64 under ``jax_f64``.

Compared: each step's stochastic score, every buffered path's
observations, policy actions, MPC labels and rewards, the buffer's log,
the BC losses before and after each fit and the policy after the last.
Tolerance 1e-9: the labels come from 3 RK4 control steps of the general
engine (``test_torch_mpc.py`` holds the actor to 1e-9), and each fit is a
few Adam steps (``test_torch_bc.py`` holds BC fits to 1e-9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.algos import behavior_cloning as jbc
from mjrl_tpu.algos import mbac as jmbac
from mjrl_tpu.algos.model_accel import sampling as jsampling
from mjrl_tpu.envs.gym_env import GymEnv as JaxGymEnv
from mjrl_tpu.models import mpc_actor as jactor
from mjrl_tpu.models import policies as jpol
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos import mbac as tmbac
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.envs.point_mass import PointMassEnv
from mjrl_tpu_torch.models import policies as tpol

from test_torch_mpc import next_eps
from test_torch_nn_dynamics import Float64Numpy, close
from test_torch_npg import close_tree
from test_torch_policy import numpy_params, to_jax

OBS, ACT, HID = 6, 2, (8,)
T, STEPS, BUFFER = 4, 3, 2
TOL = 1e-9
BC_KW = dict(epochs=2, batch_size=3, lr=1e-3, buffer_size=BUFFER, seed=7)


def mpc_params():
    return dict(H=3, paths_per_cpu=4, num_cpu=1, kappa=5.0, gamma=0.95,
                filter_coefs=[np.array([0.8, 1.2]), 0.6, 0.3, 0.1])


@pytest.fixture
def jax_f64(monkeypatch):
    for mod in (jactor, jsampling, jpol, jbc):
        monkeypatch.setattr(mod, "jnp", Float64Numpy())
    monkeypatch.setattr(jmbac, "GymEnv", lambda name: JaxGymEnv(
        name, env_kwargs={"dtype": jnp.float64}))
    monkeypatch.setattr(tmbac, "GymEnv", lambda name, device=None: GymEnv(
        name, device=device, env_kwargs={"dtype": torch.float64}))


def policies():
    spec = PointMassEnv(device="cpu").spec
    p_np = numpy_params(4, HID, OBS, ACT)
    p_np["log_std"] = np.array([-0.7, -0.3])
    jp = jpol.MLP(spec, hidden_sizes=HID)
    jp.params = jp.old_params = to_jax(p_np)
    jp.transforms = type(jp.transforms)(*to_jax(list(jp.transforms)))
    tp = tpol.MLP(spec, hidden_sizes=HID, dtype=torch.float64, device="cpu")
    convert.policy_params_from_numpy(tp, p_np)
    return jp, tp


def record_jax_draws(agent):
    """Wrap the JAX agent's draws so that each is kept as it is made."""
    draws = {"reset": [], "noise": [], "eps": [], "idxs": []}
    env, pol, mpc, fit = (agent.env.reset, agent.policy.get_action,
                          agent.mpc_policy.get_action, agent.fit)

    def reset(*args, **kwargs):
        out = env(*args, **kwargs)
        draws["reset"].append(agent.env.get_env_state())
        return out

    def get_action(o):
        a, info = pol(o)
        draws["noise"].append((a - info["mean"]) / np.exp(info["log_std"]))
        return [a, info]

    def plan(s):
        draws["eps"].append(next_eps(
            agent.mpc_policy, (agent.mpc_policy.num_candidates,
                               agent.mpc_policy.H, ACT)))
        return mpc(s)

    def fitted(data, **kwargs):
        n = len(data["observations"])
        total = agent.epochs * max(n // agent.mb_size, 1)
        _, sub = jax.random.split(agent._key)
        draws["idxs"].append(np.array(jax.random.randint(
            sub, (total, agent.mb_size), 0, n)))
        return fit(data, **kwargs)

    agent.env.reset, agent.policy.get_action = reset, get_action
    agent.mpc_policy.get_action, agent.fit = plan, fitted
    return draws


def replay_jax_draws(agent, draws):
    """Hand the port's agent the JAX run's draws, in the order made."""
    env, pol, mpc, fit = (agent.env.reset, agent.policy.get_action,
                          agent.mpc_policy.get_action, agent.fit)
    draws = {k: list(v) for k, v in draws.items()}

    def reset(*args, **kwargs):
        env(*args, **kwargs)
        agent.env.set_env_state(draws["reset"].pop(0))
        return agent.env.get_obs()

    def get_action(o):
        _, info = pol(o)
        a = info["mean"] + np.exp(info["log_std"]) * draws["noise"].pop(0)
        return [a, info]

    agent.env.reset, agent.policy.get_action = reset, get_action
    agent.mpc_policy.get_action = lambda s: mpc(s, eps=draws["eps"].pop(0))
    agent.fit = lambda data, **kw: fit(data, idxs=draws["idxs"].pop(0),
                                       **kw)
    return draws


def test_mbac_train_steps_match_jax(jax_f64):
    jp, tp = policies()
    ja = jmbac.MBAC("mjrl_point_mass-v0", jp, mpc_params=mpc_params(),
                    **BC_KW)
    ta = tmbac.MBAC("mjrl_point_mass-v0", tp, mpc_params=mpc_params(),
                    device="cpu", **BC_KW)
    ja.env._horizon = ta.env._horizon = T
    draws = record_jax_draws(ja)
    want = [ja.train_step(num_traj=1) for _ in range(STEPS)]
    left = replay_jax_draws(ta, draws)
    got = [ta.train_step(num_traj=1) for _ in range(STEPS)]
    assert not any(left.values())
    assert len(draws["eps"]) == STEPS * T and len(draws["idxs"]) == STEPS
    close(got, want, TOL)

    assert len(ta.expert_paths) == len(ja.expert_paths) == BUFFER
    for tpath, jpath in zip(ta.expert_paths, ja.expert_paths):
        for k in ("observations", "actions", "expert_actions", "rewards"):
            assert tpath[k].shape == jpath[k].shape, k
            close(tpath[k], jpath[k], TOL)
        for ts, js in zip(tpath["states"], jpath["states"]):
            assert sorted(ts) == sorted(js)
            for k in js:
                close(ts[k], js[k], TOL)
    # the buffered paths are the last two episodes: the first was dropped
    for tpath, start in zip(ta.expert_paths, draws["reset"][1:]):
        for k in start:
            close(tpath["states"][0][k], start[k], 0.0)
    assert ta.logger.log["buffer_size"] == ja.logger.log["buffer_size"] \
        == [1, 2, 2]
    for k in ("loss_before", "loss_after"):
        close(ta.logger.log[k], ja.logger.log[k], TOL)
    close_tree(tp.params,
               jax.tree_util.tree_map(np.asarray, jp.params), TOL)
    assert int(ta.opt_state["count"]) == 2 * (1 + 2 + 2)
