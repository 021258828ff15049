"""Model-space rollouts and MPC helpers (counterpart of
``mjrl_tpu/algos/model_accel/sampling.py``).

- ``policy_rollout``: batched H-step rollout of a gaussian policy through
  a learned model, noise = randn * exp(log_std), states / actions clamped
  to bounds; ``models_rollout`` does every member of an ensemble at once
  (states (M, N, d), one batched forward per step).
- ``trajectory_rollout``: fixed action sequences through the model.
- ``generate_perturbed_actions``: MPPI noise with the 3-tap smoothing
  filter beta_0, beta_1, beta_2 (numpy, the reference's stream);
  ``generate_perturbed_actions_batch`` draws (num_traj, H, m) at once on
  the device and applies the filter as one (H, H) matrix.
- ``sample_paths``: real-env rollouts for MPC policies with uniform action
  noise; ``evaluate_policy`` with a real_step toggle.
- ``enforce_bounds``.

Random draws come from explicit ``torch.Generator``s; tests pass the
draws instead (``noise=``, ``eps=``).
"""

import numpy as np
import torch

from mjrl_tpu_torch.algos.model_accel.nn_dynamics import (as_tensor,
                                                          stacked_dynamics)
from mjrl_tpu_torch.device import make_generator
from mjrl_tpu_torch.samplers.rollout import _functional_env, _policy_parts


def enforce_bounds(x, min_val=None, max_val=None, large_value=1e4):
    """Clamp to Box[min_val, max_val], defaulting to +-large_value."""
    lo = -large_value if min_val is None else min_val
    hi = large_value if max_val is None else max_val
    return torch.clamp(x, lo, hi)


def _bound(b, like):
    return None if b is None else as_tensor(b, like.dtype, like.device)


@torch.no_grad()
def models_rollout(models, policy, init_states, horizon, eval_mode=False,
                   generator=None, noise=None, s_min=None, s_max=None,
                   a_min=None, a_max=None, large_value=1e2):
    """Roll the policy through every model of ``models`` (a list of world
    models: one stacked forward per step) from the same ``init_states``
    (N, d) -> observations (M, N, H, d), actions (M, N, H, m): each step's
    state before it is taken, and its action.  ``noise`` (M, N, H, m), for
    tests, replaces the draws from ``generator``."""
    cfg, layers, tr = stacked_dynamics(models)
    pol_params, pol_tr, pol_cfg = _policy_parts(policy)
    M, (N, d) = len(models), init_states.shape
    s = init_states.expand(M, N, d)
    bounds = [_bound(b, s) for b in (s_min, s_max, a_min, a_max)]
    std = torch.exp(pol_params["log_std"])
    obs, act = [], []
    for t in range(int(horizon)):
        a = pol_cfg.mean(pol_params, pol_tr, s)
        if not eval_mode:
            eps = noise[:, :, t] if noise is not None else torch.randn(
                a.shape, generator=generator, dtype=a.dtype, device=a.device)
            a = a + eps.to(a) * std
        a = enforce_bounds(a, bounds[2], bounds[3], large_value)
        obs.append(s)
        act.append(a)
        s = enforce_bounds(cfg.forward(layers, tr, s, a), bounds[0],
                           bounds[1], large_value)
    return torch.stack(obs, dim=2), torch.stack(act, dim=2)


def policy_rollout(num_traj, env, policy, learned_model, init_state=None,
                   eval_mode=False, horizon=1e6, env_kwargs=None, seed=None,
                   s_min=None, s_max=None, a_min=None, a_max=None,
                   large_value=1e2, generator=None, noise=None):
    """-> {'observations': (num_traj, H, d), 'actions': (num_traj, H, m)}
    through one learned model.  Start states: ``init_state`` ((d,) or
    (num_traj, d)), else ``env.reset``.  ``noise`` (num_traj, H, m), for
    tests, replaces the draws."""
    fenv = _functional_env(env)
    if generator is None:
        generator = make_generator(0 if seed is None else int(seed),
                                   learned_model.device)
    if init_state is None:
        init_states = fenv.reset(num_traj, generator).obs
    else:
        init_states = learned_model._t(init_state)
        if init_states.dim() == 1:
            init_states = init_states.expand(num_traj, -1)
    horizon = int(min(horizon, fenv.horizon))
    obs, act = models_rollout(
        [learned_model], policy, init_states.to(learned_model.dtype),
        horizon, eval_mode, generator,
        None if noise is None else learned_model._t(noise)[None],
        s_min, s_max, a_min, a_max, large_value)
    return dict(observations=obs[0], actions=act[0])


@torch.no_grad()
def trajectory_rollout(actions, learned_model, init_states):
    """actions (num_traj, H, m); init_states (num_traj, d) or (d,) ->
    {'observations', 'actions'}."""
    t = learned_model._t
    actions, s = t(actions), t(init_states)
    if s.dim() == 1:
        s = s.expand(actions.shape[0], -1)
    obs = []
    for h in range(actions.shape[1]):
        obs.append(s)
        s = learned_model.dyn_cfg.forward(learned_model.dyn_params,
                                          learned_model.dyn_tr, s,
                                          actions[:, h])
    return dict(observations=torch.stack(obs, dim=1), actions=actions)


def discount_sum(x, gamma, discounted_terminal=0.0):
    y = np.zeros(len(x))
    run = discounted_terminal
    for t in range(len(x) - 1, -1, -1):
        run = x[t] + gamma * run
        y[t] = run
    return y


def generate_perturbed_actions(base_act, filter_coefs, rng=None):
    """Filtered gaussian perturbations around a base action sequence
    (numpy; the same stream as the JAX package's under one RandomState)."""
    rng = np.random if rng is None else rng
    sigma, beta_0, beta_1, beta_2 = filter_coefs
    eps = rng.normal(loc=0, scale=1.0, size=base_act.shape) * sigma
    eps = base_act + eps
    eps[0] = eps[0] * (beta_0 + beta_1 + beta_2)
    eps[1] = beta_0 * eps[1] + (beta_1 + beta_2) * eps[0]
    for i in range(2, eps.shape[0]):
        eps[i] = beta_0 * eps[i] + beta_1 * eps[i - 1] + beta_2 * eps[i - 2]
    return eps


def smoothing_matrix(h, beta_0, beta_1, beta_2):
    """The 3-tap filter of ``generate_perturbed_actions_batch`` as an
    (h, h) matrix K: filtered = K @ raw along the time axis."""
    k = np.zeros((h, h))
    k[0, 0] = beta_0 + beta_1 + beta_2
    if h > 1:
        k[1] = (beta_1 + beta_2) * k[0]
        k[1, 1] += beta_0
    for i in range(2, h):
        k[i] = beta_1 * k[i - 1] + beta_2 * k[i - 2]
        k[i, i] += beta_0
    return k


def generate_perturbed_actions_batch(generator, base_act, filter_coefs,
                                     num_traj, eps=None):
    """(num_traj, H, m) filtered perturbations of ``base_act`` (H, m), a
    tensor: raw = base + N(0, 1) * sigma, then the 3-tap filter (first row
    scaled by beta_0 + beta_1 + beta_2, the second beta_0 a[1] + (beta_1 +
    beta_2) first, then beta_0 a[i] + beta_1 out[i-1] + beta_2 out[i-2]).
    ``eps`` (num_traj, H, m), for tests, replaces the normal draws."""
    sigma, beta_0, beta_1, beta_2 = filter_coefs
    h, m = base_act.shape
    like = dict(dtype=base_act.dtype, device=base_act.device)
    if eps is None:
        eps = torch.randn((num_traj, h, m), generator=generator, **like)
    raw = base_act + as_tensor(eps, **like) * as_tensor(sigma, **like)
    k = torch.as_tensor(smoothing_matrix(h, float(beta_0), float(beta_1),
                                         float(beta_2)), **like)
    return torch.matmul(k, raw)


def generate_paths(num_traj, learned_model, start_state, base_act,
                   filter_coefs, base_seed=None, **kwargs):
    """Perturb (numpy) + roll out through the model."""
    rng = np.random.RandomState(base_seed) if base_seed is not None \
        else np.random
    act = np.array([generate_perturbed_actions(base_act, filter_coefs, rng)
                    for _ in range(num_traj)])
    return trajectory_rollout(act, learned_model, start_state)


def _stack_infos(infos):
    """list of (nested) info dicts -> dict of stacked arrays."""
    if not infos:
        return {}
    if isinstance(infos[0], dict):
        return {k: _stack_infos([i[k] for i in infos]) for k in infos[0]}
    return np.array(infos)


def sample_paths(num_traj, env, policy, horizon=1e6, eval_mode=True,
                 base_seed=None, noise_level=0.1, device=None):
    """Real-env rollouts, one environment at a time, for MPC-style
    policies, with uniform action noise (numpy, from ``base_seed``) when
    not in eval mode."""
    from mjrl_tpu_torch.envs.gym_env import GymEnv
    if isinstance(env, str):
        env = GymEnv(env, device=device)
    elif callable(env) and not hasattr(env, "step"):
        env = env()
    if base_seed is not None:
        env.set_seed(base_seed)
    rng = np.random.RandomState(base_seed)
    horizon = int(min(horizon, env.horizon))
    paths = []
    for ep in range(num_traj):
        env.reset()
        observations, actions, rewards, env_infos = [], [], [], []
        t, done = 0, False
        while t < horizon and done is False:
            obs = env.get_obs()
            ifo = env.get_env_infos()
            act = policy.get_action(obs)
            if eval_mode is False and not isinstance(act, list):
                act = act + rng.uniform(-noise_level, noise_level,
                                        size=act.shape[0])
            if isinstance(act, list):
                act = act[0] if eval_mode is False else act[1]["evaluation"]
            next_obs, reward, done, _ = env.step(act)
            t += 1
            observations.append(obs)
            actions.append(act)
            rewards.append(reward)
            env_infos.append(ifo)
        paths.append(dict(
            observations=np.array(observations),
            actions=np.array(actions),
            rewards=np.array(rewards),
            terminated=done,
            env_infos=_stack_infos(env_infos)))
    return paths


def evaluate_policy(e, policy, learned_model, noise_level=0.0,
                    real_step=True, num_episodes=10, visualize=False,
                    seed=None):
    """Evaluate a policy's mean action on the real env (real_step=True),
    one environment at a time, or by stepping the learned model and
    re-scoring with the env's batched reward (real_step=False)."""
    rng = np.random.RandomState(seed)
    paths = []
    for ep in range(num_episodes):
        e.reset()
        observations, actions, rewards, env_infos = [], [], [], []
        o = e.get_obs()
        for t in range(e.horizon):
            a = policy.get_action(o)
            if isinstance(a, list):
                a = a[1]["evaluation"]
            if noise_level > 0.0:
                a = a + rng.uniform(-noise_level, noise_level,
                                    size=a.shape[0])
            if real_step:
                next_o, r, done, ifo = e.step(a)
            else:
                next_o = learned_model.predict(o.reshape(1, -1),
                                               np.asarray(a).reshape(1, -1)
                                               )[0]
                r, done, ifo = 0.0, False, {}
            observations.append(o)
            actions.append(np.asarray(a))
            rewards.append(r)
            env_infos.append(ifo)
            o = next_o
            if done:
                break
        path = dict(observations=np.array(observations),
                    actions=np.array(actions),
                    rewards=np.array(rewards))
        if real_step is False and hasattr(e.env, "compute_path_rewards"):
            like = dict(dtype=e.env.dtype, device=e.env.device)
            batched = dict(
                observations=torch.as_tensor(path["observations"][None],
                                             **like),
                actions=torch.as_tensor(path["actions"][None], **like))
            e.env.compute_path_rewards(batched)
            path["rewards"] = batched["rewards"][0].cpu().numpy()
        paths.append(path)
    return paths
