"""Batched on-device rollouts (counterpart of
``mjrl_tpu/samplers/rollout.py``).

Thousands of environment instances step in lockstep on the batch axis; the
policy forward is one batched matmul per step and the physics one kernel
launch per step (``env.step`` -> ``ops.cuda_planar.cuda_step_n_batched``).
There is ONE rollout in the port: no separate kernel-eligible path, no
batch-size rule, and the divergence rescue of ``env.step`` always applies.

Semantics:
- ``eval_mode``: actions = distribution mean.
- action noise is drawn per (step, batch) from one generator.
- path dict fields (observations, actions, rewards, agent_mean,
  agent_log_std, mask, env_infos, terminated, last_obs), batched and
  fixed-shape: (num_traj, horizon, ...) with a validity ``mask`` for
  early-terminating envs (mask stays 1 everywhere for the mjrl suite,
  whose envs never terminate early).
- ``sample_mode='samples'``: enough trajectories to reach ``num_samples``
  steps.

``autoreset`` and ``mesh`` are not ported yet (ROADMAP.md queue 1 / M11).
"""

import math
from dataclasses import fields, is_dataclass

import numpy as np
import torch

from mjrl_tpu_torch.device import make_generator


def _never_terminates(env):
    """True when the env uses the base no-termination _done."""
    from mjrl_tpu_torch.envs.base import MujocoLikeEnv
    return type(env)._done is MujocoLikeEnv._done


def _select(alive, new, old):
    """Per-row choice over a state tree: rows with alive > 0 take ``new``."""
    if torch.is_tensor(new):
        cond = alive.reshape((-1,) + (1,) * (new.dim() - 1)) > 0
        return torch.where(cond, new, old)
    if isinstance(new, dict):
        return {k: _select(alive, new[k], old[k]) for k in new}
    if is_dataclass(new):
        return type(new)(**{f.name: _select(alive, getattr(new, f.name),
                                            getattr(old, f.name))
                            for f in fields(new)})
    return new


@torch.no_grad()
def rollout_batch(env, policy, params, transforms, generator, num_traj,
                  horizon=None, eval_mode=False, mesh=None,
                  autoreset=False, state0=None, noise=None):
    """Collect ``num_traj`` fixed-length paths fully on the env's device.

    env: functional env; policy: GaussianMLP; params/transforms: policy
    parameter dict and Transforms; generator: torch.Generator on the env's
    device (resets and action noise).

    For tests only: ``state0`` starts from a given EnvState instead of
    ``env.reset``; ``noise`` (T, num_traj, act_dim) is used instead of
    drawn noise.

    Returns a dict with leaves of shape (num_traj, T, ...).
    """
    if autoreset:
        raise NotImplementedError(
            "autoreset rollouts are not ported (ROADMAP.md queue 1)")
    if mesh is not None:
        raise NotImplementedError(
            "sharded rollouts are not ported (ROADMAP.md M11)")
    T = env.horizon if horizon is None else min(int(horizon), env.horizon)
    B = int(num_traj)
    terminating = not _never_terminates(env)

    s = env.reset(B, generator) if state0 is None else state0
    dt, dev = s.obs.dtype, s.obs.device
    A = env.action_dim
    observations = torch.empty((B, T, s.obs.shape[-1]), dtype=dt, device=dev)
    actions = torch.empty((B, T, A), dtype=dt, device=dev)
    means = torch.empty((B, T, A), dtype=dt, device=dev)
    rewards = torch.empty((B, T), dtype=dt, device=dev)
    mask = torch.ones((B, T), dtype=dt, device=dev)
    infos = []
    alive = torch.ones((B,), dtype=dt, device=dev)

    for t in range(T):
        mean, log_std = policy.dist_info(params, transforms, s.obs)
        if eval_mode:
            action = mean
        else:
            eps = noise[t].to(dt) if noise is not None else torch.randn(
                mean.shape, generator=generator, dtype=dt, device=dev)
            action = mean + torch.exp(log_std) * eps
        ns = env.step(s, action)
        observations[:, t] = s.obs
        actions[:, t] = action
        means[:, t] = mean
        if terminating:
            # freeze the env after termination: padded tail steps stay at
            # the terminal state
            ns = _select(alive, ns, s)
            rewards[:, t] = ns.reward * alive
            mask[:, t] = alive
            alive = alive * (1.0 - ns.done.to(dt))
        else:
            rewards[:, t] = ns.reward
        infos.append(ns.info)
        s = ns

    env_infos = {k: torch.stack([i[k] for i in infos], dim=1)
                 for k in (infos[0] if infos else {})}
    return dict(
        observations=observations,
        actions=actions,
        rewards=rewards,
        agent_mean=means,
        agent_log_std=params["log_std"].to(dt).expand(B, T, A),
        mask=mask,
        env_infos=env_infos,
        terminated=(alive == 0.0) if terminating
        else torch.zeros((B,), dtype=torch.bool, device=dev),
        last_obs=s.obs,
    )


def num_traj_for_samples(num_samples, horizon):
    """'samples' mode accounting: enough fixed-length paths to cover
    num_samples steps."""
    return max(1, math.ceil(num_samples / horizon))


def _functional_env(env):
    """Accept either a functional env or a GymEnv wrapper."""
    if hasattr(env, "env") and hasattr(env.env, "reset"):
        return env.env
    return env


def sample_paths(num_traj, env, policy, eval_mode=False, horizon=1e6,
                 base_seed=None, num_cpu=1, generator=None, **kwargs):
    """Host-facing parity API -> list of path dicts.  ``num_cpu`` is
    accepted and ignored — batching replaces process parallelism."""
    env = _functional_env(env)
    if generator is None:
        generator = make_generator(0 if base_seed is None else base_seed,
                                   env.device)
    params, transforms, cfg = _policy_parts(policy)
    T = env.horizon if horizon is None or horizon >= 1e6 else int(horizon)
    batch = rollout_batch(env, cfg, params, transforms, generator, num_traj,
                          horizon=T, eval_mode=eval_mode)
    return paths_to_list(batch)


def sample_data_batch(num_samples, env, policy, eval_mode=False, horizon=1e6,
                      base_seed=None, num_cpu=1, generator=None,
                      paths_per_call=None, **kwargs):
    """'samples' mode parity API: keep collecting fixed-size batches until
    the total number of VALID steps reaches ``num_samples``."""
    fenv = _functional_env(env)
    if generator is None:
        generator = make_generator(0 if base_seed is None else base_seed,
                                   fenv.device)
    T = fenv.horizon if horizon is None or horizon >= 1e6 else int(horizon)
    n = num_traj_for_samples(int(num_samples), T)
    paths, total = [], 0
    for _ in range(100):  # safety bound
        batch = sample_paths(n, fenv, policy, eval_mode, T,
                             generator=generator)
        paths += batch
        total += sum(p["rewards"].shape[0] for p in batch)
        if total >= num_samples:
            break
    return paths


def _policy_parts(policy):
    """Accept either a stateful Policy wrapper or a (cfg, params,
    transforms) tuple."""
    from mjrl_tpu_torch.models.policies import Policy
    if isinstance(policy, Policy):
        return policy.params, policy.transforms, policy.config
    cfg, params, transforms = policy
    return params, transforms, cfg


def _to_numpy(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def paths_to_list(batch):
    """Batched paths dict -> mjrl-format list of per-path dicts (numpy),
    truncated to each path's valid length."""
    batch = _to_numpy(batch)
    out = []
    for i in range(batch["rewards"].shape[0]):
        T = int(batch["mask"][i].sum())
        out.append(dict(
            observations=batch["observations"][i][:T],
            actions=batch["actions"][i][:T],
            rewards=batch["rewards"][i][:T],
            agent_infos={
                "mean": batch["agent_mean"][i][:T],
                "log_std": batch["agent_log_std"][i][0],
                "evaluation": batch["agent_mean"][i][:T],
            },
            env_infos={k: v[i][:T] for k, v in batch["env_infos"].items()},
            terminated=bool(batch["terminated"][i]),
        ))
    return out
