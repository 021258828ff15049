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
- ``autoreset``: an environment whose episode ends is reset in the same
  control step (a fresh ``env.reset`` of the whole batch, taken row by row
  where ``done``), so every grid cell is a valid sample; episode ends are
  recorded in ``dones`` for the done-aware return / GAE scans.

An external host env behind a ``GymEnv`` (gymnasium style, no functional
API) is sampled on the host one episode at a time by ``sample_paths`` and
``sample_data_batch``, the policy forward on the policy's device.

Under a ``mesh`` (``parallel/mesh.py``) each rank steps its B / R rows,
so the planar kernel launches once per control step on this rank's rows.
Every draw (resets, action noise) is made for the whole batch and sliced,
so R ranks reproduce the one-rank rollout row for row; the returned batch
holds this rank's rows.
"""

import math
from dataclasses import fields, is_dataclass

import numpy as np
import torch

from mjrl_tpu_torch.device import make_generator
from mjrl_tpu_torch.parallel.mesh import shard_rollout_keys
from mjrl_tpu_torch.utils.profiling import span, spanned


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


@spanned("rollout")
@torch.no_grad()
def rollout_batch(env, policy, params, transforms, generator, num_traj,
                  horizon=None, eval_mode=False, mesh=None,
                  autoreset=False, state0=None, noise=None, resets=None):
    """Collect ``num_traj`` fixed-length paths fully on the env's device.

    env: functional env; policy: GaussianMLP; params/transforms: policy
    parameter dict and Transforms; generator: torch.Generator on the env's
    device (resets and action noise).

    Without ``autoreset`` each row is one episode, frozen after it ends and
    padded behind a validity ``mask``.  With it, rows run on through resets:
    ``rewards`` are unmasked, ``mask`` is all ones, ``dones`` (num_traj, T)
    marks each episode's last step, ``terminated`` is ``dones[:, -1] > 0``
    and ``last_obs`` is the obs of the state the rows carry on from: after
    the last step, and after the reset in rows whose episode ended there.

    For tests only: ``state0`` starts from a given EnvState instead of
    ``env.reset``; ``noise`` (T, num_traj, act_dim) is used instead of
    drawn noise; ``resets`` gives the fresh states of autoreset instead of
    ``env.reset``: a callable ``t -> EnvState`` of num_traj rows, or a pair
    (qpos (T, num_traj, nq), qvel (T, num_traj, nv)).

    ``mesh``: this rank steps its rows of the ``num_traj`` (which must
    divide by the mesh's ranks); ``state0``, ``noise`` and ``resets`` are
    whole-batch and sliced the same way.

    Returns a dict with leaves of shape (num_traj, T, ...), or (num_traj /
    R, T, ...) under a mesh of R ranks.
    """
    T = env.horizon if horizon is None else min(int(horizon), env.horizon)
    n_all = int(num_traj)             # draws are made for all the rows
    if mesh is not None:
        mesh.rows(n_all)              # raises unless they split evenly
    shard = lambda x: shard_rollout_keys(x, mesh)
    terminating = not _never_terminates(env)

    s = env.reset(n_all, generator, mesh=mesh) if state0 is None \
        else shard(state0)
    dt, dev = s.obs.dtype, s.obs.device
    A = env.action_dim
    B = s.obs.shape[0]                # this rank's rows
    observations = torch.empty((B, T, s.obs.shape[-1]), dtype=dt, device=dev)
    actions = torch.empty((B, T, A), dtype=dt, device=dev)
    means = torch.empty((B, T, A), dtype=dt, device=dev)
    rewards = torch.empty((B, T), dtype=dt, device=dev)
    mask = torch.ones((B, T), dtype=dt, device=dev)
    dones = torch.zeros((B, T), dtype=dt, device=dev) if autoreset else None
    infos = []
    alive = torch.ones((B,), dtype=dt, device=dev)
    if resets is None:
        fresh_state = lambda t: env.reset(n_all, generator, mesh=mesh)
    elif callable(resets):
        fresh_state = lambda t: shard(resets(t))
    else:
        fresh_state = lambda t: env.state_from_qpos_qvel(
            shard(resets[0][t]), shard(resets[1][t]))

    for t in range(T):
        with span("control_step", timed=False):
            with span("policy", timed=False):
                mean, log_std = policy.dist_info(params, transforms, s.obs)
                if eval_mode:
                    action = mean
                else:
                    # the whole batch's draw on every rank, then this
                    # rank's rows
                    eps = noise[t] if noise is not None else torch.randn(
                        (n_all, A), generator=generator, dtype=dt,
                        device=dev)
                    eps = shard(eps).to(dt)
                    action = mean + torch.exp(log_std) * eps
            with span("env_step", timed=False):
                ns = env.step(s, action)
            observations[:, t] = s.obs
            actions[:, t] = action
            means[:, t] = mean
            info = ns.info
            if autoreset:
                rewards[:, t] = ns.reward
                if terminating:
                    # rows whose episode ended start afresh in the next step
                    dones[:, t] = ns.done.to(dt)
                    with span("reset"):
                        ns = _select(dones[:, t], fresh_state(t), ns)
            elif terminating:
                # freeze the env after termination: padded tail steps stay
                # at the terminal state
                ns = _select(alive, ns, s)
                info = ns.info
                rewards[:, t] = ns.reward * alive
                mask[:, t] = alive
                alive = alive * (1.0 - ns.done.to(dt))
            else:
                rewards[:, t] = ns.reward
            infos.append(info)
            s = ns

    env_infos = {k: torch.stack([i[k] for i in infos], dim=1)
                 for k in (infos[0] if infos else {})}
    if autoreset:
        return dict(
            observations=observations, actions=actions, rewards=rewards,
            agent_mean=means,
            agent_log_std=params["log_std"].to(dt).expand(B, T, A),
            mask=mask, dones=dones, env_infos=env_infos,
            terminated=dones[:, -1] > 0, last_obs=s.obs)
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
    """Accept either a functional env or a GymEnv wrapper (a GymEnv around
    an external host env is kept: it has no functional env)."""
    if getattr(env, "_external", False):
        return env
    if hasattr(env, "env") and hasattr(env.env, "reset"):
        return env.env
    return env


def _host_paths(num_traj, env, policy, eval_mode, horizon, base_seed,
                generator):
    """``num_traj`` episodes of a GymEnv around an external host env, one
    at a time: the env steps on the host, the policy's forward runs on its
    device (noise from ``generator``, on that device).  A path ends at the
    horizon or where the env reports done; ``terminated`` is set only by
    the env's own termination, never by its time limit (a truncated path
    is bootstrapped from its last value like one cut at the horizon)."""
    params, transforms, cfg = _policy_parts(policy)
    dev = params["log_std"].device
    dtype = params["log_std"].dtype
    if generator is None:
        generator = make_generator(0 if base_seed is None else base_seed,
                                   dev)
    T = env.horizon if horizon is None or horizon >= 1e6 else int(horizon)
    paths = []
    for k in range(num_traj):
        o = env.reset(seed=None if base_seed is None else base_seed + k)
        obs, acts, rews, means = [], [], [], []
        done = False
        while len(rews) < T and not done:
            with torch.no_grad():
                a, info = cfg.act(params, transforms,
                                  torch.as_tensor(o, dtype=dtype,
                                                  device=dev)[None],
                                  generator)
            a = (info["mean"] if eval_mode else a)[0].cpu().numpy()
            obs.append(o)
            acts.append(a)
            means.append(info["mean"][0].cpu().numpy())
            o, r, done, _ = env.step(a)
            rews.append(r)
        log_std = _to_numpy(params["log_std"]).reshape(-1)
        paths.append(dict(
            observations=np.array(obs), actions=np.array(acts),
            rewards=np.array(rews),
            agent_infos={"mean": np.array(means), "log_std": log_std,
                         "evaluation": np.array(means)},
            env_infos={}, terminated=bool(done) and env.terminated))
    return paths


def sample_paths(num_traj, env, policy, eval_mode=False, horizon=1e6,
                 base_seed=None, num_cpu=1, generator=None, **kwargs):
    """Host-facing parity API -> list of path dicts.  ``num_cpu`` is
    accepted and ignored — batching replaces process parallelism."""
    env = _functional_env(env)
    if getattr(env, "_external", False):
        return _host_paths(num_traj, env, policy, eval_mode, horizon,
                           base_seed, generator)
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
    external = getattr(fenv, "_external", False)
    if generator is None:
        generator = make_generator(
            0 if base_seed is None else base_seed,
            _policy_parts(policy)[0]["log_std"].device if external
            else fenv.device)
    T = fenv.horizon if horizon is None or horizon >= 1e6 else int(horizon)
    n = num_traj_for_samples(int(num_samples), T)
    paths, total = [], 0
    for call in range(100):  # safety bound
        batch = sample_paths(
            n, fenv, policy, eval_mode, T, generator=generator,
            base_seed=None if base_seed is None or not external
            else base_seed + call * n)
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
    truncated to each path's valid length.  Autoreset batches (with a
    ``dones`` grid) are split on episode boundaries, so every dict is ONE
    episode with its ``terminated`` flag: a row may hold several episodes
    and a truncated tail."""
    batch = _to_numpy(batch)

    def slice_path(i, lo, hi, terminated):
        return dict(
            observations=batch["observations"][i][lo:hi],
            actions=batch["actions"][i][lo:hi],
            rewards=batch["rewards"][i][lo:hi],
            agent_infos={
                "mean": batch["agent_mean"][i][lo:hi],
                "log_std": batch["agent_log_std"][i][0],
                "evaluation": batch["agent_mean"][i][lo:hi],
            },
            env_infos={k: v[i][lo:hi] for k, v in batch["env_infos"].items()},
            terminated=bool(terminated),
        )

    out = []
    for i in range(batch["rewards"].shape[0]):
        if "dones" in batch:
            dones = batch["dones"][i]
            lo = 0
            for e in np.flatnonzero(dones > 0):
                out.append(slice_path(i, lo, int(e) + 1, True))
                lo = int(e) + 1
            if lo < dones.shape[0]:        # truncated trailing episode
                out.append(slice_path(i, lo, dones.shape[0], False))
        else:
            T = int(batch["mask"][i].sum())
            out.append(slice_path(i, 0, T, batch["terminated"][i]))
    return out
