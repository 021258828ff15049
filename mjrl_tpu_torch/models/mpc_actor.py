"""MPPI actor shooting in the *real* physics engine (counterpart of
``mjrl_tpu/models/mpc_actor.py``).

The candidate action sequences roll through the batched functional env:
one ``env.step`` of all P candidates per horizon step.  On a planar env
that step is one launch of the planar kernel (K1 smooth, K2 contact); on
the general engine's envs it is the engine's eager step.

Semantics: perturb the (non-warm-started) base sequence with filtered
noise, score with the discounted return, return the softmax(kappa)-weighted
first action.
"""

import numpy as np
import torch

from mjrl_tpu_torch.algos.model_accel.sampling import (
    generate_perturbed_actions_batch)
from mjrl_tpu_torch.device import make_generator
from mjrl_tpu_torch.samplers.rollout import _functional_env


class MPCActor:
    def __init__(self, env, H, paths_per_cpu,
                 num_cpu=1,
                 kappa=1.0,
                 gamma=1.0,
                 mean=None,
                 filter_coefs=None,
                 seed=123):
        fenv = _functional_env(env)
        self.env = env
        self.fenv = fenv
        self.n, self.m = fenv.observation_dim, int(fenv.action_dim)
        # paths_per_cpu * num_cpu candidates, one batch axis
        self.H, self.num_candidates = H, paths_per_cpu * max(num_cpu, 1)
        self.kappa, self.gamma = kappa, gamma
        self.mean = np.zeros(self.m) if mean is None else np.asarray(mean)
        self.filter_coefs = [np.ones(self.m), 1.0, 0.0, 0.0] \
            if filter_coefs is None else filter_coefs
        self.act_sequence = np.ones((self.H, self.m)) * self.mean
        self.seed = seed
        self.generator = make_generator(seed, fenv.device)
        self._template_state = None
        self.ctr = 1

    def score_trajectory(self, paths):
        scores = np.zeros(len(paths))
        for i, p in enumerate(paths):
            disc = self.gamma ** np.arange(len(p["rewards"]))
            scores[i] = float(np.sum(p["rewards"] * disc))
        return scores

    @torch.no_grad()
    def get_action(self, env_state, eps=None):
        """env_state: the env-state dict ({qp, qv, ...}) of the current
        real-env state, as ``GymEnv.get_env_state`` gives it.  ``eps``
        (P, H, m), for tests, replaces the normal draws."""
        fenv, P = self.fenv, self.num_candidates
        if self._template_state is None:
            self._template_state = fenv.reset(
                P, make_generator(0, fenv.device))
        state = fenv.set_env_state(self._template_state, {
            k: np.broadcast_to(np.asarray(v), (P,) + np.shape(v))
            for k, v in env_state.items()})
        self.ctr += 1
        base = torch.as_tensor(self.act_sequence, dtype=fenv.dtype,
                               device=fenv.device)
        acts = generate_perturbed_actions_batch(
            self.generator, base, self.filter_coefs, P, eps)
        returns = torch.zeros(P, dtype=fenv.dtype, device=fenv.device)
        for h in range(self.H):
            state = fenv.step(state, acts[:, h])
            returns = returns + self.gamma ** h * state.reward
        w = torch.exp(self.kappa * (returns - returns.max()))
        act = torch.sum(acts[:, 0] * w[:, None], dim=0) / (w.sum() + 1e-6)
        return act.cpu().numpy()
