"""MPPI-style MPC over learned models (counterpart of
``mjrl_tpu/algos/model_accel/model_learning_mpc.py``).

Per ``get_action``:
- perturb the warm-started action sequence with filtered gaussian noise;
- roll every candidate through every learned model in one batched rollout
  (the same action set through each member);
- score with the discounted return of the env's batched reward, plus
  omega x the ensemble disagreement: the std over members (ddof 0) of the
  predicted states, summed over time and state dims, one value per
  candidate;
- MPPI weights softmax(kappa * (R - max R)) over all member x candidate
  scores; execute the first action of the weighted-average sequence;
  warm-start by shifting it, the mean appended.
"""

import numpy as np
import torch

from mjrl_tpu_torch.algos.model_accel.nn_dynamics import stacked_dynamics
from mjrl_tpu_torch.algos.model_accel.sampling import (
    generate_perturbed_actions_batch)
from mjrl_tpu_torch.device import make_generator
from mjrl_tpu_torch.samplers.rollout import _functional_env


class MPCPolicy:
    def __init__(self, env,
                 plan_horizon,
                 plan_paths=10,
                 kappa=1.0,
                 gamma=1.0,
                 mean=None,
                 filter_coefs=None,
                 seed=123,
                 warmstart=True,
                 fitted_model=None,
                 omega=5.0,
                 **kwargs):
        self.env, self.seed = env, seed
        fenv = _functional_env(env)
        self.fenv = fenv
        self.n, self.m = fenv.observation_dim, int(fenv.action_dim)
        self.plan_horizon, self.num_traj = plan_horizon, plan_paths

        if fitted_model is None:
            raise ValueError("Policy requires a fitted dynamics model")
        if hasattr(fitted_model, "members"):
            self.fitted_model = list(fitted_model.members)
        elif isinstance(fitted_model, (list, tuple)):
            self.fitted_model = list(fitted_model)
        else:
            self.fitted_model = [fitted_model]
        if not hasattr(fenv, "compute_path_rewards"):
            raise ValueError(
                "MPC requires env.compute_path_rewards or a learned reward")

        self.mean = np.zeros(self.m) if mean is None else np.asarray(mean)
        self.filter_coefs = [np.ones(self.m), 1.0, 0.0, 0.0] \
            if filter_coefs is None else filter_coefs
        self.kappa, self.gamma, self.omega = kappa, gamma, omega
        self.act_sequence = np.ones((self.plan_horizon, self.m)) * self.mean
        self.init_act_sequence = self.act_sequence.copy()
        self.warmstart = warmstart
        self.generator = make_generator(seed, self.fitted_model[0].device)

    @torch.no_grad()
    def plan(self, obs, base_act, eps=None):
        """-> the (H, m) MPPI-weighted action sequence from state ``obs``
        (d,) around ``base_act`` (H, m), both tensors.  ``eps`` (P, H, m),
        for tests, replaces the normal draws."""
        cfg, layers, tr = stacked_dynamics(self.fitted_model)
        M, P, H = len(self.fitted_model), self.num_traj, self.plan_horizon
        acts = generate_perturbed_actions_batch(
            self.generator, base_act, self.filter_coefs, P, eps)
        s = obs.expand(M, P, obs.shape[-1])
        obs_seq = []
        for h in range(H):
            obs_seq.append(s)
            s = cfg.forward(layers, tr, s, acts[:, h].expand(M, P, self.m))
        all_obs = torch.stack(obs_seq, dim=2)            # (M, P, H, d)
        all_acts = acts.expand(M, P, H, self.m).reshape(M * P, H, self.m)
        paths = self.fenv.compute_path_rewards(
            {"observations": all_obs.reshape(M * P, H, -1),
             "actions": all_acts})
        rewards = paths["rewards"].reshape(M, P, H)
        disc = self.gamma ** torch.arange(H, dtype=rewards.dtype,
                                          device=rewards.device)
        scores = torch.sum(rewards * disc, dim=-1)     # (M, P)
        if M > 1:
            disagreement = torch.std(all_obs, dim=0, correction=0).sum(
                dim=(1, 2))                             # (P,)
            scores = scores + self.omega * disagreement
        scores = scores.reshape(-1)
        w = torch.exp(self.kappa * (scores - scores.max()))
        return torch.sum(all_acts * w[:, None, None], dim=0) \
            / (w.sum() + 1e-6)

    def get_action(self, obs, eps=None):
        t = self.fitted_model[0]._t
        act_sequence = self.plan(t(obs), t(self.act_sequence),
                                 eps).cpu().numpy()
        action = act_sequence[0].copy()
        if self.warmstart:
            self.act_sequence[:-1] = act_sequence[1:]
            self.act_sequence[-1] = self.mean.copy()
        else:
            self.act_sequence = self.init_act_sequence.copy()
        return action

    def score_trajectory(self, paths):
        rewards = np.asarray(paths["rewards"])
        disc = self.gamma ** np.arange(rewards.shape[1])
        return np.sum(rewards * disc, axis=1)
