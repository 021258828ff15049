"""Model-accelerated NPG (counterpart of
``mjrl_tpu/algos/model_accel/model_accel_npg.py``).

``train_step`` rolls imagined trajectories through the learned model
ensemble from given init states (env resets by default), every member from
the same states in one stacked rollout, the members' paths concatenated in
member order (N * M paths); applies the learned reward head or the supplied
reward function, an optional termination function, and the
ensemble-disagreement truncation (max over members of the per-step MSE
above ``truncate_lim`` cuts the path, at no fewer than 4 steps, adding
``truncate_reward`` at the cut); then the standard returns / GAE / NPG
update and the baseline fit.  Truncation is expressed through the validity
mask (fixed shapes).
"""

import time as timer

import torch

from mjrl_tpu_torch.algos.batch_reinforce import _sync
from mjrl_tpu_torch.algos.model_accel.nn_dynamics import stacked_dynamics
from mjrl_tpu_torch.algos.model_accel.sampling import models_rollout
from mjrl_tpu_torch.algos.npg_cg import NPG


class ModelAccelNPG(NPG):
    def __init__(self, learned_model=None,
                 refine=False,
                 kappa=5.0,
                 plan_horizon=10,
                 plan_paths=100,
                 reward_function=None,
                 termination_function=None,
                 **kwargs):
        super().__init__(**kwargs)
        if learned_model is None:
            raise ValueError(
                "Algorithm requires a (list of) learned dynamics model")
        if hasattr(learned_model, "members"):
            self.learned_model = list(learned_model.members)
        elif isinstance(learned_model, (list, tuple)):
            self.learned_model = list(learned_model)
        else:
            self.learned_model = [learned_model]
        self.refine = refine
        self.kappa, self.plan_horizon, self.plan_paths = (kappa,
                                                          plan_horizon,
                                                          plan_paths)
        self.reward_function = reward_function
        self.termination_function = termination_function

    def train_step(self, N,
                   env=None,
                   sample_mode="trajectories",
                   horizon=1e6,
                   gamma=0.995,
                   gae_lambda=0.97,
                   num_cpu="max",
                   env_kwargs=None,
                   init_states=None,
                   reward_function=None,
                   termination_function=None,
                   truncate_lim=None,
                   truncate_reward=0.0,
                   noise=None,
                   **kwargs):
        """``noise`` (M, N, H, m), for tests, replaces the rollouts' action
        noise (member m's draws in ``noise[m]``)."""
        ts = timer.time()
        fenv = self.fenv
        models = self.learned_model
        reward_function = self.reward_function if reward_function is None \
            else reward_function
        termination_function = self.termination_function \
            if termination_function is None else termination_function
        T = int(min(horizon, fenv.horizon))
        t = models[0]._t

        if init_states is None:
            init_states = fenv.reset(N, self.generator).obs
        init_states = t(init_states)
        assert init_states.shape[0] == N

        # imagined rollouts through every member from the same init states
        obs, act = models_rollout(models, self.policy, init_states, T,
                                  generator=self.generator,
                                  noise=None if noise is None else t(noise))
        obs = obs.reshape((-1,) + obs.shape[2:])     # (M * N, T, d)
        act = act.reshape((-1,) + act.shape[2:])

        # rewards: the learned reward head or the supplied reward function
        paths = {"observations": obs, "actions": act}
        if models[0].learn_reward:
            rewards = models[0].compute_path_rewards(paths)["rewards"]
        else:
            assert callable(reward_function), \
                "need a reward function when the model has no reward head"
            rewards = reward_function(paths)["rewards"]
        rewards = t(rewards)

        mask = torch.ones_like(rewards)
        terminated = torch.zeros(rewards.shape[:1], dtype=torch.bool,
                                 device=rewards.device)
        if callable(termination_function):
            out = termination_function(
                dict(observations=obs, actions=act, rewards=rewards,
                     mask=mask, terminated=terminated))
            rewards = t(out.get("rewards", rewards))
            mask = t(out.get("mask", mask))
            terminated = torch.as_tensor(out.get("terminated", terminated),
                                         device=rewards.device)

        if truncate_lim is not None and len(models) > 1:
            rewards, mask, terminated = self._disagreement_truncation(
                obs, act, rewards, mask, terminated, float(truncate_lim),
                float(truncate_reward))

        _sync(self.device)
        if self.save_logs:
            self.logger.log_kv("time_sampling", timer.time() - ts)
        self.seed = self.seed + N if self.seed is not None else self.seed

        batch = dict(observations=obs, actions=act, rewards=rewards,
                     mask=mask, terminated=terminated, env_infos={})
        _, process_fn, update_fn, fit_fn = self._get_phases(
            int(obs.shape[0]), T, gamma, gae_lambda)
        eval_statistics = self._train_from_batch(batch, process_fn,
                                                 update_fn)
        eval_statistics.append(N)
        if self.save_logs:
            self.logger.log_kv("num_samples", int(mask.sum()))

        ts = timer.time()
        new_state, e0, e1 = fit_fn(self.baseline.state, obs,
                                   self._last_returns, mask)
        self.baseline.state = new_state
        _sync(self.device)
        if self.save_logs:
            self.logger.log_kv("time_VF", timer.time() - ts)
            self.logger.log_kv("VF_error_before", float(e0))
            self.logger.log_kv("VF_error_after", float(e1))
        return eval_statistics

    @torch.no_grad()
    def _disagreement_truncation(self, obs, act, rewards, mask, terminated,
                                 truncate_lim, truncate_reward):
        """Max over members of the per-step MSE between each member's
        prediction and the path's next state; the first step above the
        limit cuts the path there (at no fewer than 4 steps), with the bonus
        reward on the last kept step."""
        NT, T, d = obs.shape
        s = obs[:, :-1].reshape(-1, d)
        a = act[:, :-1].reshape(-1, act.shape[-1])
        s_next = obs[:, 1:].reshape(-1, d)
        cfg, layers, tr = stacked_dynamics(self.learned_model)
        M = len(self.learned_model)
        pred = cfg.forward(layers, tr, s.expand(M, *s.shape),
                           a.expand(M, *a.shape))
        pred_err = torch.mean((s_next - pred) ** 2, dim=-1).amax(dim=0)
        violated = pred_err.reshape(NT, T - 1) > truncate_lim
        any_violation = violated.any(dim=1)
        first = torch.argmax(violated.to(torch.uint8), dim=1)
        T_cut = torch.where(any_violation, first + 1,
                            torch.full_like(first, T))
        T_cut = torch.clamp(T_cut, min=4)
        t_idx = torch.arange(T, device=obs.device)[None, :]
        new_mask = mask * (t_idx < T_cut[:, None])
        truncated_here = any_violation & (T_cut < T)
        bonus = ((t_idx == (T_cut - 1)[:, None])
                 & truncated_here[:, None]).to(rewards.dtype) \
            * truncate_reward
        return rewards + bonus, new_mask, terminated | truncated_here

    def get_action(self, observation):
        if self.refine is False:
            return self.policy.get_action(observation)
        return self.get_refined_action(observation)

    def get_refined_action(self, observation):
        # the reference's placeholder
        raise NotImplementedError
