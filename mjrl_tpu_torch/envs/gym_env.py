"""Host-side stateful wrapper with the mjrl GymEnv API (counterpart of
``mjrl_tpu/envs/gym_env.py``).

Scripts / evaluation / pickling use this; training code uses the
functional env directly.  Supports act_repeat (horizon divided by
act_repeat, rewards summed over repeats) and obs_mask.  The wrapper holds
a batch of ONE environment on the env's device.

Not ported yet (ROADMAP.md M12): external host-API envs (gymnasium /
dmc2gym style), ``render`` and ``visualize_policy``.
"""

import numpy as np
import torch

from mjrl_tpu_torch.device import make_generator


class GymEnv:
    def __init__(self, env, env_kwargs=None, obs_mask=None, act_repeat=1,
                 horizon=None, device=None, *args, **kwargs):
        from mjrl_tpu_torch import envs as registry
        env_kwargs = dict(env_kwargs or {})
        if device is not None:
            env_kwargs.setdefault("device", device)
        if isinstance(env, str):
            self.env = registry.make(env, **env_kwargs)
            self.env_id = env
        elif callable(env) and not hasattr(env, "step"):
            self.env = env(**env_kwargs)
            self.env_id = type(self.env).__name__
        else:
            self.env = env
            self.env_id = type(env).__name__
        if hasattr(self.env, "observation_space") \
                and not hasattr(self.env, "model"):
            raise NotImplementedError(
                "external host-API envs are not ported (ROADMAP.md M12)")

        self.act_repeat = act_repeat
        env_horizon = self.env.horizon if horizon is None else horizon
        assert env_horizon % act_repeat == 0
        self._horizon = env_horizon // act_repeat
        self.obs_mask = np.ones(self.observation_dim) if obs_mask is None \
            else np.asarray(obs_mask)
        self.seeding = False
        self._seed = 123
        self._gen = None
        self._state = None

    # -- pickling: generators are rebuilt on load -----------------------
    def __getstate__(self):
        state = self.__dict__.copy()
        state["_gen"] = None
        state["_state"] = None
        return state

    # -- spec ------------------------------------------------------------
    @property
    def spec(self):
        from mjrl_tpu_torch.envs.base import EnvSpec
        return EnvSpec(self.env.observation_dim, self.env.action_dim,
                       self._horizon)

    @property
    def observation_dim(self):
        return self.env.observation_dim

    @property
    def action_dim(self):
        return self.env.action_dim

    @property
    def horizon(self):
        return self._horizon

    @property
    def action_space(self):
        low = np.asarray(self.env.act_low)
        high = np.asarray(self.env.act_high)
        return type("Box", (), {"low": low, "high": high})()

    # -- gym-like API ----------------------------------------------------
    def set_seed(self, seed=123):
        self._seed = int(seed)
        self._gen = make_generator(self._seed, self.env.device)

    def seed(self, seed=None):
        if seed is not None:
            self.set_seed(seed)

    def reset(self, seed=None):
        if seed is not None:
            self.set_seed(seed)
        if self._gen is None:
            self.set_seed(self._seed)
        self._state = self.env.reset(1, self._gen)
        return self.get_obs()

    reset_model = reset

    def step(self, a):
        a = np.clip(np.asarray(a, np.float64).reshape(1, -1),
                    np.asarray(self.env.act_low),
                    np.asarray(self.env.act_high))
        a = torch.as_tensor(a, dtype=self._state.obs.dtype,
                            device=self.env.device)
        total_r = 0.0
        for _ in range(self.act_repeat):
            self._state = self.env.step(self._state, a)
            total_r += float(self._state.reward[0])
        done = bool(self._state.done[0])
        return self.get_obs(), total_r, done, self.get_env_infos()

    def get_obs(self):
        return self._state.obs[0].detach().cpu().numpy() * self.obs_mask

    def get_env_infos(self):
        info = {k: v[0].detach().cpu().numpy()
                for k, v in self._state.info.items()}
        info["state"] = self.get_env_state()
        return info

    # -- state parity ------------------------------------------------------
    def get_env_state(self):
        return {k: v[0].detach().cpu().numpy()
                for k, v in self.env.get_env_state(self._state).items()}

    def set_env_state(self, state_dict):
        if self._state is None:
            self.reset()
        batched = {k: np.asarray(v)[None] for k, v in state_dict.items()}
        self._state = self.env.set_env_state(self._state, batched)

    def real_env_step(self, bool_val):
        pass  # no sim/real distinction: the engine is the env

    def render(self, mode="rgb_array"):
        raise NotImplementedError("render is not ported (ROADMAP.md M12)")

    def visualize_policy(self, *args, **kwargs):
        raise NotImplementedError(
            "visualize_policy is not ported (ROADMAP.md M12)")

    # -- evaluation --------------------------------------------------------
    def evaluate_policy(self, policy, num_episodes=5, horizon=None, gamma=1,
                        visual=False, percentile=[], get_full_dist=False,
                        mean_action=False, init_env_state=None,
                        terminate_at_done=True, seed=123):
        self.set_seed(seed)
        horizon = self._horizon if horizon is None else horizon
        ep_returns = np.zeros(num_episodes)

        for ep in range(num_episodes):
            self.reset()
            if init_env_state is not None:
                self.set_env_state(init_env_state)
            t, done = 0, False
            while t < horizon and (done is False or not terminate_at_done):
                o = self.get_obs()
                a = policy.get_action(o)[1]["evaluation"] if mean_action \
                    else policy.get_action(o)[0]
                _, r, done, _ = self.step(a)
                ep_returns[ep] += (gamma ** t) * r
                t += 1

        mean_eval, std = np.mean(ep_returns), np.std(ep_returns)
        min_score, max_score = np.amin(ep_returns), np.amax(ep_returns)
        base_stats = [mean_eval, std, min_score, max_score]
        percentile_stats = [np.percentile(ep_returns, p) for p in percentile]
        full_dist = ep_returns if get_full_dist else None
        return [base_stats, percentile_stats, full_dist]

    def evaluate_success(self, paths, logger=None):
        if hasattr(self.env, "evaluate_success"):
            return self.env.evaluate_success(paths, logger)
        raise AttributeError(f"{self.env_id} has no evaluate_success")
