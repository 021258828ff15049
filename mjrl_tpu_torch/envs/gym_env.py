"""Host-side stateful wrapper with the mjrl GymEnv API (counterpart of
``mjrl_tpu/envs/gym_env.py``).

Scripts / evaluation / pickling use this; training code uses the
functional env directly.  Supports act_repeat (horizon divided by
act_repeat, rewards summed over repeats) and obs_mask.  The wrapper holds
a batch of ONE environment on the env's device.

External host-API envs (gymnasium / dmc2gym style: stateful ``reset()`` /
``step(a)`` with ``observation_space`` / ``action_space``, the gymnasium
5-tuple or the gym 4-tuple) sit behind the same surface: the env runs on
the host, the policy wherever it lives.  ``render`` and
``visualize_policy`` draw offscreen through ``utils/render.py``.
"""

import inspect

import numpy as np
import torch

from mjrl_tpu_torch.device import make_generator


def _takes_device(factory):
    """True when ``factory`` (an env class or function) takes ``device``:
    the port's envs do, an external env's factory need not."""
    try:
        params = inspect.signature(factory).parameters.values()
    except (TypeError, ValueError):
        return False
    return any(p.name == "device" or p.kind == p.VAR_KEYWORD
               for p in params)


class GymEnv:
    def __init__(self, env, env_kwargs=None, obs_mask=None, act_repeat=1,
                 horizon=None, device=None, *args, **kwargs):
        from mjrl_tpu_torch import envs as registry
        env_kwargs = dict(env_kwargs or {})
        if device is not None and (isinstance(env, str)
                                   or _takes_device(env)):
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
        # external host-API envs (gymnasium / dmc2gym style) behind the
        # same surface
        self._external = (hasattr(self.env, "observation_space")
                          and not hasattr(self.env, "model"))

        self.act_repeat = act_repeat
        env_horizon = self._resolve_horizon(horizon)
        assert env_horizon % act_repeat == 0
        self._horizon = env_horizon // act_repeat
        self.obs_mask = np.ones(self.observation_dim) if obs_mask is None \
            else np.asarray(obs_mask)
        self.seeding = False
        self._seed = 123
        self._gen = None
        self._state = None
        self._last_obs = None
        self._seed_int = None
        self.terminated = False   # the host env's last end was not a cut

    def _resolve_horizon(self, horizon):
        if horizon is not None:
            return horizon
        if not self._external:
            return self.env.horizon
        spec = getattr(self.env, "spec", None)
        for attr in ("max_episode_steps", "_horizon"):
            v = getattr(spec, attr, None)
            if v:
                return v
        v = getattr(self.env, "horizon", None) or \
            getattr(self.env, "_max_episode_steps", None)
        if v:
            return v
        raise ValueError("external env: pass horizon= explicitly")

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
        return EnvSpec(self.observation_dim, self.action_dim, self._horizon)

    @property
    def observation_dim(self):
        if self._external:
            return int(np.prod(self.env.observation_space.shape))
        return self.env.observation_dim

    @property
    def action_dim(self):
        if self._external:
            return int(np.prod(self.env.action_space.shape))
        return self.env.action_dim

    @property
    def horizon(self):
        return self._horizon

    @property
    def action_space(self):
        if self._external:
            return self.env.action_space
        low = np.asarray(self.env.act_low)
        high = np.asarray(self.env.act_high)
        return type("Box", (), {"low": low, "high": high})()

    # -- gym-like API ----------------------------------------------------
    def set_seed(self, seed=123):
        self._seed = int(seed)
        if not self._external:
            self._gen = make_generator(self._seed, self.env.device)

    def seed(self, seed=None):
        if seed is not None:
            self.set_seed(seed)

    def reset(self, seed=None):
        if seed is not None:
            self.set_seed(seed)
            self._seed_int = int(seed)
        if self._external:
            out = self.env.reset(seed=self._seed_int) \
                if self._seed_int is not None else self.env.reset()
            self._seed_int = None
            self.terminated = False
            obs = out[0] if isinstance(out, tuple) else out
            self._last_obs = np.asarray(obs).ravel()
            return self.get_obs()
        if self._gen is None:
            self.set_seed(self._seed)
        self._state = self.env.reset(1, self._gen)
        return self.get_obs()

    reset_model = reset

    def step(self, a):
        if self._external:
            return self._step_external(a)
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

    def _step_external(self, a):
        """One wrapped step of the host env -> (obs, reward, done, info),
        ``done`` an end by termination or by truncation, as the JAX wrapper
        returns it; ``self.terminated`` keeps whether it was a termination
        (gym's 4-tuple marks a truncation with ``TimeLimit.truncated``)."""
        total_r, done, term, ifo = 0.0, False, False, {}
        a = np.clip(np.asarray(a), self.env.action_space.low,
                    self.env.action_space.high)
        for _ in range(self.act_repeat):
            out = self.env.step(a)
            if len(out) == 5:       # gymnasium: terminated / truncated
                obs, r, term, trunc, ifo = out
                term = bool(term)
                done = term or bool(trunc)
            else:
                obs, r, done, ifo = out
                term = bool(done) and not (ifo or {}).get(
                    "TimeLimit.truncated", False)
            self.terminated = term
            self._last_obs = np.asarray(obs).ravel()
            total_r += float(r)
            if done:
                break
        return self.get_obs(), total_r, done, ifo

    def get_obs(self):
        if self._external:
            return self._last_obs * self.obs_mask
        return self._state.obs[0].detach().cpu().numpy() * self.obs_mask

    def get_env_infos(self):
        if self._external:
            return {}
        info = {k: v[0].detach().cpu().numpy()
                for k, v in self._state.info.items()}
        info["state"] = self.get_env_state()
        return info

    # -- state parity ------------------------------------------------------
    def get_env_state(self):
        if self._external:
            if hasattr(self.env, "get_env_state"):
                return self.env.get_env_state()
            raise NotImplementedError(
                f"{self.env_id} has no get_env_state")
        return {k: v[0].detach().cpu().numpy()
                for k, v in self.env.get_env_state(self._state).items()}

    def set_env_state(self, state_dict):
        if self._external:
            if hasattr(self.env, "set_env_state"):
                return self.env.set_env_state(state_dict)
            raise NotImplementedError(
                f"{self.env_id} has no set_env_state")
        if self._state is None:
            self.reset()
        batched = {k: np.asarray(v)[None] for k, v in state_dict.items()}
        self._state = self.env.set_env_state(self._state, batched)

    def real_env_step(self, bool_val):
        pass  # no sim/real distinction: the engine is the env

    # -- rendering (offscreen, utils/render.py) ---------------------------
    def render(self, mode="rgb_array"):
        """The current state drawn offscreen -> an RGB array (H, W, 3)
        uint8 (needs matplotlib); an external env renders itself."""
        if self._external:
            return self.env.render()
        from mjrl_tpu_torch.utils.render import render_state
        if self._state is None:
            self.reset()
        return render_state(self.env.model, self._state.physics.qpos[0],
                            device=self.env.device,
                            body_pos=self.env._body_pos(self._state.scenery))

    def visualize_policy(self, policy, num_episodes=1, horizon=None,
                         mode="exploration", save_dir="policy_vis"):
        """Offscreen episode videos (``utils/render.py::visualize_policy``):
        the mean action unless ``mode`` is 'exploration'."""
        from mjrl_tpu_torch.utils.render import visualize_policy as _vis
        return _vis(self, policy, num_episodes=num_episodes,
                    horizon=horizon, mean_action=(mode != "exploration"),
                    save_dir=save_dir)

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
