"""BatchREINFORCE agent — base class for the on-policy family
(counterpart of ``mjrl_tpu/algos/batch_reinforce.py``).

``train_step`` runs three phases on the agent's device —
(1) batched rollout (one kernel launch per control step),
(2) returns/GAE/whitening + the policy update,
(3) baseline fit —
each timed host-side (after a device synchronize) under the mjrl
phase-timer log keys (time_sampling / time_vpg / time_VF).  Under a
profiler the iteration and its phases are also spans (``train_step`` >
``rollout``, ``gae``, ``update``, ``fit``; ``utils/profiling.py``).

API parity: ``train_step(N, env, sample_mode, horizon, gamma, gae_lambda,
num_cpu, env_kwargs) -> [mean, std, min, max, N]``;
``train_from_paths(paths)`` for externally collected paths; running-score
EMA 0.9/0.1; advantage whitening with 1e-6; optional KL-targeted
step-halving line search.

``autoreset=True`` rolls out with episodes reset inside the rollout, so
every grid cell is a sample; processing then takes the done-aware return /
GAE scans.  Subclasses with a persistent optimizer (PPO) set
``_has_opt_state`` and keep ``self.opt_state``; their ``_update_core``
takes and returns it.

``mesh=`` (``parallel/mesh.py``) splits ``train_step``'s batch over the
ranks of a process group: each rank rolls out its rows, and the whitening,
the update, the baseline fit and the logged statistics reduce over all
ranks, so every rank takes the one-rank step.  Data that every rank holds
alike (``train_from_paths``, a model's imagined batch) takes the
unreduced path.
"""

import functools
import time as timer

import numpy as np
import torch

from mjrl_tpu_torch.algos import functional as F
from mjrl_tpu_torch.device import (make_generator, resolve_device,
                                   restore_generator, unpickled_device)
from mjrl_tpu_torch.ops.flat import tree_to
from mjrl_tpu_torch.ops.gae import (discounted_returns, gae_advantages,
                                    gae_with_dones, returns_with_dones,
                                    whiten)
from mjrl_tpu_torch.parallel.mesh import all_reduce_sum, gather_rows
from mjrl_tpu_torch.samplers.rollout import (num_traj_for_samples,
                                             rollout_batch)
from mjrl_tpu_torch.utils.logger import DataLog
from mjrl_tpu_torch.utils.profiling import span, spanned


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BatchREINFORCE:
    def __init__(self, env, policy, baseline,
                 learn_rate=0.01,
                 seed=123,
                 desired_kl=None,
                 save_logs=False,
                 device=None,
                 **kwargs):
        self.env = env
        self.policy = policy
        self.baseline = baseline
        self.alpha = learn_rate
        self.seed = seed if seed is not None else 123
        self.save_logs = save_logs
        self.running_score = None
        self.desired_kl = desired_kl
        self.device = resolve_device(device)
        devices = [("policy", policy.device), ("baseline", baseline.device)]
        if not getattr(self.fenv, "_external", False):   # a host env
            devices.append(("env", self.fenv.device))
        for name, dev in devices:
            if dev.type != self.device.type:
                raise ValueError(
                    f"{name} lives on {dev}, the agent on {self.device}")
        self.generator = make_generator(self.seed, self.device)
        if save_logs:
            self.logger = DataLog()
        # optional Mesh: train_step's batch split over its ranks
        self.mesh = kwargs.get("mesh", None)
        self.autoreset = bool(kwargs.get("autoreset", False))
        self._has_opt_state = False

    # -- pickling: the generator travels as its state, tensors on the CPU; --
    # -- the mesh stays behind (a process group does not pickle) ------------
    def __getstate__(self):
        state = self.__dict__.copy()
        state["generator"] = self.generator.get_state()
        state["device"] = str(self.device)
        state["mesh"] = None
        if "opt_state" in state:
            state["opt_state"] = tree_to(self.opt_state, "cpu")
        return state

    def __setstate__(self, state):
        gen_state = state.pop("generator")
        self.__dict__.update(state)
        saved = self.device
        self.device = dev = unpickled_device(saved)
        if "opt_state" in state:
            self.opt_state = tree_to(self.opt_state, dev)
        self.generator = restore_generator(gen_state, dev, self.seed, saved)

    # -- plumbing --------------------------------------------------------
    @property
    def fenv(self):
        """The functional env behind either a GymEnv wrapper or a raw
        functional env (a GymEnv around an external host env: the GymEnv,
        which has no functional env)."""
        if getattr(self.env, "_external", False):
            return self.env
        return self.env.env if hasattr(self.env, "env") and \
            hasattr(self.env.env, "reset") else self.env

    # -- phases ------------------------------------------------------------
    def _get_phases(self, num_traj, T, gamma, gae_lambda, mesh=None):
        """The four phases of an iteration; under ``mesh`` the rollout
        holds this rank's rows and the rest reduces over the ranks."""
        fenv = self.fenv
        pol = self.policy.config
        bl = self.baseline.cfg

        autoreset = self.autoreset

        def rollout_fn(params, transforms, generator):
            return rollout_batch(fenv, pol, params, transforms, generator,
                                 num_traj=num_traj, horizon=T,
                                 autoreset=autoreset, mesh=mesh)

        @spanned("gae")
        @torch.no_grad()
        def process(bl_state, batch):
            rewards = batch["rewards"]
            mask = batch["mask"]
            if "dones" in batch:         # an autoreset grid: all valid
                dones = batch["dones"]
                returns = returns_with_dones(rewards, dones, gamma)
                obs_ext = torch.cat([batch["observations"],
                                     batch["last_obs"][:, None]], dim=1)
                values_ext = bl.predict(bl_state, obs_ext)
                values, v_last = values_ext[:, :-1], values_ext[:, -1]
                if gae_lambda is None or gae_lambda < 0 or gae_lambda > 1:
                    adv = returns - values
                else:
                    adv = gae_with_dones(rewards, values, dones, v_last,
                                         gamma, gae_lambda)
                adv_flat = whiten(adv.reshape(-1), mesh=mesh)
                # per-episode mean return: total reward / episode count
                n_eps = torch.clamp(torch.sum(dones, dim=1), min=1.0)
                path_returns = torch.sum(rewards, dim=1) / n_eps
                return returns, adv_flat, path_returns
            returns = discounted_returns(rewards, gamma, mask)
            values = bl.predict(bl_state, batch["observations"])
            if gae_lambda is None or gae_lambda < 0 or gae_lambda > 1:
                adv = (returns - values) * mask
            else:
                adv = gae_advantages(rewards, values, gamma, gae_lambda,
                                     batch["terminated"], mask)
            adv_flat = whiten(adv.reshape(-1), mask.reshape(-1), mesh=mesh)
            path_returns = torch.sum(rewards * mask, dim=1)
            return returns, adv_flat, path_returns

        fit_fn = spanned("fit")(torch.no_grad()(functools.partial(
            self.baseline.fit_state, mesh=mesh)))

        return rollout_fn, process, self._update_core, fit_fn

    # -- algorithm core (overridden by subclasses) -----------------------
    def _update_core(self, params, transforms, obs, act, adv, mask,
                     generator, mesh=None):
        """REINFORCE ascent step, optional KL-targeted halving line search.
        Returns (new_params, stats dict).  ``mesh``: the rows are this
        rank's, and every mean reduces over the ranks."""
        pol = self.policy.config
        with torch.no_grad():
            surr_before = F.cpi_surrogate(pol, params, params, transforms,
                                          obs, act, adv, mask, mesh)
        g = F.vpg_grad(pol, params, params, transforms, obs, act, adv, mask,
                       mesh)

        with torch.no_grad():
            alpha = torch.as_tensor(self.alpha, dtype=obs.dtype,
                                    device=obs.device)
            if self.desired_kl is not None:
                kl = F.mean_kl(pol, F.apply_step(pol, params, g, alpha),
                               params, transforms, obs, mask, mesh)
                it = 0
                while bool(kl > self.desired_kl) and it < 100:
                    alpha = alpha / 2.0
                    kl = F.mean_kl(pol, F.apply_step(pol, params, g, alpha),
                                   params, transforms, obs, mask, mesh)
                    it += 1
            new_params = F.apply_step(pol, params, g, alpha)
            surr_after = F.cpi_surrogate(pol, new_params, params, transforms,
                                         obs, act, adv, mask, mesh)
            kl = F.mean_kl(pol, new_params, params, transforms, obs, mask,
                           mesh)
        stats = dict(alpha=alpha, surr_before=surr_before,
                     surr_after=surr_after, kl_dist=kl)
        return new_params, stats

    # -- main entry ------------------------------------------------------
    def train_step(self, N,
                   env=None,
                   sample_mode="trajectories",
                   horizon=1e6,
                   gamma=0.995,
                   gae_lambda=0.97,
                   num_cpu="max",
                   env_kwargs=None,
                   ):
        with span("train_step", device=self.device):
            assert sample_mode in ("trajectories", "samples"), \
                "sample_mode must be 'trajectories' or 'samples'"
            fenv = self.fenv
            T = fenv.horizon if horizon is None or horizon >= 1e6 \
                else min(int(horizon), fenv.horizon)
            num_traj = N if sample_mode == "trajectories" \
                else num_traj_for_samples(N, T)
            self._last_gamma_lambda = (gamma, gae_lambda)

            mesh = self.mesh
            rollout_fn, process_fn, update_fn, fit_fn = self._get_phases(
                num_traj, T, gamma, gae_lambda, mesh)

            # phase 1: sampling
            ts = timer.time()
            batch = rollout_fn(self.policy.params, self.policy.transforms,
                               self.generator)
            _sync(self.device)
            if self.save_logs:
                self.logger.log_kv("time_sampling", timer.time() - ts)

            # phase 2: process + update
            eval_statistics = self._train_from_batch(
                batch, process_fn, update_fn, mesh)
            eval_statistics.append(N)
            if self.save_logs:
                self.logger.log_kv("num_samples", int(all_reduce_sum(
                    batch["mask"].sum(), mesh)))
                if "dones" in batch:     # episodes ended + truncated row tails
                    d = batch["dones"]
                    self.logger.log_kv("num_episodes", int(all_reduce_sum(
                        d.sum() + (d[:, -1] == 0).sum(), mesh)))

            # phase 3: baseline fit on fresh returns
            ts = timer.time()
            new_state, e0, e1 = fit_fn(self.baseline.state,
                                       batch["observations"],
                                       self._last_returns, batch["mask"])
            self.baseline.state = new_state
            _sync(self.device)
            if self.save_logs:
                self.logger.log_kv("time_VF", timer.time() - ts)
                self.logger.log_kv("VF_error_before", float(e0))
                self.logger.log_kv("VF_error_after", float(e1))

            return eval_statistics

    def _train_from_batch(self, batch, process_fn, update_fn, mesh=None):
        """Process and update on ``batch`` (under ``mesh``: this rank's
        rows of a batch split over the ranks) -> score statistics."""
        ts = timer.time()
        returns, adv_flat, path_returns = process_fn(self.baseline.state,
                                                     batch)
        self._last_returns = returns

        obs = batch["observations"].reshape(-1,
                                            batch["observations"].shape[-1])
        act = batch["actions"].reshape(-1, batch["actions"].shape[-1])
        mask = batch["mask"].reshape(-1)

        with span("update"):
            if self._has_opt_state:
                new_params, stats, self.opt_state = update_fn(
                    self.policy.params, self.policy.transforms, obs, act,
                    adv_flat, mask, self.generator, self.opt_state,
                    mesh=mesh)
            else:
                new_params, stats = update_fn(
                    self.policy.params, self.policy.transforms, obs, act,
                    adv_flat, mask, self.generator, mesh=mesh)
            # install new params (new and old copies, clamped)
            self.policy.old_params = {k: v.detach().clone()
                                      for k, v in new_params.items()}
            self.policy.params = new_params
        _sync(self.device)
        t_update = timer.time() - ts

        # score statistics, over every rank's paths
        pr = gather_rows(path_returns.detach(), mesh).cpu().numpy()
        base_stats = [float(pr.mean()), float(pr.std()), float(pr.min()),
                      float(pr.max())]
        self.running_score = base_stats[0] if self.running_score is None \
            else 0.9 * self.running_score + 0.1 * base_stats[0]

        if self.save_logs:
            self._log_update_stats(stats, t_update)
            self.logger.log_kv("stoc_pol_mean", base_stats[0])
            self.logger.log_kv("stoc_pol_std", base_stats[1])
            self.logger.log_kv("stoc_pol_min", base_stats[2])
            self.logger.log_kv("stoc_pol_max", base_stats[3])
            self.logger.log_kv("running_score", self.running_score)
            self._log_success(batch, mesh)
        return base_stats

    def _log_update_stats(self, stats, t_update):
        self.logger.log_kv("alpha", float(stats["alpha"]))
        self.logger.log_kv("time_vpg", t_update)
        self.logger.log_kv("kl_dist", float(stats["kl_dist"]))
        self.logger.log_kv("surr_improvement",
                           float(stats["surr_after"])
                           - float(stats["surr_before"]))

    def _log_success(self, batch, mesh=None):
        fenv = self.fenv
        infos = batch.get("env_infos", {})
        flag = next((k for k in ("solved", "goal_achieved")
                     if k in infos), None)
        if hasattr(fenv, "evaluate_success") and flag is not None:
            rate = fenv.evaluate_success(
                gather_rows(infos[flag], mesh).cpu().numpy())
            self.logger.log_kv("success_rate", rate)

    # -- list-of-paths entry (for demo flows and parity) ------------------
    def train_from_paths(self, paths):
        batch = _list_to_batch(paths, self.policy.dtype, self.device)
        num_traj, T = batch["rewards"].shape
        gamma, lam = self._last_gamma_lambda \
            if hasattr(self, "_last_gamma_lambda") else (0.995, 0.97)
        _, process_fn, update_fn, _ = self._get_phases(num_traj, T, gamma,
                                                       lam)
        return self._train_from_batch(batch, process_fn, update_fn)

    def log_rollout_statistics(self, paths):
        path_returns = [float(np.sum(p["rewards"])) for p in paths]
        self.logger.log_kv("stoc_pol_mean", np.mean(path_returns))
        self.logger.log_kv("stoc_pol_std", np.std(path_returns))
        self.logger.log_kv("stoc_pol_max", np.max(path_returns))
        self.logger.log_kv("stoc_pol_min", np.min(path_returns))


def _list_to_batch(paths, dtype=torch.float32, device=None):
    """mjrl-format list of path dicts -> padded batch dict of tensors."""
    T = max(len(p["rewards"]) for p in paths)
    n_obs = paths[0]["observations"].shape[-1]
    n_act = paths[0]["actions"].shape[-1]
    N = len(paths)
    obs = np.zeros((N, T, n_obs), np.float64)
    act = np.zeros((N, T, n_act), np.float64)
    rew = np.zeros((N, T), np.float64)
    mask = np.zeros((N, T), np.float64)
    term = np.zeros((N,), bool)
    for i, p in enumerate(paths):
        t = len(p["rewards"])
        obs[i, :t] = p["observations"]
        act[i, :t] = p["actions"]
        rew[i, :t] = p["rewards"]
        mask[i, :t] = 1.0
        term[i] = bool(p.get("terminated", False))
    t_ = lambda x: torch.as_tensor(x, dtype=dtype, device=device)
    return dict(observations=t_(obs), actions=t_(act), rewards=t_(rew),
                mask=t_(mask),
                terminated=torch.as_tensor(term, device=device),
                env_infos={})
