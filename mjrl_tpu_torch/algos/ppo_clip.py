"""PPO with the clipped surrogate (counterpart of
``mjrl_tpu/algos/ppo_clip.py``).

- objective mean(min(LR * A, clip(LR, 1 +- eps) * A)) over valid steps;
- Adam over ``epochs`` x (num_samples // mb_size) minibatches, drawn with
  replacement;
- defaults clip 0.2, 10 epochs, mb 64, lr 3e-4;
- the Adam state persists across training iterations (``self.opt_state``);
- ``min_log_std`` clamp after every step.

The minibatch loop runs from the host, one Adam step per minibatch.  Under
a ``mesh`` the minibatch indices are drawn over every rank's rows, each rank
takes the rows it holds, and the gradient and the row count are all-reduced
per minibatch: every rank takes the one-rank Adam step.
"""

import torch

from mjrl_tpu_torch.algos import functional as F
from mjrl_tpu_torch.algos.batch_reinforce import BatchREINFORCE
from mjrl_tpu_torch.ops.adam import adam_copy, adam_init, adam_step_
from mjrl_tpu_torch.parallel.mesh import (local_index, masked_mean_grad,
                                          row_offset)


class PPO(BatchREINFORCE):
    def __init__(self, env, policy, baseline,
                 clip_coef=0.2,
                 epochs=10,
                 mb_size=64,
                 learn_rate=3e-4,
                 seed=123,
                 save_logs=False,
                 device=None,
                 **kwargs):
        super().__init__(env, policy, baseline, learn_rate=learn_rate,
                         seed=seed, save_logs=save_logs, device=device,
                         **kwargs)
        self.clip_coef = clip_coef
        self.epochs = epochs
        self.mb_size = mb_size
        self.learn_rate = learn_rate
        self.opt_state = adam_init(self.policy.params)
        self._has_opt_state = True

    def _objective(self, params, ll_old, transforms, obs, act, adv):
        ll_new = F.log_likelihoods(self.policy.config, params, transforms,
                                   obs, act)
        lr = torch.exp(ll_new - ll_old)
        lr_clip = torch.clamp(lr, 1.0 - self.clip_coef, 1.0 + self.clip_coef)
        return torch.minimum(lr * adv, lr_clip * adv)

    def ppo_surrogate(self, params, ll_old, transforms, obs, act, adv,
                      mask=None):
        """Clipped surrogate; ``ll_old`` = log-likelihoods of ``act`` under
        the pre-update policy.  The JAX package's public name: the update
        itself takes the gradient of ``_objective``'s rows through
        ``masked_mean_grad``, which reduces them over the ranks."""
        obj = self._objective(params, ll_old, transforms, obs, act, adv)
        if mask is None:
            return torch.mean(obj)
        return torch.sum(obj * mask) / torch.clamp(torch.sum(mask), min=1.0)

    def _update_core(self, params, transforms, obs, act, adv, mask,
                     generator, opt_state, idxs=None, mesh=None):
        """-> (new params, stats, new Adam state).  ``idxs`` (total,
        mb_size), for tests, replaces the drawn minibatch indices (global
        rows under a ``mesh``)."""
        pol = self.policy.config
        n_local = obs.shape[0]
        lo, n = row_offset(n_local, mesh)
        num_mb = max(int(n // self.mb_size), 1)
        with torch.no_grad():
            surr_before = F.cpi_surrogate(pol, params, params, transforms,
                                          obs, act, adv, mask, mesh)
            ll_old = F.log_likelihoods(pol, params, transforms, obs, act)
        if idxs is None:
            # with-replacement minibatch sampling
            idxs = torch.randint(0, n, (self.epochs * num_mb, self.mb_size),
                                 generator=generator, device=generator.device)
        idxs = torch.as_tensor(idxs, device=obs.device)
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        opt_state = adam_copy(opt_state)
        if mask is None:
            mask = torch.ones_like(adv)
        for idx in idxs:
            idx, own = local_index(idx, lo, n_local)   # the rows it holds
            w = mask[idx] * own
            with torch.enable_grad():
                obj = self._objective(p, ll_old[idx], transforms, obs[idx],
                                      act[idx], adv[idx])
                grads = masked_mean_grad(-obj, w, p, mesh)
            opt_state = adam_step_(p, grads, opt_state, self.learn_rate)
            with torch.no_grad():
                p["log_std"].clamp_(min=pol.min_log_std)
        new_params = {k: v.detach() for k, v in p.items()}
        with torch.no_grad():
            surr_after = F.cpi_surrogate(pol, new_params, params, transforms,
                                         obs, act, adv, mask, mesh)
            kl = F.mean_kl(pol, new_params, params, transforms, obs, mask,
                           mesh)
        stats = dict(alpha=self.learn_rate, surr_before=surr_before,
                     surr_after=surr_after, kl_dist=kl)
        return new_params, stats, opt_state

    def _log_update_stats(self, stats, t_update):
        self.logger.log_kv("t_opt", t_update)
        self.logger.log_kv("kl_dist", float(stats["kl_dist"]))
        self.logger.log_kv("surr_improvement",
                           float(stats["surr_after"])
                           - float(stats["surr_before"]))
