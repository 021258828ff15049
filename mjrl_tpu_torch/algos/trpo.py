"""TRPO: NPG + backtracking line search (counterpart of
``mjrl_tpu/algos/trpo.py``).

Start from the NPG step size for delta = 2 * kl_dist; while the measured
KL(old, new) >= kl_dist, shrink alpha by 0.9, up to 100 attempts; when the
count reaches 100, alpha = 0.  The search is a host loop: each attempt
reads one KL back from the device.
"""

import torch

from mjrl_tpu_torch.algos import functional as F
from mjrl_tpu_torch.algos.npg_cg import NPG


class TRPO(NPG):
    def __init__(self, env, policy, baseline,
                 kl_dist=0.01,
                 FIM_invert_args={"iters": 10, "damping": 1e-4},
                 hvp_sample_frac=1.0,
                 seed=123,
                 save_logs=False,
                 normalized_step_size=0.01,
                 device=None,
                 **kwargs):
        super().__init__(env, policy, baseline,
                         normalized_step_size=normalized_step_size,
                         FIM_invert_args=FIM_invert_args,
                         hvp_sample_frac=hvp_sample_frac, seed=seed,
                         save_logs=save_logs, device=device, **kwargs)
        self.kl_dist = kl_dist if kl_dist is not None \
            else 0.5 * normalized_step_size
        self.n_step_size = 2.0 * self.kl_dist

    def _update_core(self, params, transforms, obs, act, adv, mask,
                     generator, mesh=None):
        """-> (new params, stats); ``mesh`` as NPG's: each line-search KL
        is reduced, so every rank stops at the same attempt."""
        pol = self.policy.config
        damping = self.FIM_invert_args.get("damping", 1e-4)
        iters = self.FIM_invert_args.get("iters", 10)

        with torch.no_grad():
            surr_before = F.cpi_surrogate(pol, params, params, transforms,
                                          obs, act, adv, mask, mesh)
        g, npg = F.npg_direction(
            pol, params, transforms, obs, act, adv, mask,
            damping=damping, cg_iters=iters, generator=generator,
            hvp_sample_frac=self.hvp_subsample, mesh=mesh)
        with torch.no_grad():
            alpha, delta = F.npg_step_size(g, npg, self.n_step_size)

            def kl_at(a):
                new = F.apply_step(pol, params, npg, a)
                return F.mean_kl(pol, new, params, transforms, obs, mask,
                                 mesh)

            kl, k = kl_at(alpha), 0
            while bool(kl >= self.kl_dist) and k < 100:
                alpha = 0.9 * alpha
                kl, k = kl_at(alpha), k + 1
            if k >= 100:
                alpha = torch.zeros_like(alpha)
            new_params = F.apply_step(pol, params, npg, alpha)
            surr_after = F.cpi_surrogate(pol, new_params, params, transforms,
                                         obs, act, adv, mask, mesh)
            kl = F.mean_kl(pol, new_params, params, transforms, obs, mask,
                           mesh)
        return new_params, dict(alpha=alpha, delta=delta,
                                surr_before=surr_before,
                                surr_after=surr_after, kl_dist=kl,
                                line_search_steps=k, vpg_grad=g,
                                npg_grad=npg)

    def _log_update_stats(self, stats, t_update):
        super()._log_update_stats(stats, t_update)
        self.logger.log_kv("line_search_steps", stats["line_search_steps"])
