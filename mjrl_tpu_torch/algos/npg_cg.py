"""Natural Policy Gradient with CG Fisher inversion (counterpart of
``mjrl_tpu/algos/npg_cg.py``).

The entire update — VPG gradient, Fisher-vector products (Hessian-vector
products of the mean KL + damping), 10-iteration CG, step size alpha =
sqrt(|delta / g.F^-1 g|), parameter update with min_log_std clamp — runs on
the agent's device on parameter dicts; only the logged scalars (and the
backtracking test of the KL guard) reach the host.

Options parity: ``normalized_step_size`` / ``kl_dist`` (n_step = 2 kl),
``const_learn_rate``, ``FIM_invert_args {iters, damping}``,
``hvp_sample_frac``, ``input_normalization`` EMA folded into the policy's
input transforms, ``kl_guard``.
"""

import torch

from mjrl_tpu_torch.algos import functional as F
from mjrl_tpu_torch.algos.batch_reinforce import BatchREINFORCE


class NPG(BatchREINFORCE):
    def __init__(self, env, policy, baseline,
                 normalized_step_size=0.01,
                 const_learn_rate=None,
                 FIM_invert_args={"iters": 10, "damping": 1e-4},
                 hvp_sample_frac=1.0,
                 seed=123,
                 save_logs=False,
                 kl_dist=None,
                 input_normalization=None,
                 kl_guard=2.5,
                 device=None,
                 **kwargs):
        super().__init__(env, policy, baseline, learn_rate=const_learn_rate,
                         seed=seed, save_logs=save_logs, device=device,
                         **kwargs)
        self.alpha = const_learn_rate
        self.n_step_size = normalized_step_size if kl_dist is None \
            else 2.0 * kl_dist
        self.FIM_invert_args = dict(FIM_invert_args)
        self.hvp_subsample = hvp_sample_frac
        # KL guard: backtrack alpha (x0.7, <= 10 times) while the REALIZED
        # mean KL exceeds kl_guard * (n_step_size / 2).  The quadratic
        # model alpha = sqrt(delta / g F^-1 g) under-estimates curvature
        # as log_std shrinks late in training; the guard keeps the trust
        # region honest.  None/0 disables.
        self.kl_guard = kl_guard
        # input normalization EMA weight in (0, 1]; None disables
        self.input_normalization = input_normalization
        if self.input_normalization is not None:
            if self.input_normalization > 1 or self.input_normalization <= 0:
                self.input_normalization = None

    def _update_core(self, params, transforms, obs, act, adv, mask,
                     generator):
        pol = self.policy.config
        damping = self.FIM_invert_args.get("damping", 1e-4)
        iters = self.FIM_invert_args.get("iters", 10)

        with torch.no_grad():
            surr_before = F.cpi_surrogate(pol, params, params, transforms,
                                          obs, act, adv, mask)
        g, npg = F.npg_direction(
            pol, params, transforms, obs, act, adv, mask,
            damping=damping, cg_iters=iters, generator=generator,
            hvp_sample_frac=self.hvp_subsample)
        with torch.no_grad():
            alpha, delta = F.npg_step_size(g, npg, self.n_step_size,
                                           const_alpha=self.alpha)
            # const_learn_rate is a PURE fixed step — the guard's KL cap
            # would be derived from an n_step_size the user never chose, so
            # it only applies to the adaptive step.  kl_guard=0 restores
            # strict NPG.
            if self.kl_guard and self.alpha is None:
                kl_cap = self.kl_guard * 0.5 * self.n_step_size

                def kl_at(a):
                    new = F.apply_step(pol, params, npg, a)
                    return F.mean_kl(pol, new, params, transforms, obs, mask)

                kl, it = kl_at(alpha), 0
                while bool(kl > kl_cap) and it < 10:
                    alpha = 0.7 * alpha
                    kl, it = kl_at(alpha), it + 1
            new_params = F.apply_step(pol, params, npg, alpha)
            surr_after = F.cpi_surrogate(pol, new_params, params, transforms,
                                         obs, act, adv, mask)
            kl = F.mean_kl(pol, new_params, params, transforms, obs, mask)
        return new_params, dict(alpha=alpha, delta=delta,
                                surr_before=surr_before,
                                surr_after=surr_after, kl_dist=kl,
                                vpg_grad=g, npg_grad=npg)

    def _train_from_batch(self, batch, process_fn, update_fn):
        # input normalization: EMA of batch obs mean/std folded into the
        # policy input transforms before the update
        if self.input_normalization:
            obs = batch["observations"].reshape(
                -1, batch["observations"].shape[-1])
            valid = obs[batch["mask"].reshape(-1) > 0]
            data_shift = valid.mean(dim=0)
            data_scale = valid.std(dim=0, unbiased=False)
            tr = self.policy.transforms
            w = self.input_normalization
            self.policy.set_transformations(
                in_shift=w * tr.in_shift + (1 - w) * data_shift,
                in_scale=w * tr.in_scale + (1 - w) * data_scale,
                out_shift=tr.out_shift, out_scale=tr.out_scale)
        return super()._train_from_batch(batch, process_fn, update_fn)

    def _log_update_stats(self, stats, t_update):
        self.logger.log_kv("alpha", float(stats["alpha"]))
        self.logger.log_kv("delta", float(stats["delta"]))
        self.logger.log_kv("time_vpg", t_update)
        self.logger.log_kv("time_npg", t_update)
        self.logger.log_kv("kl_dist", float(stats["kl_dist"]))
        self.logger.log_kv("surr_improvement",
                           float(stats["surr_after"])
                           - float(stats["surr_before"]))
