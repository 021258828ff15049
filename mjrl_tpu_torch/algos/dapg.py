"""DAPG: demo-augmented NPG (counterpart of ``mjrl_tpu/algos/dapg.py``).

- demo advantage = lam_0 * lam_1^iter, decaying once per update;
- the gradient is over [rollout, demo] data with advantages
  1e-2 * [adv / (masked std(adv) + 1e-8), demo_adv], multiplied by
  sample_coef = (n_valid + n_demo) / n_valid;
- the Fisher metric, CG (started at x0 = g), the step size and the KL use
  on-policy data only; unlike NPG there is no KL guard and no constant
  learning rate.

The iteration counter is carried through the update like an optimizer
state (``opt_state``, a 0-d tensor on the device), so the decay needs no
host sync.  The demo arrays take the policy's dtype.

Under a ``mesh`` every rank holds all the demo rows; each takes its part of
them (``Mesh.cut``, any count), and ``n_valid`` and the advantages' std
are over every rank's rows, so ``sample_coef`` and the gradient are the
one-rank ones.
"""

import numpy as np
import torch

from mjrl_tpu_torch.algos import functional as F
from mjrl_tpu_torch.algos.npg_cg import NPG
from mjrl_tpu_torch.ops.cg import cg_solve
from mjrl_tpu_torch.ops.flat import tree_scale
from mjrl_tpu_torch.ops.gae import masked_moments


class DAPG(NPG):
    def __init__(self, env, policy, baseline,
                 demo_paths=None,
                 normalized_step_size=0.01,
                 FIM_invert_args={"iters": 10, "damping": 1e-4},
                 hvp_sample_frac=1.0,
                 seed=123,
                 save_logs=False,
                 kl_dist=None,
                 lam_0=1.0,
                 lam_1=0.95,
                 **kwargs):
        super().__init__(env, policy, baseline,
                         normalized_step_size=normalized_step_size,
                         FIM_invert_args=FIM_invert_args,
                         hvp_sample_frac=hvp_sample_frac, seed=seed,
                         save_logs=save_logs, kl_dist=kl_dist, **kwargs)
        self.kl_dist = kl_dist if kl_dist is not None \
            else 0.5 * normalized_step_size
        self.n_step_size = 2.0 * self.kl_dist
        self.demo_paths = demo_paths
        self.lam_0 = lam_0
        self.lam_1 = lam_1
        self.iter_count = 0.0
        like = dict(dtype=policy.dtype, device=self.device)
        if demo_paths is not None:
            self._demo_obs = torch.as_tensor(np.concatenate(
                [p["observations"] for p in demo_paths]), **like)
            self._demo_act = torch.as_tensor(np.concatenate(
                [p["actions"] for p in demo_paths]), **like)
        else:
            self._demo_obs = None
        self._has_opt_state = True
        self.opt_state = torch.zeros((), **like)

    def _update_core(self, params, transforms, obs, act, adv, mask,
                     generator, iter_count, mesh=None):
        pol = self.policy.config
        damping = self.FIM_invert_args.get("damping", 1e-4)
        iters = self.FIM_invert_args.get("iters", 10)

        with torch.no_grad():
            surr_before = F.cpi_surrogate(pol, params, params, transforms,
                                          obs, act, adv, mask, mesh)
        if self._demo_obs is not None and self.lam_0 > 0.0:
            n_demo = self._demo_obs.shape[0]
            demo_obs, demo_act = self._demo_obs, self._demo_act
            if mesh is not None:        # this rank's part of the demos
                demo_obs, demo_act = mesh.cut(demo_obs), mesh.cut(demo_act)
            ones = torch.ones((demo_obs.shape[0],), dtype=adv.dtype,
                              device=adv.device)
            demo_adv = self.lam_0 * self.lam_1 ** iter_count * ones
            # masked std of the (already whitened) advantages
            n_valid, _, std_a = masked_moments(adv, mask, mesh)
            all_obs = torch.cat([obs, demo_obs])
            all_act = torch.cat([act, demo_act])
            all_adv = 1e-2 * torch.cat([adv / (std_a + 1e-8), demo_adv])
            all_mask = torch.cat([mask, ones.to(mask.dtype)])
            sample_coef = (n_valid + n_demo) / n_valid
            g = F.vpg_grad(pol, params, params, transforms, all_obs,
                           all_act, all_adv, all_mask, mesh)
            g = tree_scale(g, sample_coef)
        else:
            g = F.vpg_grad(pol, params, params, transforms, obs, act, adv,
                           mask, mesh)

        hvp = F.make_hvp(pol, params, transforms, obs, mask, damping,
                         generator, self.hvp_subsample, mesh)
        npg = cg_solve(hvp, g, x0=g, cg_iters=iters)
        with torch.no_grad():
            alpha, delta = F.npg_step_size(g, npg, self.n_step_size)
            new_params = F.apply_step(pol, params, npg, alpha)
            surr_after = F.cpi_surrogate(pol, new_params, params,
                                         transforms, obs, act, adv, mask,
                                         mesh)
            kl = F.mean_kl(pol, new_params, params, transforms, obs, mask,
                           mesh)
        stats = dict(alpha=alpha, delta=delta, surr_before=surr_before,
                     surr_after=surr_after, kl_dist=kl)
        return new_params, stats, iter_count + 1.0

    def _train_from_batch(self, batch, process_fn, update_fn, mesh=None):
        out = super()._train_from_batch(batch, process_fn, update_fn, mesh)
        self.iter_count = float(self.opt_state)
        return out
