"""Pure functional algorithm cores (counterpart of
``mjrl_tpu/algos/functional.py``).

- CPI surrogate: mean(likelihood_ratio * advantage) over valid steps.
- VPG gradient: autograd of the surrogate on the parameter dict.
- Fisher-vector products: the Hessian-vector product of the mean KL at the
  current parameters (+ damping) by double backward; the first-order graph
  is built once and reused by every CG iteration.
- NPG direction: CG on parameter dicts; step size
  alpha = sqrt(|delta / g.F^-1 g|).
- Optional HVP subsampling via a random subset of rows.

All functions take a (policy module, params dict, transforms) triple and
flat (batch, ...) data tensors with an optional validity mask.
"""

import torch

from mjrl_tpu_torch import distributions as dist
from mjrl_tpu_torch.ops.cg import cg_solve
from mjrl_tpu_torch.ops.flat import tree_add_scaled, tree_dot


def _masked_mean(x, mask):
    if mask is None:
        return torch.mean(x)
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _detach(params):
    return {k: v.detach() for k, v in params.items()}


def log_likelihoods(policy, params, transforms, obs, act):
    mu, ls = policy.dist_info(params, transforms, obs)
    return dist.log_likelihood(act, mu, ls)


def cpi_surrogate(policy, params, params_old, transforms, obs, act, adv,
                  mask=None):
    """mean(LR * A)."""
    ll_new = log_likelihoods(policy, params, transforms, obs, act)
    with torch.no_grad():
        ll_old = log_likelihoods(policy, _detach(params_old), transforms,
                                 obs, act)
    lr = torch.exp(ll_new - ll_old)
    return _masked_mean(lr * adv, mask)


def mean_kl(policy, params_new, params_old, transforms, obs, mask=None):
    mu_n, ls_n = policy.dist_info(params_new, transforms, obs)
    mu_o, ls_o = policy.dist_info(params_old, transforms, obs)
    kl = dist.kl_divergence(mu_o, ls_o.expand_as(mu_o), mu_n,
                            ls_n.expand_as(mu_n))
    return _masked_mean(kl, mask)


def _leaf_params(params):
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


def vpg_grad(policy, params, params_old, transforms, obs, act, adv,
             mask=None):
    """Policy gradient of the surrogate, as a parameter dict."""
    with torch.enable_grad():
        p = _leaf_params(params)
        surr = cpi_surrogate(policy, p, params_old, transforms, obs, act,
                             adv, mask)
        grads = torch.autograd.grad(surr, list(p.values()))
    return dict(zip(p, grads))


def make_hvp(policy, params, transforms, obs, mask=None, damping=1e-4,
             generator=None, hvp_sample_frac=1.0):
    """Fisher-vector product at ``params``: F v + damping v.

    F is the Hessian of KL(old || new) in the new params at new = old =
    params.  With ``hvp_sample_frac`` < 1, a random subset of rows is used.
    """
    if hvp_sample_frac < 0.99 and generator is not None:
        n = obs.shape[0]
        k = max(1, int(n * hvp_sample_frac))
        idx = torch.randperm(n, generator=generator,
                             device=generator.device)[:k].to(obs.device)
        obs = obs[idx]
        mask = None if mask is None else mask[idx]

    with torch.enable_grad():
        p = _leaf_params(params)
        kl = mean_kl(policy, p, _detach(params), transforms, obs, mask)
        leaves = list(p.values())
        grad_kl = torch.autograd.grad(kl, leaves, create_graph=True)

    def hvp(v):
        with torch.enable_grad():
            gv = sum(torch.sum(g * v[k].detach())
                     for g, k in zip(grad_kl, p))
            hv = torch.autograd.grad(gv, leaves, retain_graph=True)
        return tree_add_scaled(dict(zip(p, hv)), v, damping)

    return hvp


def npg_direction(policy, params, transforms, obs, act, adv, mask=None,
                  damping=1e-4, cg_iters=10, generator=None,
                  hvp_sample_frac=1.0):
    """-> (vpg_grad, F^-1 g) via CG."""
    g = vpg_grad(policy, params, params, transforms, obs, act, adv, mask)
    hvp = make_hvp(policy, params, transforms, obs, mask, damping,
                   generator, hvp_sample_frac)
    npg = cg_solve(hvp, g, x0=g, cg_iters=cg_iters)
    return g, npg


def npg_step_size(g, npg, n_step_size, const_alpha=None):
    """alpha = sqrt(|delta / (g . F^-1 g)|); or a constant learn rate with
    the implied delta."""
    gng = tree_dot(g, npg)
    if const_alpha is not None:
        alpha = torch.as_tensor(const_alpha, dtype=gng.dtype,
                                device=gng.device)
        delta = alpha ** 2 * gng
    else:
        alpha = torch.sqrt(torch.abs(n_step_size / (gng + 1e-20)))
        delta = torch.as_tensor(n_step_size, dtype=gng.dtype,
                                device=gng.device)
    return alpha, delta


def apply_step(policy, params, direction, alpha):
    """params + alpha * direction, with the min_log_std clamp applied on
    every set."""
    return policy.clamp(tree_add_scaled(params, direction, alpha))
