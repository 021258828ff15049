"""Pure functional algorithm cores (counterpart of
``mjrl_tpu/algos/functional.py``).

- CPI surrogate: mean(likelihood_ratio * advantage) over valid steps.
- VPG gradient: autograd of the surrogate on the parameter dict.
- Fisher-vector products: the Hessian-vector product of the mean KL at the
  current parameters (+ damping), in the Gaussian's closed form: one
  hand-written kernel a product on the card (``ops/cuda_fvp.py``).
- NPG direction: CG on parameter dicts; step size
  alpha = sqrt(|delta / g.F^-1 g|).
- Optional HVP subsampling via a random subset of rows.

All functions take a (policy module, params dict, transforms) triple and
flat (batch, ...) data tensors with an optional validity mask.  Under a
``mesh`` (``parallel/mesh.py``) the rows are this rank's of a batch split
over the ranks: every mean is over all ranks' rows (numerator and count
all-reduced), the gradient and each Fisher-vector product are all-reduced,
and what comes out is the same on every rank.
"""

import torch

from mjrl_tpu_torch import distributions as dist
from mjrl_tpu_torch.ops.cg import cg_solve
from mjrl_tpu_torch.ops.cuda_fvp import FisherVectorProduct
from mjrl_tpu_torch.ops.flat import tree_add_scaled, tree_dot
from mjrl_tpu_torch.parallel.mesh import (all_reduce_sum, all_reduce_tree,
                                          local_index, row_offset)
from mjrl_tpu_torch.utils.profiling import spanned


def _sum_count(x, mask):
    if mask is None:
        return torch.sum(x), torch.full((), x.numel(), dtype=x.dtype,
                                        device=x.device)
    return torch.sum(x * mask), torch.sum(mask).to(x.dtype)


def _masked_mean(x, mask, mesh=None):
    """Mean of ``x`` over the valid rows (of every rank: the sum and the
    count in one all-reduce; no gradient crosses it)."""
    num, den = all_reduce_sum(torch.stack(_sum_count(x, mask)), mesh)
    return num / torch.clamp(den, min=1.0)


def _local_share(x, mask, mesh):
    """This rank's share of the mean over every rank's valid rows: its own
    sum over the global count (all-reduced).  The ranks' shares sum to the
    mean, so the all-reduce of their gradients is its gradient."""
    num, den = _sum_count(x, mask)
    return num / torch.clamp(all_reduce_sum(den.detach(), mesh), min=1.0)


def _detach(params):
    return {k: v.detach() for k, v in params.items()}


def log_likelihoods(policy, params, transforms, obs, act):
    mu, ls = policy.dist_info(params, transforms, obs)
    return dist.log_likelihood(act, mu, ls)


def _surrogate_terms(policy, params, params_old, transforms, obs, act,
                     adv):
    ll_new = log_likelihoods(policy, params, transforms, obs, act)
    with torch.no_grad():
        ll_old = log_likelihoods(policy, _detach(params_old), transforms,
                                 obs, act)
    return torch.exp(ll_new - ll_old) * adv


def cpi_surrogate(policy, params, params_old, transforms, obs, act, adv,
                  mask=None, mesh=None):
    """mean(LR * A)."""
    return _masked_mean(_surrogate_terms(policy, params, params_old,
                                         transforms, obs, act, adv),
                        mask, mesh)


def _kl_terms(policy, params_new, params_old, transforms, obs):
    mu_n, ls_n = policy.dist_info(params_new, transforms, obs)
    mu_o, ls_o = policy.dist_info(params_old, transforms, obs)
    return dist.kl_divergence(mu_o, ls_o.expand_as(mu_o), mu_n,
                              ls_n.expand_as(mu_n))


def mean_kl(policy, params_new, params_old, transforms, obs, mask=None,
            mesh=None):
    return _masked_mean(_kl_terms(policy, params_new, params_old, transforms,
                                  obs), mask, mesh)


def _leaf_params(params):
    return {k: v.detach().requires_grad_(True) for k, v in params.items()}


@spanned("vpg_grad")
def vpg_grad(policy, params, params_old, transforms, obs, act, adv,
             mask=None, mesh=None):
    """Policy gradient of the surrogate, as a parameter dict (under a
    ``mesh``: this rank's share, then one all-reduce of the flattened
    gradient)."""
    with torch.enable_grad():
        p = _leaf_params(params)
        surr = _local_share(_surrogate_terms(policy, p, params_old,
                                             transforms, obs, act, adv),
                            mask, mesh)
        grads = torch.autograd.grad(surr, list(p.values()))
    return all_reduce_tree(dict(zip(p, grads)), mesh)


def make_hvp(policy, params, transforms, obs, mask=None, damping=1e-4,
             generator=None, hvp_sample_frac=1.0, mesh=None):
    """Fisher-vector product at ``params``: F v + damping v.

    F is the Hessian of KL(old || new) in the new params at new = old =
    params, in its closed form for the Gaussian policy
    (``ops/cuda_fvp.py``): the hand-written kernel for CUDA tensors of a
    shape it takes, the plain closed form otherwise; no autograd graph is
    kept.  With ``hvp_sample_frac`` < 1, a random subset of rows is used:
    a permutation of all rows (of every rank's, under a ``mesh``), of which
    each rank keeps the rows it holds.  Under a ``mesh`` each product is
    all-reduced: one collective per CG iteration.
    """
    if hvp_sample_frac < 0.99 and generator is not None:
        lo, n = row_offset(obs.shape[0], mesh)
        k = max(1, int(n * hvp_sample_frac))
        idx = torch.randperm(n, generator=generator,
                             device=generator.device)[:k].to(obs.device)
        idx, own = local_index(idx, lo, obs.shape[0])  # the rows it holds
        own = own.to(obs.dtype)
        mask = own if mask is None else mask[idx] * own
        obs = obs[idx]

    with torch.no_grad():
        rows = torch.full((), obs.shape[0], dtype=obs.dtype,
                          device=obs.device) if mask is None \
            else torch.sum(mask).to(obs.dtype)
        count = torch.clamp(all_reduce_sum(rows, mesh), min=1.0)
        fvp = FisherVectorProduct(params, policy.nonlinearity, transforms,
                                  obs, mask, rows, count)
    offsets, i = {}, 0
    for k in fvp.keys:
        offsets[k] = i
        i += params[k].numel()

    def hvp(v):
        with torch.no_grad():
            flat = torch.cat([v[k].detach().reshape(-1) for k in fvp.keys])
            hv = all_reduce_sum(fvp(flat), mesh) + damping * flat
        return {k: hv[offsets[k]:offsets[k] + p.numel()].view(p.shape)
                for k, p in params.items()}

    return hvp


def npg_direction(policy, params, transforms, obs, act, adv, mask=None,
                  damping=1e-4, cg_iters=10, generator=None,
                  hvp_sample_frac=1.0, mesh=None):
    """-> (vpg_grad, F^-1 g) via CG."""
    g = vpg_grad(policy, params, params, transforms, obs, act, adv, mask,
                 mesh)
    hvp = make_hvp(policy, params, transforms, obs, mask, damping,
                   generator, hvp_sample_frac, mesh)
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
