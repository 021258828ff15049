"""Diagonal-Gaussian policy distribution, closed forms (counterpart of
``mjrl_tpu/distributions.py``).

- log-likelihood: -0.5 * sum(z^2) - sum(log_std) - 0.5 * d * log(2*pi)
- mean KL(old || new) per sample:
  sum(((mu_o - mu_n)^2 + s_o^2 - s_n^2) / (2 s_n^2 + 1e-8) + ls_n - ls_o)
- likelihood ratio: exp(LL_new - LL_old)

All functions broadcast over leading batch axes.
"""

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def log_likelihood(actions, mean, log_std):
    """Diagonal-gaussian log density.  actions/mean: (..., d); log_std: (d,)
    or broadcastable.  Returns (...,)."""
    zs = (actions - mean) / torch.exp(log_std)
    d = actions.shape[-1]
    return (-0.5 * torch.sum(zs ** 2, dim=-1)
            - torch.sum(log_std * torch.ones_like(mean), dim=-1)
            - 0.5 * d * LOG_2PI)


def likelihood_ratio(ll_new, ll_old):
    return torch.exp(ll_new - ll_old)


def kl_divergence(old_mean, old_log_std, new_mean, new_log_std):
    """Per-sample KL(old || new), summed over action dims. Returns (...,)."""
    old_std = torch.exp(old_log_std)
    new_std = torch.exp(new_log_std)
    nr = (old_mean - new_mean) ** 2 + old_std ** 2 - new_std ** 2
    dr = 2.0 * new_std ** 2 + 1e-8
    return torch.sum(nr / dr + new_log_std - old_log_std, dim=-1)


def mean_kl(old_mean, old_log_std, new_mean, new_log_std):
    return torch.mean(kl_divergence(old_mean, old_log_std, new_mean,
                                    new_log_std))


def sample(generator, mean, log_std):
    """action = mean + exp(log_std) * N(0, I)."""
    noise = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                        device=mean.device)
    return mean + torch.exp(log_std) * noise


def entropy(log_std):
    d = log_std.shape[-1]
    return 0.5 * d * (1.0 + LOG_2PI) + torch.sum(log_std, dim=-1)
