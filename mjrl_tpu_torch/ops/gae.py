"""Discounted returns and GAE as reverse loops over time (counterpart of
``mjrl_tpu/ops/gae.py``).

- ``discount_sum(x, gamma, terminal)``: reverse discounted cumulative sum.
- GAE advantages use TD deltas ``r_t + gamma * V_{t+1} - V_t`` where the
  bootstrap value ``V_T`` is ``V_{T-1}`` for a time-limit truncated path and
  ``0.0`` for a genuinely terminated path.

Time is the LAST axis; any leading axes are batch, so the same functions
serve one path ``(T,)`` and a batch ``(N, T)``.  The reverse recurrence is
a Python loop over T whose body is one elementwise op over the batch.

The done-aware variants for autoreset grids (``returns_with_dones``,
``gae_with_dones``) are not ported yet (ROADMAP.md queue 1).
"""

import torch


def discount_sum(x, gamma, terminal=0.0):
    """Reverse discounted cumsum of ``x`` (..., T) with terminal bootstrap.

    y_t = x_t + gamma * y_{t+1},  y_T = terminal.
    """
    T = x.shape[-1]
    out = torch.empty_like(x)
    carry = torch.zeros_like(x[..., 0]) + terminal
    for t in range(T - 1, -1, -1):
        carry = x[..., t] + gamma * carry
        out[..., t] = carry
    return out


def discounted_returns(rewards, gamma, mask=None):
    """Per-step discounted returns, (..., T).

    ``mask`` (optional, in {0,1}) marks valid steps; invalid steps
    contribute zero reward and receive zero return.  The discount chain is
    *not* broken by the mask (valid steps are assumed to be a prefix).
    """
    if mask is not None:
        rewards = rewards * mask
    ret = discount_sum(rewards, gamma)
    if mask is not None:
        ret = ret * mask
    return ret


def gae_advantages(rewards, values, gamma, lam, terminated=False, mask=None):
    """GAE(lambda) advantages.

    rewards, values: (..., T).  terminated: bool (...,) — True if the
    episode genuinely ended (bootstrap value 0), False if time-limit
    truncated (bootstrap with the last valid value).

    When ``lam`` is None, or outside [0, 1], falls back to "standard mode":
    A = returns - values.
    """
    if lam is None or (isinstance(lam, float) and (lam < 0.0 or lam > 1.0)):
        returns = discounted_returns(rewards, gamma, mask)
        adv = returns - values
        if mask is not None:
            adv = adv * mask
        return adv

    terminated = torch.as_tensor(terminated, device=values.device)
    zero = torch.zeros_like(values[..., -1])
    if mask is None:
        bootstrap = torch.where(terminated, zero, values[..., -1])
        v_next = torch.cat([values[..., 1:], bootstrap[..., None]], dim=-1)
        deltas = rewards + gamma * v_next - values
    else:
        # The episode may end before the grid does (early termination with
        # freeze-after-done padding).  The bootstrap must apply at the MASK
        # boundary: the TD delta of the last VALID step uses 0 when
        # terminated, or V(last valid obs) when time-limit truncated —
        # never V(frozen post-terminal obs).
        idx_last = torch.clamp(mask.sum(dim=-1).to(torch.int64) - 1, min=0)
        v_lastvalid = torch.gather(values, -1, idx_last[..., None])[..., 0]
        bootstrap = torch.where(terminated, zero, v_lastvalid)
        v_next = torch.cat([
            torch.where(mask[..., 1:] > 0, values[..., 1:],
                        bootstrap[..., None]),
            bootstrap[..., None]], dim=-1)
        deltas = (rewards + gamma * v_next - values) * mask
    adv = discount_sum(deltas, gamma * lam)
    if mask is not None:
        adv = adv * mask
    return adv


def returns_with_dones(rewards, dones, gamma):
    raise NotImplementedError(
        "autoreset grids are not ported (ROADMAP.md queue 1)")


def gae_with_dones(rewards, values, dones, v_last, gamma, lam):
    raise NotImplementedError(
        "autoreset grids are not ported (ROADMAP.md queue 1)")


# Batched variants: the functions above already take a leading batch axis.
batched_returns = discounted_returns
batched_gae = gae_advantages


def whiten(adv, mask=None, eps=1e-6):
    """Advantage whitening: (a - mean) / (std + 1e-6), computed over valid
    entries only."""
    if mask is None:
        mean = torch.mean(adv)
        std = torch.std(adv, unbiased=False)
    else:
        n = torch.clamp(torch.sum(mask), min=1.0)
        mean = torch.sum(adv * mask) / n
        var = torch.sum(mask * (adv - mean) ** 2) / n
        std = torch.sqrt(var)
    out = (adv - mean) / (std + eps)
    if mask is not None:
        out = out * mask
    return out
