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
``gae_with_dones``) cut the chain wherever ``done`` is 1 (an episode's last
step) and bootstrap the trailing, time-limit truncated episode with the
value of the obs after the last step.
"""

import torch

from mjrl_tpu_torch.parallel.mesh import all_reduce_sum


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
    """Per-step discounted returns over an autoreset grid: the discount
    chain breaks at episode boundaries (done_t = 1 at each episode's last
    step).  rewards / dones: (..., T)."""
    T = rewards.shape[-1]
    out = torch.empty_like(rewards)
    carry = torch.zeros_like(rewards[..., 0])
    for t in range(T - 1, -1, -1):
        carry = rewards[..., t] + gamma * carry * (1.0 - dones[..., t])
        out[..., t] = carry
    return out


def gae_with_dones(rewards, values, dones, v_last, gamma, lam):
    """GAE over an autoreset grid.  v_last (...,) = V(obs after the last
    step), the bootstrap of the trailing (time-limit truncated) episode;
    terminal steps (done = 1) bootstrap 0."""
    v_next = torch.cat([values[..., 1:], v_last[..., None]], dim=-1)
    deltas = rewards + gamma * v_next * (1.0 - dones) - values
    T = rewards.shape[-1]
    out = torch.empty_like(rewards)
    carry = torch.zeros_like(rewards[..., 0])
    for t in range(T - 1, -1, -1):
        carry = deltas[..., t] + gamma * lam * (1.0 - dones[..., t]) * carry
        out[..., t] = carry
    return out


# Batched variants: the functions above already take a leading batch axis.
batched_returns = discounted_returns
batched_gae = gae_advantages
batched_returns_dones = returns_with_dones
batched_gae_dones = gae_with_dones


def masked_moments(x, mask=None, mesh=None):
    """(count, mean, std) over the rows of ``x`` (dim 0) where ``mask``
    (rows,) is 1, the population std.  Under a ``mesh``: over every rank's
    rows, with two all-reduces in this order -- the count and the sum, then
    the centred second moment -- so that one rank and R ranks agree at
    roundoff."""
    w = torch.ones(x.shape[:1], dtype=x.dtype, device=x.device) \
        if mask is None else mask.to(x.dtype)
    w = w.reshape(w.shape + (1,) * (x.dim() - 1))
    first = all_reduce_sum(torch.cat([torch.sum(w).reshape(1),
                                      torch.sum(x * w, dim=0).reshape(-1)]),
                           mesh)
    n = torch.clamp(first[0], min=1.0)
    mean = (first[1:] / n).reshape(x.shape[1:])
    var = all_reduce_sum(torch.sum(w * (x - mean) ** 2, dim=0), mesh) / n
    return n, mean, torch.sqrt(var)


def whiten(adv, mask=None, eps=1e-6, mesh=None):
    """Advantage whitening: (a - mean) / (std + 1e-6), computed over valid
    entries only (of every rank's rows under a ``mesh``)."""
    _, mean, std = masked_moments(adv, mask, mesh)
    out = (adv - mean) / (std + eps)
    if mask is not None:
        out = out * mask
    return out
