"""Adam and AdamW on parameter dicts (the port's counterpart of the
``optax.adam`` / ``optax.adamw`` transformations the JAX package uses in
``models/baselines.py``, ``algos/ppo_clip.py`` and
``algos/behavior_cloning.py``).

optax's order of operations, one step at count t (from 1):

    mu <- b1 mu + (1 - b1) g            nu <- b2 nu + (1 - b2) g^2
    u  <- (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
    u  <- u + weight_decay * p          (adamw only: decoupled decay)
    p  <- p - lr u

The state is ``{"count": int, "mu": {name: tensor}, "nu": {name: tensor}}``
and persists across calls, like an optax state carried by the caller.  For
a stack of models on a leading axis (the world-model ensemble) ``count``
may be an (M,) tensor: each member's bias correction then takes its own
count, as the JAX package's ``vmap`` over per-member optax states does.
``adam_step_`` works in place on the parameter and moment tensors
(``torch._foreach_*``: a few launches per step whatever the number of
tensors); a caller that must leave its input state untouched steps on
``adam_copy(state)``.
"""

import torch


def adam_init(params):
    """Zero moments shaped like ``params`` (a dict of tensors)."""
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    return {"count": 0, "mu": zeros,
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def adam_copy(state):
    """A copy of an Adam state whose moments share no storage with it."""
    return {"count": state["count"],
            "mu": {k: v.clone() for k, v in state["mu"].items()},
            "nu": {k: v.clone() for k, v in state["nu"].items()}}


@torch.no_grad()
def adam_step_(params, grads, state, lr, weight_decay=0.0, b1=0.9, b2=0.999,
               eps=1e-8):
    """One Adam (``weight_decay`` 0) or AdamW step, in place on the tensors
    of ``params`` and ``state`` (dicts with the same keys as ``grads``);
    -> the new state."""
    keys = list(params)
    p = [params[k] for k in keys]
    g = [grads[k] for k in keys]
    mu = [state["mu"][k] for k in keys]
    nu = [state["nu"][k] for k in keys]
    t = state["count"] + 1
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, g, alpha=1.0 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
    if torch.is_tensor(t):          # one count per member of a stack
        c1 = 1.0 - torch.pow(b1, t.to(torch.float64))
        c2 = 1.0 - torch.pow(b2, t.to(torch.float64))
        col = lambda c, x: c.to(x.dtype).reshape((-1,) + (1,) * (x.dim()
                                                                 - 1))
        mu_hat = [m / col(c1, m) for m in mu]
        denom = [v / col(c2, v) for v in nu]
    else:
        mu_hat = torch._foreach_div(mu, 1.0 - b1 ** t)
        denom = torch._foreach_div(nu, 1.0 - b2 ** t)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(mu_hat, denom)
    if weight_decay:
        torch._foreach_add_(upd, p, alpha=weight_decay)
    torch._foreach_add_(p, upd, alpha=-lr)
    return {"count": t, "mu": state["mu"], "nu": state["nu"]}
