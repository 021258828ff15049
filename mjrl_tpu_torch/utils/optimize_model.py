"""Generic minibatch model fitting (counterpart of
``mjrl_tpu/utils/optimize_model.py``, ``fit_data``).

Epochs x minibatches, each epoch over a fresh permutation of the samples
with the tail that does not fill a minibatch dropped; gradients from
autograd; returns the per-epoch mean losses.

``fit_data(loss_fn, params, x, y, optimizer, batch_size, epochs,
generator)`` where ``loss_fn(params, x_batch, y_batch) -> scalar tensor``
and ``params`` is a dict of tensors.  The default optimizer is the port's
Adam (``ops/adam.py``, optax's ``adam(learn_rate)``); ``optimizer=`` takes a
factory ``list of parameter tensors -> torch.optim.Optimizer`` instead,
whose ``state_dict()`` is then the returned ``opt_state``.
"""

import numpy as np
import torch

from mjrl_tpu_torch.device import make_generator
from mjrl_tpu_torch.ops.adam import adam_copy, adam_init, adam_step_


def _as_tensor(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def fit_data(loss_fn, params, x, y, optimizer=None, opt_state=None,
             batch_size=64, epochs=1, generator=None, learn_rate=1e-3,
             perms=None):
    """-> (params, opt_state, epoch losses list).  The inputs are left
    unchanged.  Each epoch's permutation comes from ``generator`` (default:
    a generator seeded 0 on the parameters' device); ``perms`` (epochs, n),
    for tests, replaces the drawn ones."""
    dev = next(iter(params.values())).device
    x, y = _as_tensor(x, dev), _as_tensor(y, dev)
    n = x.shape[0]
    bs = min(int(batch_size), n)
    num_steps = max(n // bs, 1)
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    leaves = list(p.values())
    if optimizer is None:
        state = adam_init(p) if opt_state is None else adam_copy(opt_state)
    else:
        opt = optimizer(leaves)
        if opt_state is not None:
            opt.load_state_dict(opt_state)
    if perms is not None:
        perms = torch.as_tensor(np.asarray(perms), dtype=torch.int64,
                                device=dev)
    elif generator is None:
        generator = make_generator(0, dev)
    epoch_losses = []
    for e in range(int(epochs)):
        perm = perms[e] if perms is not None else \
            torch.randperm(n, generator=generator, device=dev)
        step_losses = []
        for idx in perm[:num_steps * bs].reshape(num_steps, bs):
            with torch.enable_grad():
                loss = loss_fn(p, x[idx], y[idx])
                grads = torch.autograd.grad(loss, leaves)
            if optimizer is None:
                state = adam_step_(p, dict(zip(p, grads)), state, learn_rate)
            else:
                for leaf, g in zip(leaves, grads):
                    leaf.grad = g
                opt.step()
            step_losses.append(loss.detach())
        epoch_losses.append(torch.stack(step_losses).mean())
    if optimizer is not None:
        state = opt.state_dict()
    return ({k: v.detach() for k, v in p.items()}, state,
            [float(v) for v in epoch_losses])
