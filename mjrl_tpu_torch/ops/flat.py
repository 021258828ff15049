"""Flat-vector <-> parameter-dict interop and dict linear algebra
(counterpart of ``mjrl_tpu/ops/flat.py``).

A "tree" here is either a tensor or a dict of tensors (the policy's
``{name: tensor}`` parameters, in ``named_parameters()`` order).
"""

import torch


def ravel(tree):
    """dict of tensors -> (flat 1-D tensor, unravel_fn)."""
    keys = list(tree)
    shapes = [tree[k].shape for k in keys]
    sizes = [tree[k].numel() for k in keys]
    flat = torch.cat([tree[k].reshape(-1) for k in keys]) if keys \
        else torch.zeros(0)

    def unravel(vec):
        out, i = {}, 0
        for k, shp, n in zip(keys, shapes, sizes):
            out[k] = vec[i:i + n].reshape(shp)
            i += n
        return out

    return flat, unravel


def unravel_like(flat, tree):
    """Reshape a flat vector into the structure of ``tree``."""
    return ravel(tree)[1](flat)


def _map(fn, a, *rest):
    if isinstance(a, dict):
        return {k: fn(a[k], *(r[k] for r in rest)) for k in a}
    return fn(a, *rest)


def tree_dot(a, b):
    """Sum of elementwise products over two matching trees (a 0-d tensor)."""
    if isinstance(a, dict):
        return sum(torch.sum(a[k] * b[k]) for k in a)
    return torch.sum(a * b)


def tree_add_scaled(a, b, alpha):
    """a + alpha * b over trees."""
    return _map(lambda x, y: x + alpha * y, a, b)


def tree_scale(a, alpha):
    return _map(lambda x: alpha * x, a)


def tree_zeros_like(a):
    return _map(torch.zeros_like, a)


def tree_to(tree, device):
    """Every tensor of a nested dict / list / tuple moved to ``device``
    (detached); anything else is kept as it is.  Pickles hold CPU trees."""
    if torch.is_tensor(tree):
        return tree.detach().to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree
