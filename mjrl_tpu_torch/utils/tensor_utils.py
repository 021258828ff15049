"""Host-side helpers for nested-dict path data (counterpart of
``mjrl_tpu/utils/tensor_utils.py``).

The leaves are numpy arrays or torch tensors; a function of several trees
keeps the kind of their leaves (``np.stack`` or ``torch.stack``, and so
on).  Batched code on the device never needs any of this.
"""

import numpy as np
import torch


def _map(fn, *trees):
    """``fn`` over the matching leaves of nested dicts."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def stack_tensor_dict_list(dicts):
    """List of (nested) dicts of arrays -> one dict of stacked arrays, new
    leading axis."""
    return _map(lambda *xs: torch.stack(xs) if torch.is_tensor(xs[0])
                else np.stack(xs), *dicts)


def concat_tensor_dict_list(dicts):
    """Like :func:`stack_tensor_dict_list` but concatenates along the
    existing leading axis."""
    return _map(lambda *xs: torch.cat(xs) if torch.is_tensor(xs[0])
                else np.concatenate(xs, axis=0), *dicts)


def split_tensor_dict_list(tensor_dict):
    """Inverse of :func:`stack_tensor_dict_list`: dict of arrays with a
    common leading axis -> list of per-index dicts."""
    n = len(_leaves(tensor_dict)[0])
    return [_map(lambda x: x[i], tensor_dict) for i in range(n)]


def flatten_tensors(tensors):
    """Concatenate arbitrary-shape arrays into one flat vector."""
    if not len(tensors):
        return np.asarray([])
    if torch.is_tensor(tensors[0]):
        return torch.cat([t.reshape(-1) for t in tensors])
    return np.concatenate([np.ravel(t) for t in tensors])


def unflatten_tensors(flat, shapes):
    """Inverse of :func:`flatten_tensors` given the original shapes."""
    sizes = [int(np.prod(s)) for s in shapes]
    if torch.is_tensor(flat):
        return [c.reshape(s) for c, s in zip(torch.split(flat, sizes),
                                             shapes)]
    return [c.reshape(s) for c, s in zip(np.split(flat, np.cumsum(sizes)[:-1]),
                                         shapes)]


def pad_tensor_n(xs, max_len):
    """Ragged list of (T_i, ...) arrays -> zero-padded (N, max_len, ...)."""
    if torch.is_tensor(xs[0]):
        out = xs[0].new_zeros((len(xs), max_len) + tuple(xs[0].shape[1:]))
    else:
        out = np.zeros((len(xs), max_len) + xs[0].shape[1:],
                       dtype=xs[0].dtype)
    for i, x in enumerate(xs):
        out[i, :len(x)] = x
    return out
