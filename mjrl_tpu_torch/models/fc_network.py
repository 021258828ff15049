"""Fully-connected network with data-dependent input/output transforms
(counterpart of ``mjrl_tpu/models/fc_network.py``):

    out = W_n(act(... W_1((x - in_shift) / (in_scale + 1e-8)) ...)) \
          * out_scale + out_shift

The shift/scale transforms are non-trainable; they are load-bearing for
NPG input normalization, so they live in a separate ``Transforms`` tuple
that is carried alongside the trainable parameters but excluded from
gradients and flat parameter vectors.

Parameters are a dict ``{"layers.<i>.weight": (out, in), "layers.<i>.bias":
(out,)}`` in ``torch.nn.Linear``'s layout — what ``named_parameters()`` of
an ``nn.ModuleList`` of ``nn.Linear`` gives.  Init matches nn.Linear's
default: W, b ~ U(-1/sqrt(fan_in), +1/sqrt(fan_in)), from an explicit
generator.
"""

import math
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F


class Transforms(NamedTuple):
    in_shift: Any
    in_scale: Any
    out_shift: Any
    out_scale: Any


def identity_transforms(in_dim, out_dim, dtype=torch.float32, device=None):
    return make_transforms(in_dim, out_dim, dtype=dtype, device=device)


def make_transforms(in_dim, out_dim, in_shift=None, in_scale=None,
                    out_shift=None, out_scale=None, dtype=torch.float32,
                    device=None):
    """Build a Transforms tuple, defaulting missing entries to identity."""
    def _or(x, default, dim):
        if x is None:
            return torch.full((dim,), default, dtype=dtype, device=device)
        return torch.as_tensor(x, dtype=dtype, device=device)
    return Transforms(
        in_shift=_or(in_shift, 0.0, in_dim),
        in_scale=_or(in_scale, 1.0, in_dim),
        out_shift=_or(out_shift, 0.0, out_dim),
        out_scale=_or(out_scale, 1.0, out_dim),
    )


def init_linear_(linear, generator, scale=1.0):
    """nn.Linear default init, U(-k, k) with k = 1/sqrt(in_dim), drawn
    from ``generator`` (on the generator's device) in place."""
    k = 1.0 / math.sqrt(linear.in_features)
    with torch.no_grad():
        for p in (linear.weight, linear.bias):
            u = torch.rand(p.shape, generator=generator, dtype=p.dtype,
                           device=generator.device)
            p.copy_(((u * 2.0 - 1.0) * (k * scale)).to(p.device))


def num_layers(params):
    return sum(1 for k in params if k.startswith("layers.")
               and k.endswith(".weight"))


def mlp_forward(params, transforms, x, nonlinearity="tanh"):
    """Forward pass.  x: (..., in_dim) -> (..., out_dim)."""
    act = torch.tanh if nonlinearity == "tanh" else torch.relu
    n = num_layers(params)
    out = (x - transforms.in_shift) / (transforms.in_scale + 1e-8)
    for i in range(n - 1):
        out = act(F.linear(out, params[f"layers.{i}.weight"],
                           params[f"layers.{i}.bias"]))
    out = F.linear(out, params[f"layers.{n - 1}.weight"],
                   params[f"layers.{n - 1}.bias"])
    return out * transforms.out_scale + transforms.out_shift
