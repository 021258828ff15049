"""Weights and state carried across between the JAX package's layout and
the port's (no JAX import: everything crosses as numpy).

The JAX policy pytree is ``{"layers": [{"w": (in, out), "b": (out,)}, ...],
"log_std": (act,)}`` with a ``Transforms`` tuple (in_shift, in_scale,
out_shift, out_scale); the port's parameters are ``nn.Linear``-shaped:
``layers.<i>.weight`` is ``(out, in)`` — the transpose.
"""

import numpy as np
import torch


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def params_from_numpy(params, dtype=torch.float32, device=None):
    """JAX-layout pytree (numpy leaves) -> the port's parameter dict."""
    out = {}
    for i, layer in enumerate(params["layers"]):
        out[f"layers.{i}.weight"] = torch.as_tensor(
            np.asarray(layer["w"]).T.copy(), dtype=dtype, device=device)
        out[f"layers.{i}.bias"] = torch.as_tensor(
            np.asarray(layer["b"]), dtype=dtype, device=device)
    out["log_std"] = torch.as_tensor(np.asarray(params["log_std"]),
                                     dtype=dtype, device=device)
    return out


def params_to_numpy(params):
    """The port's parameter dict (or any dict shaped like it, e.g. a
    gradient) -> JAX-layout pytree of float64 numpy arrays."""
    n = sum(1 for k in params if k.endswith(".weight"))
    return {
        "layers": [{"w": _np(params[f"layers.{i}.weight"]).T.astype(
                        np.float64),
                    "b": _np(params[f"layers.{i}.bias"]).astype(np.float64)}
                   for i in range(n)],
        "log_std": _np(params["log_std"]).astype(np.float64),
    }


def policy_params_from_numpy(policy, params, transforms=None):
    """Load a JAX-layout pytree (and optionally its Transforms, as a
    4-tuple of arrays) into a port ``Policy``: new and old parameter
    copies, clamped at ``min_log_std`` as on every parameter set."""
    tree = policy.config.clamp(
        params_from_numpy(params, policy.dtype, policy.device))
    policy.params = tree
    policy.old_params = {k: v.clone() for k, v in tree.items()}
    if transforms is not None:
        policy.set_transformations(*(np.asarray(t) for t in transforms))
    return policy


def policy_params_to_numpy(policy):
    """-> (JAX-layout pytree, 4-tuple of transform arrays) of a port
    ``Policy``."""
    return (params_to_numpy(policy.params),
            tuple(_np(t).astype(np.float64) for t in policy.transforms))


def linear_baseline_from_numpy(baseline, coeffs):
    """Load least-squares coefficients (the JAX LinearBaseline state) into
    a port ``LinearBaseline`` host object."""
    baseline.state = torch.as_tensor(np.asarray(coeffs),
                                     dtype=baseline.dtype,
                                     device=baseline.device)
    return baseline


def linear_baseline_to_numpy(baseline):
    return _np(baseline.state).astype(np.float64)
