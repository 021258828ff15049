"""Weights and state carried across between the JAX package's layout and
the port's (no JAX import: everything crosses as numpy).

The JAX policy pytree is ``{"layers": [{"w": (in, out), "b": (out,)}, ...],
"log_std": (act,)}`` with a ``Transforms`` tuple (in_shift, in_scale,
out_shift, out_scale); the port's parameters are ``nn.Linear``-shaped:
``layers.<i>.weight`` is ``(out, in)`` — the transpose.  The JAX
``MLPBaseline`` state is ``(layers, optax state)`` with ``layers`` in the same
``init_mlp_params`` layout; only the layers cross (both Adam states start at
zero).  Least-squares baselines (linear, quadratic) cross as their
coefficient vector.
"""

import numpy as np
import torch

from mjrl_tpu_torch.ops.adam import adam_init


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def layers_from_numpy(layers, dtype=torch.float32, device=None):
    """JAX ``init_mlp_params`` layer list ``[{"w": (in, out), "b": (out,)}]``
    -> the port's ``{"layers.<i>.weight": (out, in), ...}``."""
    out = {}
    for i, layer in enumerate(layers):
        out[f"layers.{i}.weight"] = torch.as_tensor(
            np.asarray(layer["w"]).T.copy(), dtype=dtype, device=device)
        out[f"layers.{i}.bias"] = torch.tensor(
            np.asarray(layer["b"]), dtype=dtype, device=device)
    return out


def layers_to_numpy(params):
    """The port's layer dict -> JAX layer list of float64 numpy arrays."""
    n = sum(1 for k in params if k.endswith(".weight"))
    return [{"w": _np(params[f"layers.{i}.weight"]).T.astype(np.float64),
             "b": _np(params[f"layers.{i}.bias"]).astype(np.float64)}
            for i in range(n)]


def params_from_numpy(params, dtype=torch.float32, device=None):
    """JAX-layout pytree (numpy leaves) -> the port's parameter dict."""
    out = layers_from_numpy(params["layers"], dtype, device)
    out["log_std"] = torch.as_tensor(np.asarray(params["log_std"]),
                                     dtype=dtype, device=device)
    return out


def params_to_numpy(params):
    """The port's parameter dict (or any dict shaped like it, e.g. a
    gradient) -> JAX-layout pytree of float64 numpy arrays."""
    return {"layers": layers_to_numpy(params),
            "log_std": _np(params["log_std"]).astype(np.float64)}


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


_TRANSFORMS = ("in_shift", "in_scale", "out_shift", "out_scale")


def policy_npz_arrays(params, transforms):
    """A JAX-layout policy pytree and its 4 transforms (numpy or anything
    ``np.asarray`` takes) -> the flat arrays of a policy ``.npz``:
    ``layers.<i>.w`` (in, out), ``layers.<i>.b``, ``log_std`` and the four
    transforms by name (the layout of the JAX pytree, key by key)."""
    arrays = {"log_std": np.asarray(params["log_std"])}
    for i, layer in enumerate(params["layers"]):
        arrays[f"layers.{i}.w"] = np.asarray(layer["w"])
        arrays[f"layers.{i}.b"] = np.asarray(layer["b"])
    arrays.update(zip(_TRANSFORMS, (np.asarray(t) for t in transforms)))
    return arrays


def save_policy_npz(path, policy):
    """``policy_params_to_numpy`` of a port ``Policy`` as a flat ``.npz``
    in ``policy_npz_arrays``' layout, float64."""
    np.savez(path, **policy_npz_arrays(*policy_params_to_numpy(policy)))


def load_policy_npz(path):
    """-> (JAX-layout parameter pytree, 4-tuple of transforms) of an
    ``.npz`` in ``policy_npz_arrays``' layout (other keys are ignored), for
    ``policy_params_from_numpy``."""
    z = np.load(path)
    n = sum(1 for k in z.files if k.startswith("layers.") and k.endswith(".w"))
    params = {"layers": [{"w": z[f"layers.{i}.w"], "b": z[f"layers.{i}.b"]}
                         for i in range(n)],
              "log_std": z["log_std"]}
    return params, tuple(z[k] for k in _TRANSFORMS)


def linear_baseline_from_numpy(baseline, coeffs):
    """Load least-squares coefficients (the JAX LinearBaseline or
    QuadraticBaseline state) into the port's host object of that kind."""
    baseline.state = torch.as_tensor(np.asarray(coeffs),
                                     dtype=baseline.dtype,
                                     device=baseline.device)
    return baseline


def linear_baseline_to_numpy(baseline):
    return _np(baseline.state).astype(np.float64)



def mlp_baseline_from_numpy(baseline, layers):
    """Load the JAX MLPBaseline's layers (``state[0]``) into a port
    ``MLPBaseline`` host object, with a fresh (zero) Adam state."""
    params = layers_from_numpy(layers, baseline.dtype, baseline.device)
    baseline.state = (params, adam_init(params))
    return baseline


def mlp_baseline_to_numpy(baseline):
    """-> the port MLPBaseline's layers in the JAX layout."""
    return layers_to_numpy(baseline.state[0])


# -- world models (``algos/model_accel/nn_dynamics.py``) ----------------------
#
# A JAX world model crosses as numpy: its ``dyn_params`` / ``rew_params``
# layer lists, its transform dicts, and each Adam state as ``{"count": int,
# "mu": layer list, "nu": layer list}`` (the ``ScaleByAdamState`` of the
# optax state, which the caller unpacks).

def _tree_from_numpy(tree, dtype, device):
    return {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in tree.items()}


def adam_state_from_numpy(state, dtype=torch.float32, device=None):
    return {"count": int(state["count"]),
            "mu": layers_from_numpy(state["mu"], dtype, device),
            "nu": layers_from_numpy(state["nu"], dtype, device)}


def adam_state_to_numpy(state):
    return {"count": int(state["count"]), "mu": layers_to_numpy(state["mu"]),
            "nu": layers_to_numpy(state["nu"])}


def world_model_from_numpy(model, dyn_params, dyn_tr, dyn_opt_state=None,
                           rew_params=None, rew_tr=None, rew_opt_state=None):
    """Load a JAX world model's arrays into a port ``WorldModel`` (a member
    of an ensemble writes into its slice of the stacks).  Without an Adam
    state the moments start at zero."""
    dt, dev = model.dtype, model.device
    params = layers_from_numpy(dyn_params, dt, dev)
    model.dyn_params = params
    model.dyn_tr = _tree_from_numpy(dyn_tr, dt, dev)
    model.dyn_opt_state = adam_init(params) if dyn_opt_state is None \
        else adam_state_from_numpy(dyn_opt_state, dt, dev)
    if rew_params is not None:
        model.rew_params = layers_from_numpy(rew_params, dt, dev)
        model.rew_tr = _tree_from_numpy(rew_tr, dt, dev)
        model.rew_opt_state = adam_init(model.rew_params) \
            if rew_opt_state is None \
            else adam_state_from_numpy(rew_opt_state, dt, dev)
    return model


def world_model_to_numpy(model):
    """-> the port ``WorldModel``'s arrays in the JAX layout (float64)."""
    tr = lambda t: {k: _np(v).astype(np.float64) for k, v in t.items()}
    out = dict(dyn_params=layers_to_numpy(model.dyn_params),
               dyn_tr=tr(model.dyn_tr),
               dyn_opt_state=adam_state_to_numpy(model.dyn_opt_state))
    if model.learn_reward:
        out.update(rew_params=layers_to_numpy(model.rew_params),
                   rew_tr=tr(model.rew_tr),
                   rew_opt_state=adam_state_to_numpy(model.rew_opt_state))
    return out
