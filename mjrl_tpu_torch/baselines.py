"""Host-side baseline objects with the mjrl protocol (counterpart of
``mjrl_tpu/baselines.py``): ``fit(paths, return_errors) -> (e0, e1)``,
``predict(path) -> (T,)``.

Thin stateful wrappers over the functional cores in
``mjrl_tpu_torch.models.baselines``; agents reach through ``.cfg`` /
``.state`` to run the fit inside their training step.  The state lives on
the baseline's device; pickles hold CPU tensors.
"""

import numpy as np
import torch

from mjrl_tpu_torch.device import resolve_device
from mjrl_tpu_torch.models import baselines as fb


def _paths_to_batch(paths, dtype=torch.float32, device=None):
    """list of path dicts (or an already-batched dict) -> (obs (N,T,n),
    returns (N,T), mask (N,T)) padded to the max length."""
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    if isinstance(paths, dict):
        obs, rets = t(paths["observations"]), t(paths["returns"])
        mask = t(paths["mask"]) if "mask" in paths \
            else torch.ones_like(rets)
        return obs, rets, mask
    T = max(len(p["rewards"]) for p in paths)
    n = paths[0]["observations"].shape[-1]
    obs = np.zeros((len(paths), T, n), np.float64)
    rets = np.zeros((len(paths), T), np.float64)
    mask = np.zeros((len(paths), T), np.float64)
    for i, p in enumerate(paths):
        k = len(p["rewards"])
        obs[i, :k] = p["observations"]
        rets[i, :k] = p["returns"]
        mask[i, :k] = 1.0
    return t(obs), t(rets), t(mask)


class _HostBaseline:
    needs_key = False

    def __init__(self, cfg, dtype=torch.float32, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.state = cfg.init(dtype=dtype, device=self.device)

    def __getstate__(self):
        state = self.__dict__.copy()
        if torch.is_tensor(self.state):
            state["state"] = self.state.detach().cpu()
        state["device"] = str(self.device)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            dev = torch.device("cpu")
        self.device = dev
        if torch.is_tensor(self.state):
            self.state = self.state.to(dev)

    @torch.no_grad()
    def fit(self, paths, return_errors=False):
        obs, rets, mask = _paths_to_batch(paths, self.dtype, self.device)
        self.state, e0, e1 = self.cfg.fit(self.state, obs, rets, mask)
        if return_errors:
            return float(e0), float(e1)

    @torch.no_grad()
    def predict(self, path):
        obs = torch.as_tensor(np.asarray(path["observations"]),
                              dtype=self.dtype, device=self.device)[None]
        return self.cfg.predict(self.state, obs)[0].cpu().numpy()


class ZeroBaseline(_HostBaseline):
    def __init__(self, env_spec, dtype=torch.float32, device=None, **kwargs):
        super().__init__(fb.ZeroBaseline(env_spec.observation_dim),
                         dtype, device)


class LinearBaseline(_HostBaseline):
    def __init__(self, env_spec, inp_dim=None, inp="obs", reg_coeff=1e-5,
                 dtype=torch.float32, device=None):
        cfg = fb.LinearBaseline(inp_dim or env_spec.observation_dim,
                                reg_coeff=reg_coeff)
        super().__init__(cfg, dtype, device)


QuadraticBaseline = fb.QuadraticBaseline
MLPBaseline = fb.MLPBaseline
