"""Host-side baseline objects with the mjrl protocol (counterpart of
``mjrl_tpu/baselines.py``): ``fit(paths, return_errors) -> (e0, e1)``,
``predict(path) -> (T,)``.

Thin stateful wrappers over the functional cores in
``mjrl_tpu_torch.models.baselines``; agents reach through ``.cfg`` /
``.state`` to run the fit inside their training step.  The state lives on
the baseline's device; pickles hold CPU tensors.  ``MLPBaseline`` owns a
``torch.Generator`` (``needs_key``), seeded from ``seed``, that draws its
initial weights and every fit's permutations; an agent passes it to the
fit it runs.
"""

import numpy as np
import torch

from mjrl_tpu_torch.device import (make_generator, resolve_device,
                                   restore_generator, unpickled_device)
from mjrl_tpu_torch.models import baselines as fb
from mjrl_tpu_torch.ops.flat import tree_to


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

    def __init__(self, cfg, dtype=torch.float32, device=None, seed=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        if self.needs_key:
            self.seed = int(seed)
            self.generator = make_generator(self.seed, self.device)
            self.state = cfg.init(self.generator, dtype=dtype,
                                  device=self.device)
        else:
            self.state = cfg.init(dtype=dtype, device=self.device)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["state"] = tree_to(self.state, "cpu")
        state["device"] = str(self.device)
        if self.needs_key:
            state["generator"] = self.generator.get_state()
        return state

    def __setstate__(self, state):
        gen_state = state.pop("generator", None)
        self.__dict__.update(state)
        saved = self.device
        self.device = dev = unpickled_device(saved)
        self.state = tree_to(self.state, dev)
        if gen_state is not None:
            self.generator = restore_generator(gen_state, dev, self.seed,
                                               saved)

    def fit_state(self, state, obs, returns, mask, mesh=None):
        """The functional fit of ``state`` on batched tensors (this rank's
        rows under ``mesh``), with the baseline's generator where it needs
        one -> (new state, e_before, e_after); the baseline's own state is
        not changed."""
        if self.needs_key:
            return self.cfg.fit(state, obs, returns, mask,
                                generator=self.generator, mesh=mesh)
        return self.cfg.fit(state, obs, returns, mask, mesh=mesh)

    @torch.no_grad()
    def fit(self, paths, return_errors=False):
        obs, rets, mask = _paths_to_batch(paths, self.dtype, self.device)
        self.state, e0, e1 = self.fit_state(self.state, obs, rets, mask)
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


class QuadraticBaseline(_HostBaseline):
    def __init__(self, env_spec, inp_dim=None, inp="obs", reg_coeff=1e-3,
                 dtype=torch.float32, device=None):
        cfg = fb.QuadraticBaseline(inp_dim or env_spec.observation_dim,
                                   reg_coeff=reg_coeff)
        super().__init__(cfg, dtype, device)


class MLPBaseline(_HostBaseline):
    needs_key = True

    def __init__(self, env_spec, inp_dim=None, inp="obs", learn_rate=1e-3,
                 reg_coef=0.0, batch_size=64, epochs=1, use_gpu=False,
                 hidden_sizes=(128, 128), seed=0, dtype=torch.float32,
                 device=None):
        cfg = fb.MLPBaseline(inp_dim or env_spec.observation_dim,
                             hidden_sizes=tuple(hidden_sizes),
                             learn_rate=learn_rate, reg_coef=reg_coef,
                             batch_size=batch_size, epochs=epochs)
        super().__init__(cfg, dtype, device, seed=seed)
