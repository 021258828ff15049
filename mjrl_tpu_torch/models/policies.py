"""Gaussian policies (MLP and linear) — functional core + stateful wrapper
(counterpart of ``mjrl_tpu/models/policies.py``).

- MLP mean network + state-independent learnable ``log_std``.
- Last layer init scaled by 1e-2.
- ``min_log_std`` clamp applied on every parameter set.
- A frozen "old" parameter copy for likelihood ratios / KL.
- action = mean + exp(log_std) * N(0, I).

``GaussianMLP`` is an ``nn.Module`` that owns the parameters
(``layers.<i>.weight/bias``, ``log_std``); its methods are also usable as
pure functions of an explicit parameter dict, which is what the update
code differentiates.  The ``Policy`` wrapper gives the mjrl stateful
host-side API (get_action, get/set_param_values) for scripts, pickling and
evaluation.
"""

import copy

import numpy as np
import torch
from torch import nn

from mjrl_tpu_torch import distributions as dist
from mjrl_tpu_torch.device import make_generator, resolve_device
from mjrl_tpu_torch.models.fc_network import (
    Transforms, identity_transforms, init_linear_, make_transforms,
    mlp_forward)
from mjrl_tpu_torch.ops.flat import ravel


class GaussianMLP(nn.Module):
    """Policy network and its pure functions over parameter dicts."""

    def __init__(self, obs_dim, act_dim, hidden_sizes=(64, 64),
                 min_log_std=-3.0, init_log_std=0.0, nonlinearity="tanh",
                 dtype=torch.float32, device=None):
        super().__init__()
        self.obs_dim = int(obs_dim)
        self.act_dim = int(act_dim)
        self.hidden_sizes = tuple(hidden_sizes)
        self.min_log_std = float(min_log_std)
        self.init_log_std = float(init_log_std)
        self.nonlinearity = nonlinearity
        sizes = (self.obs_dim,) + self.hidden_sizes + (self.act_dim,)
        self.layers = nn.ModuleList(
            nn.Linear(sizes[i], sizes[i + 1], dtype=dtype, device=device)
            for i in range(len(sizes) - 1))
        self.log_std = nn.Parameter(torch.full(
            (self.act_dim,), self.init_log_std, dtype=dtype, device=device))

    # ---- init -------------------------------------------------------
    def init(self, generator):
        """(Re)initialize in place from ``generator`` -> (params,
        transforms).  params = {'layers.<i>.weight', 'layers.<i>.bias',
        'log_std'}."""
        for i, layer in enumerate(self.layers):
            init_linear_(layer, generator,
                         scale=1e-2 if i == len(self.layers) - 1 else 1.0)
        with torch.no_grad():
            self.log_std.fill_(self.init_log_std)
        p = self.log_std
        return self.param_dict(), identity_transforms(
            self.obs_dim, self.act_dim, p.dtype, p.device)

    def param_dict(self):
        """The module's parameters as a dict of detached tensors (sharing
        storage with the module)."""
        return {k: v.detach() for k, v in self.named_parameters()}

    def load_param_dict(self, params):
        with torch.no_grad():
            for k, v in self.named_parameters():
                v.copy_(params[k])

    # ---- core functions ----------------------------------------------
    def mean(self, params, transforms, obs):
        return mlp_forward(params, transforms, obs, self.nonlinearity)

    def dist_info(self, params, transforms, obs):
        """-> (mean, log_std) with log_std broadcast over the batch."""
        return self.mean(params, transforms, obs), params["log_std"]

    def forward(self, obs, transforms=None):
        if transforms is None:
            transforms = identity_transforms(
                self.obs_dim, self.act_dim, self.log_std.dtype,
                self.log_std.device)
        return self.dist_info(dict(self.named_parameters()), transforms, obs)

    def log_likelihood(self, params, transforms, obs, act):
        mu, log_std = self.dist_info(params, transforms, obs)
        return dist.log_likelihood(act, mu, log_std)

    def sample(self, params, transforms, obs, generator):
        mu, log_std = self.dist_info(params, transforms, obs)
        return dist.sample(generator, mu, log_std)

    def act(self, params, transforms, obs, generator):
        """-> (action, info); info = {mean, log_std, evaluation}."""
        mu, log_std = self.dist_info(params, transforms, obs)
        action = dist.sample(generator, mu, log_std)
        return action, {"mean": mu, "log_std": log_std, "evaluation": mu}

    def mean_kl(self, params_new, params_old, transforms, obs):
        mu_n, ls_n = self.dist_info(params_new, transforms, obs)
        mu_o, ls_o = self.dist_info(params_old, transforms, obs)
        return dist.mean_kl(mu_o, ls_o.expand_as(mu_o), mu_n,
                            ls_n.expand_as(mu_n))

    def clamp(self, params):
        """Clamp log_std at min_log_std — applied on every parameter set."""
        return {**params,
                "log_std": torch.clamp(params["log_std"],
                                       min=self.min_log_std)}


def GaussianLinear(obs_dim, act_dim, min_log_std=-3.0, init_log_std=0.0,
                   dtype=torch.float32, device=None):
    """Linear gaussian policy = MLP with no hidden layers."""
    return GaussianMLP(obs_dim, act_dim, hidden_sizes=(),
                       min_log_std=min_log_std, init_log_std=init_log_std,
                       dtype=dtype, device=device)


def MLP(env_spec, hidden_sizes=(64, 64), min_log_std=-3.0, init_log_std=0.0,
        seed=None, dtype=torch.float32, device=None):
    """mjrl-named convenience constructor: stateful Policy over a
    GaussianMLP from an EnvSpec."""
    device = resolve_device(device)
    cfg = GaussianMLP(env_spec.observation_dim, env_spec.action_dim,
                      tuple(hidden_sizes), min_log_std=min_log_std,
                      init_log_std=init_log_std, dtype=dtype, device=device)
    return Policy(cfg, seed=123 if seed is None else seed)


def LinearPolicy(env_spec, min_log_std=-3.0, init_log_std=0.0, seed=None,
                 dtype=torch.float32, device=None):
    """mjrl-named convenience constructor for the linear policy."""
    device = resolve_device(device)
    cfg = GaussianLinear(env_spec.observation_dim, env_spec.action_dim,
                         min_log_std=min_log_std, init_log_std=init_log_std,
                         dtype=dtype, device=device)
    return Policy(cfg, seed=123 if seed is None else seed)


class Policy:
    """Stateful host-side wrapper with the mjrl policy protocol.

    Holds (config module with the live params, old_params, transforms,
    generator).  Pickles with every tensor on the CPU; unpickling moves
    them back to the device they came from when it is available."""

    def __init__(self, config: GaussianMLP, seed: int = 123):
        self.config = config
        self.generator = make_generator(seed, self.device)
        _, self.transforms = config.init(self.generator)
        self.old_params = {k: v.clone() for k, v in self.params.items()}
        self.d = int(sum(v.numel() for v in self.params.values()))

    # -- state ------------------------------------------------------------
    @property
    def device(self):
        return self.config.log_std.device

    @property
    def dtype(self):
        return self.config.log_std.dtype

    @property
    def params(self):
        return self.config.param_dict()

    @params.setter
    def params(self, new_params):
        self.config.load_param_dict(new_params)

    def __getstate__(self):
        dev = self.device
        state = self.__dict__.copy()
        state["config"] = copy.deepcopy(self.config).to("cpu")
        state["old_params"] = {k: v.detach().cpu()
                               for k, v in self.old_params.items()}
        state["transforms"] = tuple(t.detach().cpu()
                                    for t in self.transforms)
        state["generator"] = self.generator.get_state()
        state["_device"] = str(dev)
        return state

    def __setstate__(self, state):
        dev = torch.device(state.pop("_device"))
        gen_state = state.pop("generator")
        self.__dict__.update(state)
        self.transforms = Transforms(*self.transforms)
        if dev.type == "cuda" and not torch.cuda.is_available():
            dev = torch.device("cpu")
        self.config.to(dev)
        self.old_params = {k: v.to(dev) for k, v in self.old_params.items()}
        self.transforms = Transforms(*(t.to(dev) for t in self.transforms))
        self.generator = torch.Generator(device=dev)
        try:
            self.generator.set_state(gen_state)
        except RuntimeError:      # state saved by another device kind
            self.generator.manual_seed(123)

    # -- mjrl protocol --------------------------------------------------
    @property
    def m(self):
        return self.config.act_dim

    @property
    def n(self):
        return self.config.obs_dim

    def get_param_values(self):
        flat, _ = ravel(self.params)
        return flat.detach().cpu().numpy().astype(np.float64)

    def set_param_values(self, new_params, set_new=True, set_old=True):
        _, unravel = ravel(self.params)
        vec = torch.as_tensor(np.asarray(new_params), dtype=self.dtype,
                              device=self.device)
        tree = self.config.clamp(unravel(vec))
        if set_new:
            self.params = tree
        if set_old:
            self.old_params = {k: v.clone() for k, v in tree.items()}

    def set_transformations(self, in_shift=None, in_scale=None,
                            out_shift=None, out_scale=None):
        self.transforms = make_transforms(
            self.config.obs_dim, self.config.act_dim,
            in_shift, in_scale, out_shift, out_scale,
            dtype=self.dtype, device=self.device)

    def _t(self, x):
        return torch.as_tensor(np.asarray(x), dtype=self.dtype,
                               device=self.device)

    @torch.no_grad()
    def get_action(self, observation):
        obs = self._t(observation).reshape(-1)
        action, info = self.config.act(self.params, self.transforms, obs,
                                       self.generator)
        return [action.cpu().numpy(),
                {k: v.cpu().numpy() for k, v in info.items()}]

    @torch.no_grad()
    def old_dist_info(self, observations, actions):
        mu, ls = self.config.dist_info(self.old_params, self.transforms,
                                       self._t(observations))
        return [dist.log_likelihood(self._t(actions), mu, ls), mu, ls]

    @torch.no_grad()
    def new_dist_info(self, observations, actions):
        mu, ls = self.config.dist_info(self.params, self.transforms,
                                       self._t(observations))
        return [dist.log_likelihood(self._t(actions), mu, ls), mu, ls]

    def likelihood_ratio(self, new_dist_info, old_dist_info):
        return dist.likelihood_ratio(new_dist_info[0], old_dist_info[0])

    def mean_kl(self, new_dist_info, old_dist_info):
        mu_n, mu_o = new_dist_info[1], old_dist_info[1]
        return dist.mean_kl(mu_o, old_dist_info[2].expand_as(mu_o), mu_n,
                            new_dist_info[2].expand_as(mu_n))

    def log_likelihood(self, observations, actions):
        return self.new_dist_info(observations, actions)[0].cpu().numpy()
