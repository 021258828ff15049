"""Learned dynamics and reward models (counterpart of
``mjrl_tpu/algos/model_accel/nn_dynamics.py``).

- DynamicsNet: MLP on normalized (s, a); output de-normalized with
  out * (out_scale + 1e-8) + out_shift, masked where out_scale < 1e-8
  (dimensions with negligible variation are frozen), residual + s.
- fit_dynamics: shift = mean, scale = mean |x - shift| of the data; trains
  in the normalized space with the output transforms off; minibatch Adam
  (AdamW when ``fit_wd`` > 0) over a permutation per epoch, the tail that
  does not fill a minibatch dropped, and a ``max_steps`` cap.
- RewardNet: r = f(s, a, s'_pred) on normalized inputs.

Layers are parameter dicts in ``nn.Linear``'s layout (``layers.<i>.weight``
(out, in)).  ``WorldModelEnsemble`` keeps its members' weights, transforms
and Adam moments stacked on a leading model axis (weights (M, out, in)):
one Adam step trains every member with one set of launches (``baddbmm``),
and each member (a ``WorldModel``) reads and writes its slice of the stack.
Every random draw (initial weights, each epoch's permutation) comes from
the model's own ``torch.Generator``; tests pass ``perms=`` instead.
Under a ``mesh`` (``parallel/mesh.py``) the ensemble's model axis is split
over the ranks: each fits its own members and the stacks are gathered.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mjrl_tpu_torch.device import (make_generator, resolve_device,
                                   restore_generator, unpickled_device)
from mjrl_tpu_torch.models.fc_network import init_mlp_params, num_layers
from mjrl_tpu_torch.ops.adam import adam_copy, adam_init, adam_step_
from mjrl_tpu_torch.ops.flat import tree_to
from mjrl_tpu_torch.parallel.mesh import gather_rows


def as_tensor(x, dtype, device):
    """``x`` (a tensor on any device, or array-like, copied) as a tensor of
    ``dtype`` on ``device``."""
    if torch.is_tensor(x):
        return x.to(dtype=dtype, device=device)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _act_fn(name):
    return torch.relu if name == "relu" else torch.tanh


def _linear(x, w, b):
    """x W^T + b for one model (w (out, in)) or a stack of models
    (w (M, out, in), x (M, N, in)): one launch either way."""
    if w.dim() == 2:
        return F.linear(x, w, b)
    return torch.baddbmm(b.unsqueeze(1), x, w.transpose(1, 2))


def mlp(layers, x, act_fn):
    n = num_layers(layers)
    for i in range(n - 1):
        x = act_fn(_linear(x, layers[f"layers.{i}.weight"],
                           layers[f"layers.{i}.bias"]))
    return _linear(x, layers[f"layers.{n - 1}.weight"],
                   layers[f"layers.{n - 1}.bias"])


def _bcast(tr):
    """Stacked transforms (M, dim) broadcast against (M, N, dim) data."""
    return {k: v.unsqueeze(-2) if v.dim() == 2 else v for k, v in tr.items()}


@dataclass(frozen=True)
class DynamicsNetCfg:
    state_dim: int
    act_dim: int
    hidden_size: Tuple[int, ...] = (64, 64)
    activation: str = "relu"
    residual: bool = True
    use_mask: bool = True

    @property
    def out_dim(self):
        return self.state_dim

    def init(self, generator, dtype=torch.float32, device=None):
        layers = init_mlp_params(generator, self.state_dim + self.act_dim,
                                 self.out_dim, self.hidden_size, dtype,
                                 device)
        transforms = identity_model_transforms(
            self.state_dim, self.act_dim, self.out_dim, dtype, device)
        return layers, transforms

    def normalize(self, tr, s, a):
        """The network's input: normalized s and a side by side."""
        tr = _bcast(tr)
        s_in = (s - tr["s_shift"]) / (tr["s_scale"] + 1e-8)
        a_in = (a - tr["a_shift"]) / (tr["a_scale"] + 1e-8)
        return torch.cat([s_in, a_in], dim=-1)

    def forward(self, layers, tr, s, a, apply_out_transforms=True):
        """One model ((N, d) data), or a stack of M models with stacked
        transforms ((M, N, d) data)."""
        out = mlp(layers, self.normalize(tr, s, a), _act_fn(self.activation))
        if apply_out_transforms:
            t = _bcast(tr)
            out = out * (t["out_scale"] + 1e-8) + t["out_shift"]
            if self.use_mask:
                out = out * (t["out_scale"] >= 1e-8)
            if self.residual:
                out = out + s
        return out


@dataclass(frozen=True)
class RewardNetCfg:
    state_dim: int
    act_dim: int
    hidden_size: Tuple[int, ...] = (100, 100)
    activation: str = "relu"

    def init(self, generator, dtype=torch.float32, device=None):
        layers = init_mlp_params(generator, 2 * self.state_dim + self.act_dim,
                                 1, self.hidden_size, dtype, device)
        tr = identity_model_transforms(self.state_dim, self.act_dim, 1,
                                       dtype, device)
        tr["out_shift"] = torch.zeros((), dtype=dtype, device=device)
        tr["out_scale"] = torch.ones((), dtype=dtype, device=device)
        return layers, tr

    def normalize(self, tr, s, a, sp):
        s_in = (s - tr["s_shift"]) / (tr["s_scale"] + 1e-8)
        a_in = (a - tr["a_shift"]) / (tr["a_scale"] + 1e-8)
        sp_in = (sp - tr["s_shift"]) / (tr["s_scale"] + 1e-8)
        return torch.cat([s_in, a_in, sp_in], dim=-1)

    def forward(self, layers, tr, s, a, sp):
        out = mlp(layers, self.normalize(tr, s, a, sp),
                  _act_fn(self.activation))
        return out * (tr["out_scale"] + 1e-8) + tr["out_shift"]


def identity_model_transforms(state_dim, act_dim, out_dim,
                              dtype=torch.float32, device=None):
    kw = dict(dtype=dtype, device=device)
    return {
        "s_shift": torch.zeros(state_dim, **kw),
        "s_scale": torch.ones(state_dim, **kw),
        "a_shift": torch.zeros(act_dim, **kw),
        "a_scale": torch.ones(act_dim, **kw),
        "out_shift": torch.zeros(out_dim, **kw),
        "out_scale": torch.ones(out_dim, **kw),
    }


def data_transforms(s, a, target):
    """shift = mean; scale = mean |x - shift| (not the std)."""
    s_shift, a_shift = torch.mean(s, dim=0), torch.mean(a, dim=0)
    s_scale = torch.mean(torch.abs(s - s_shift), dim=0)
    a_scale = torch.mean(torch.abs(a - a_shift), dim=0)
    out_shift = torch.mean(target, dim=0)
    out_scale = torch.mean(torch.abs(target - out_shift), dim=0)
    return s_shift, s_scale, a_shift, a_scale, out_shift, out_scale


def _transforms_dict(stats):
    return dict(zip(("s_shift", "s_scale", "a_shift", "a_scale",
                     "out_shift", "out_scale"), stats))


def fit_scan(loss_fn, params, opt_state, n, mb_size, epochs, max_steps,
             perm_fn, lr, weight_decay=0.0, lead=()):
    """Epoch / minibatch Adam loop: each epoch takes ``perm_fn(e)`` (a
    permutation of the n samples, (..., n)) without replacement and drops
    the tail that does not fill a minibatch; after ``max_steps`` steps in
    all, the remaining steps are skipped and count a loss of 0.  An epoch's
    loss is the sum of its step losses over the number of steps per epoch.

    ``loss_fn(params, idx)`` -> loss of shape ``lead`` (() for one model,
    (M,) for a stack, whose sum is differentiated: the members' losses are
    independent).  -> (params, Adam state, epoch losses (*lead, epochs));
    the inputs are left unchanged."""
    num_steps = max(int(n // mb_size), 1)
    total_allowed = int(min(epochs * num_steps, max_steps))
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    leaves = list(p.values())
    state = adam_copy(opt_state)
    ref = leaves[0]
    zero = torch.zeros(lead, dtype=ref.dtype, device=ref.device)
    epoch_losses, steps = [], 0
    for e in range(epochs):
        live = min(num_steps, max(total_allowed - steps, 0))
        if live == 0:
            epoch_losses.append(zero)
            continue
        perm = perm_fn(e)[..., :num_steps * mb_size]
        batches = perm.reshape(perm.shape[:-1] + (num_steps, mb_size))
        step_losses = []
        for j in range(live):
            with torch.enable_grad():
                loss = loss_fn(p, batches[..., j, :])
                grads = torch.autograd.grad(loss.sum(), leaves)
            state = adam_step_(p, dict(zip(p, grads)), state, lr,
                               weight_decay)
            step_losses.append(loss.detach())
        steps += live
        epoch_losses.append(torch.stack(step_losses).sum(0) / num_steps)
    return ({k: v.detach() for k, v in p.items()}, state,
            torch.stack(epoch_losses, dim=-1))


def _as_perms(perms, device):
    return as_tensor(perms, torch.int64, device)


class WorldModel:
    """The mjrl WorldModel API: forward / predict / reward,
    fit_dynamics / fit_reward, compute_path_rewards, compute_loss.

    A member of a ``WorldModelEnsemble`` holds no dynamics tensors of its
    own: ``dyn_params``, ``dyn_tr`` and ``dyn_opt_state`` read its slice of
    the ensemble's stacks (views) and write into it."""

    def __init__(self, state_dim, act_dim,
                 learn_reward=False,
                 hidden_size=(64, 64),
                 seed=123,
                 fit_lr=1e-3,
                 fit_wd=0.0,
                 device=None,
                 activation="relu",
                 residual=True,
                 dtype=torch.float32,
                 *args, **kwargs):
        self.state_dim, self.act_dim = state_dim, act_dim
        self.learn_reward = learn_reward
        self._fit_lr, self._fit_wd = fit_lr, fit_wd
        self.seed = seed
        self.device = resolve_device(device)
        self.dtype = dtype
        self.dyn_cfg = DynamicsNetCfg(state_dim, act_dim,
                                      tuple(hidden_size),
                                      activation=activation,
                                      residual=residual)
        self.generator = make_generator(seed, self.device)
        self._ens, self._index = None, None
        params, tr = self.dyn_cfg.init(self.generator, dtype, self.device)
        self._dyn = {"params": params, "tr": tr, "opt": adam_init(params)}
        if learn_reward:
            self.rew_cfg = RewardNetCfg(state_dim, act_dim,
                                        activation=activation)
            self.rew_params, self.rew_tr = self.rew_cfg.init(
                self.generator, dtype, self.device)
            self.rew_opt_state = adam_init(self.rew_params)
        else:
            self.rew_cfg = None

    # -- the dynamics tensors: own, or a slice of the ensemble's stacks ---
    def _get(self, name):
        if self._ens is None:
            return self._dyn[name]
        return self._ens._member_view(name, self._index)

    def _set(self, name, value):
        if self._ens is None:
            self._dyn[name] = value
        else:
            self._ens._set_member(name, self._index, value)

    dyn_params = property(lambda self: self._get("params"),
                          lambda self, v: self._set("params", v))
    dyn_tr = property(lambda self: self._get("tr"),
                      lambda self, v: self._set("tr", v))
    dyn_opt_state = property(lambda self: self._get("opt"),
                             lambda self, v: self._set("opt", v))

    # -- pickling: tensors on the CPU, the generator as its state ---------
    _TREES = ("_dyn", "rew_params", "rew_tr", "rew_opt_state")

    def __getstate__(self):
        state = self.__dict__.copy()
        for k in self._TREES:
            if k in state:
                state[k] = tree_to(state[k], "cpu")
        state["generator"] = self.generator.get_state()
        state["device"] = str(self.device)
        return state

    def __setstate__(self, state):
        gen_state = state.pop("generator")
        self.__dict__.update(state)
        saved = self.device
        self.device = dev = unpickled_device(saved)
        for k in self._TREES:
            if k in state:
                setattr(self, k, tree_to(state[k], dev))
        self.generator = restore_generator(gen_state, dev, self.seed, saved)

    def is_cuda(self):
        return self.device.type == "cuda"

    def _t(self, x):
        return as_tensor(x, self.dtype, self.device)

    # -- forward / predict ----------------------------------------------
    @torch.no_grad()
    def forward(self, s, a):
        return self.dyn_cfg.forward(self.dyn_params, self.dyn_tr,
                                    self._t(s), self._t(a))

    def predict(self, s, a):
        return self.forward(s, a).cpu().numpy()

    @torch.no_grad()
    def reward(self, s, a):
        if not self.learn_reward:
            print("Reward model is not learned. Use the reward function "
                  "from env.")
            return None
        s, a = self._t(s), self._t(a)
        sp = self.dyn_cfg.forward(self.dyn_params, self.dyn_tr, s, a)
        return self.rew_cfg.forward(self.rew_params, self.rew_tr, s, a, sp)

    def compute_loss(self, s, a, s_next):
        pred = self.forward(s, a)
        return float(torch.mean((pred - self._t(s_next)) ** 2))

    # -- fitting ---------------------------------------------------------
    def fit_dynamics(self, s, a, sp, fit_mb_size, fit_epochs, max_steps=1e4,
                     set_transformations=True, perms=None, *args, **kwargs):
        """-> the epoch losses.  ``perms`` (epochs, n), for tests, replaces
        the permutations drawn from the model's generator."""
        s, a, sp = self._t(s), self._t(a), self._t(sp)
        target = sp - s if self.dyn_cfg.residual else sp
        if set_transformations:
            self.dyn_tr = _transforms_dict(data_transforms(s, a, target))
        tr = self.dyn_tr
        y = (target - tr["out_shift"]) / (tr["out_scale"] + 1e-8)
        x = self.dyn_cfg.normalize(tr, s, a)
        act = _act_fn(self.dyn_cfg.activation)
        n = s.shape[0]

        def loss_fn(p, idx):
            return torch.mean((mlp(p, x[idx], act) - y[idx]) ** 2)

        params, state, losses = fit_scan(
            loss_fn, self.dyn_params, self.dyn_opt_state, n,
            int(fit_mb_size), int(fit_epochs), max_steps,
            self._perm_fn(n, perms), self._fit_lr, self._fit_wd)
        self.dyn_params, self.dyn_opt_state = params, state
        return [float(v) for v in losses.cpu()]

    def _perm_fn(self, n, perms):
        if perms is not None:
            perms = _as_perms(perms, self.device)
            return lambda e: perms[e]
        return lambda e: torch.randperm(n, generator=self.generator,
                                        device=self.device)

    def fit_reward(self, s, a, r, fit_mb_size, fit_epochs, max_steps=1e4,
                   set_transformations=True, perms=None, *args, **kwargs):
        if not self.learn_reward:
            print("Reward model was not initialized to be learnable.")
            return None
        r = r if torch.is_tensor(r) else np.asarray(r)
        assert r.ndim == 2 and r.shape[1] == 1, \
            "r should be a 2D tensor of shape (N, 1)"
        s, a, r = self._t(s), self._t(a), self._t(r)
        if set_transformations:
            s_sh, s_sc, a_sh, a_sc, r_sh, r_sc = data_transforms(s, a, r)
            self.rew_tr = dict(s_shift=s_sh, s_scale=s_sc, a_shift=a_sh,
                               a_scale=a_sc, out_shift=r_sh[0],
                               out_scale=r_sc[0])
        tr, cfg = self.rew_tr, self.rew_cfg
        with torch.no_grad():
            sp = self.dyn_cfg.forward(self.dyn_params, self.dyn_tr, s, a)
        n = s.shape[0]

        def loss_fn(p, idx):
            pred = cfg.forward(p, tr, s[idx], a[idx], sp[idx])
            return torch.mean((pred - r[idx]) ** 2)

        self.rew_params, self.rew_opt_state, losses = fit_scan(
            loss_fn, self.rew_params, self.rew_opt_state, n,
            int(fit_mb_size), int(fit_epochs), max_steps,
            self._perm_fn(n, perms), self._fit_lr, self._fit_wd)
        return [float(v) for v in losses.cpu()]

    def compute_path_rewards(self, paths):
        """paths['observations'] (N, H, d), ['actions'] (N, H, m) ->
        populates paths['rewards'] (N, H), a tensor on the model's
        device."""
        if not self.learn_reward:
            print("Reward model is not learned. Use the reward function "
                  "from env.")
            return None
        s, a = self._t(paths["observations"]), self._t(paths["actions"])
        n, h, d = s.shape
        r = self.reward(s.reshape(-1, d), a.reshape(-1, a.shape[-1]))
        paths["rewards"] = r.reshape(n, h)
        return paths


class WorldModelEnsemble:
    """Members' dynamics stacked on a leading model axis: one fit trains
    every member with one Adam step per minibatch, each member on its own
    permutations (from its own generator); ``predict_all`` queries every
    member in one batched forward.

    ``mesh``: the model axis is split over the mesh's ranks (``num_models``
    must divide by them).  Every rank holds every member and gets the same
    data; a fit trains this rank's members only (no gradient crosses
    ranks) and then gathers the stacks, so every rank ends with the whole
    ensemble; ``predict_all`` computes this rank's members and gathers.
    Every member's generator draws on every rank, in lockstep with one
    rank."""

    def __init__(self, num_models, state_dim, act_dim, seed=123, mesh=None,
                 **kwargs):
        if mesh is not None:
            mesh.rows(num_models)       # raises unless they split evenly
        self.mesh = mesh
        members = [WorldModel(state_dim, act_dim, seed=seed + i, **kwargs)
                   for i in range(num_models)]
        self.num_models = num_models
        self.device, self.dtype = members[0].device, members[0].dtype
        stack = lambda name: {k: torch.stack([m._dyn[name][k]
                                              for m in members])
                              for k in members[0]._dyn[name]}
        params = stack("params")
        opt = adam_init(params)
        self._dyn = {"params": params, "tr": stack("tr"),
                     "opt": {"mu": opt["mu"], "nu": opt["nu"]}}
        self._counts = [0] * num_models
        for i, m in enumerate(members):
            m._ens, m._index, m._dyn = self, i, None
        self.members = members

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_dyn"] = tree_to(self._dyn, "cpu")
        state["device"] = str(self.device)
        state["mesh"] = None            # a process group does not pickle
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.device = unpickled_device(self.device)
        self._dyn = tree_to(self._dyn, self.device)

    # -- the members' slices ----------------------------------------------
    def _member_view(self, name, i):
        d = self._dyn[name]
        if name == "opt":
            return {"count": self._counts[i],
                    "mu": {k: v[i] for k, v in d["mu"].items()},
                    "nu": {k: v[i] for k, v in d["nu"].items()}}
        return {k: v[i] for k, v in d.items()}

    @torch.no_grad()
    def _set_member(self, name, i, value):
        d = self._dyn[name]
        if name == "opt":
            self._counts[i] = int(value["count"])
            for part in ("mu", "nu"):
                for k, v in value[part].items():
                    d[part][k][i].copy_(v)
        else:
            for k, v in value.items():
                d[k][i].copy_(v)

    def _own(self):
        """This rank's members, a slice of the model axis (all of them
        without a mesh)."""
        return slice(0, self.num_models) if self.mesh is None \
            else self.mesh.rows(self.num_models)

    def __len__(self):
        return self.num_models

    def __iter__(self):
        return iter(self.members)

    def __getitem__(self, i):
        return self.members[i]

    def fit_dynamics(self, s, a, sp, fit_mb_size, fit_epochs, max_steps=1e4,
                     perms=None, **kwargs):
        """Fit every member on the same data and transforms, each on its
        own permutations -> epoch losses (num_models, epochs).  ``perms``
        (num_models, epochs, n), for tests, replaces the drawn ones."""
        first = self.members[0]
        cfg, t = first.dyn_cfg, first._t
        s, a, sp = t(s), t(a), t(sp)
        target = sp - s if cfg.residual else sp
        tr = _transforms_dict(data_transforms(s, a, target))
        y = (target - tr["out_shift"]) / (tr["out_scale"] + 1e-8)
        x = cfg.normalize(tr, s, a)
        act = _act_fn(cfg.activation)
        n, M = s.shape[0], self.num_models

        def loss_fn(p, idx):                # idx (M, mb)
            return torch.mean((mlp(p, x[idx], act) - y[idx]) ** 2,
                              dim=(1, 2))

        own = self._own()
        if perms is not None:
            perms = _as_perms(perms, self.device)[own]
            perm_fn = lambda e: perms[:, e]
        else:
            # every member draws, as on one rank; this rank keeps its own
            perm_fn = lambda e: torch.stack([
                torch.randperm(n, generator=m.generator, device=self.device)
                for m in self.members])[own]
        # one count for all members, the usual case; where a member was
        # fitted on its own the counts differ, and the stacked step then
        # corrects each member's moments by its own count
        counts = self._counts[own]
        count = counts[0] if len(set(counts)) == 1 \
            else torch.tensor(counts, device=self.device)
        opt = {"mu": _rows(self._dyn["opt"]["mu"], own),
               "nu": _rows(self._dyn["opt"]["nu"], own), "count": count}
        params, state, losses = fit_scan(
            loss_fn, _rows(self._dyn["params"], own), opt, n,
            int(fit_mb_size), int(fit_epochs), max_steps, perm_fn,
            first._fit_lr, first._fit_wd, lead=(own.stop - own.start,))
        gather = lambda tree: {k: gather_rows(v, self.mesh)
                               for k, v in tree.items()}
        self._dyn = {
            "params": gather(params),
            "tr": {k: v.unsqueeze(0).repeat((M,) + (1,) * v.dim())
                   for k, v in tr.items()},
            "opt": {"mu": gather(state["mu"]), "nu": gather(state["nu"])}}
        count = state["count"] if torch.is_tensor(state["count"]) \
            else torch.full((len(counts),), state["count"])
        self._counts = gather_rows(count.to(self.device),
                                   self.mesh).tolist()
        return gather_rows(losses, self.mesh).cpu().numpy()

    @torch.no_grad()
    def predict_all(self, s, a):
        """(num_models, N, d) stacked next-state predictions."""
        t = self.members[0]._t
        s, a = t(s), t(a)
        own = self._own()
        M = own.stop - own.start
        return gather_rows(self.members[0].dyn_cfg.forward(
            _rows(self._dyn["params"], own), _rows(self._dyn["tr"], own),
            s.expand(M, *s.shape), a.expand(M, *a.shape)), self.mesh)


def _rows(tree, rows):
    return {k: v[rows] for k, v in tree.items()}


def stacked_dynamics(models):
    """-> (cfg, stacked layers, stacked transforms) of a list of world
    models: the ensemble's own stacks when the list is an ensemble's
    members in order, else the members' tensors stacked (M = 1 for one
    model)."""
    models = list(models)
    ens = models[0]._ens
    if ens is not None and models == ens.members:
        return models[0].dyn_cfg, ens._dyn["params"], ens._dyn["tr"]
    stack = lambda trees: {k: torch.stack([t[k] for t in trees])
                           for k in trees[0]}
    return (models[0].dyn_cfg, stack([m.dyn_params for m in models]),
            stack([m.dyn_tr for m in models]))
