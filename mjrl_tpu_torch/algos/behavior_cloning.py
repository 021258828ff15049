"""Behavior cloning (counterpart of ``mjrl_tpu/algos/behavior_cloning.py``).

- loss types MLE (-mean log-likelihood) and MSE on the mean network output;
- with ``set_transforms``: data transforms computed from the expert data
  and installed into the policy (in/out shift-scale), and the policy's
  log_std set from the action scale, log(out_scale + 1e-12);
- Adam over epochs x (num_samples // batch_size) minibatches drawn with
  replacement; the Adam state persists across fits (``self.opt_state``).
  ``optimizer=`` takes a factory ``list of parameter tensors ->
  torch.optim.Optimizer`` instead (the JAX package takes any optax
  transformation): the optimizer is built once over parameter tensors the
  agent keeps, and its state persists across fits and pickles; the
  factory is pickled by reference, so a lambda cannot be pickled.

Data, transforms and log_std take the policy's dtype (the JAX package casts
them to float32 whatever the policy's dtype).
"""

import time as timer

import numpy as np
import torch

from mjrl_tpu_torch import distributions as dist
from mjrl_tpu_torch.device import (make_generator, resolve_device,
                                   restore_generator, unpickled_device)
from mjrl_tpu_torch.ops.adam import adam_init, adam_step_
from mjrl_tpu_torch.ops.flat import tree_to
from mjrl_tpu_torch.utils.logger import DataLog


class BC:
    def __init__(self, expert_paths,
                 policy,
                 epochs=5,
                 batch_size=64,
                 lr=1e-3,
                 optimizer=None,
                 loss_type="MSE",   # 'MLE' or 'MSE'
                 save_logs=True,
                 set_transforms=False,
                 device=None,
                 **kwargs):
        self.device = resolve_device(device)
        if policy.device.type != self.device.type:
            raise ValueError(
                f"policy lives on {policy.device}, BC on {self.device}")
        self.policy = policy
        self.expert_paths = expert_paths
        self.epochs = epochs
        self.mb_size = batch_size
        self.loss_type = loss_type
        self.save_logs = save_logs
        self.logger = DataLog()

        if set_transforms:
            in_shift, in_scale, out_shift, out_scale = \
                self.compute_transformations()
            self.set_transformations(in_shift, in_scale, out_shift,
                                     out_scale)
            self.set_variance_with_data(out_scale)

        self._lr = lr
        self._optimizer = optimizer
        if optimizer is None:
            self.opt_state = adam_init(self.policy.params)
        else:
            self._build_optimizer(self.policy.params)
        self.seed = kwargs.get("seed", 0)
        self.generator = make_generator(self.seed, self.device)

    def _build_optimizer(self, params, opt_state=None):
        """The factory's optimizer over tensors the agent keeps (each fit
        copies the policy's parameters into them)."""
        self._opt_params = {k: v.detach().clone().requires_grad_(True)
                            for k, v in params.items()}
        self._torch_opt = self._optimizer(list(self._opt_params.values()))
        if opt_state is not None:
            self._torch_opt.load_state_dict(opt_state)

    # -- pickling: the generator travels as its state, tensors on the CPU --
    def __getstate__(self):
        state = self.__dict__.copy()
        state["generator"] = self.generator.get_state()
        state["device"] = str(self.device)
        if self._optimizer is None:
            state["opt_state"] = tree_to(self.opt_state, "cpu")
        else:
            state["_opt_params"] = tree_to(self._opt_params, "cpu")
            state["_torch_opt"] = tree_to(self._torch_opt.state_dict(),
                                          "cpu")
        return state

    def __setstate__(self, state):
        gen_state = state.pop("generator")
        self.__dict__.update(state)
        saved = self.device
        self.device = dev = unpickled_device(saved)
        if self._optimizer is None:
            self.opt_state = tree_to(self.opt_state, dev)
        else:
            self._build_optimizer(tree_to(self._opt_params, dev),
                                  self._torch_opt)
        self.generator = restore_generator(gen_state, dev, self.seed, saved)

    # -- transforms ----------------------------------------------------------
    def compute_transformations(self):
        if not self.expert_paths:
            return None, None, None, None
        obs = np.concatenate([p["observations"] for p in self.expert_paths])
        act = np.concatenate([p["actions"] for p in self.expert_paths])
        return (obs.mean(axis=0), obs.std(axis=0),
                act.mean(axis=0), act.std(axis=0))

    def set_transformations(self, in_shift=None, in_scale=None,
                            out_shift=None, out_scale=None):
        self.policy.set_transformations(in_shift, in_scale, out_shift,
                                        out_scale)

    def set_variance_with_data(self, out_scale):
        if out_scale is None:
            return
        log_std = torch.log(torch.as_tensor(
            np.asarray(out_scale), dtype=self.policy.dtype,
            device=self.device) + 1e-12)
        params = self.policy.config.clamp({**self.policy.params,
                                           "log_std": log_std})
        self.policy.params = params
        self.policy.old_params = {k: v.clone() for k, v in params.items()}

    # -- losses ----------------------------------------------------------------
    def _loss(self, params, transforms, obs, act):
        pol = self.policy.config
        if self.loss_type == "MLE":
            mu, ls = pol.dist_info(params, transforms, obs)
            return -torch.mean(dist.log_likelihood(act, mu, ls))
        return torch.mean((pol.mean(params, transforms, obs) - act) ** 2)

    def _data(self, data):
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=self.policy.dtype,
                                      device=self.device)
        return t(data["observations"]), t(data["expert_actions"])

    @torch.no_grad()
    def loss(self, data, idx=None):
        obs, act = self._data(data)
        if idx is not None:
            idx = torch.as_tensor(np.asarray(idx), device=self.device)
            obs, act = obs[idx], act[idx]
        return self._loss(self.policy.params, self.policy.transforms, obs,
                          act)

    # -- fit ---------------------------------------------------------------------
    def fit(self, data, suppress_fit_tqdm=False, idxs=None, **kwargs):
        """Adam on minibatches of ``data`` (observations, expert_actions);
        ``idxs`` (total, batch_size), for tests, replaces the drawn
        indices."""
        assert all(k in data for k in ("observations", "expert_actions"))
        ts = timer.time()
        obs, act = self._data(data)
        n = obs.shape[0]
        if self.save_logs:
            self.logger.log_kv("loss_before", float(self.loss(data)))

        if idxs is None:
            total = self.epochs * max(int(n // self.mb_size), 1)
            idxs = torch.randint(0, n, (total, self.mb_size),
                                 generator=self.generator,
                                 device=self.device)
        idxs = torch.as_tensor(idxs, device=self.device)
        pol = self.policy.config
        tr = self.policy.transforms
        if self._optimizer is None:
            p = {k: v.detach().clone().requires_grad_(True)
                 for k, v in self.policy.params.items()}
        else:
            p = self._opt_params
            with torch.no_grad():
                for k, v in self.policy.params.items():
                    p[k].copy_(v)
        for idx in idxs:
            with torch.enable_grad():
                loss = self._loss(p, tr, obs[idx], act[idx])
                grads = torch.autograd.grad(loss, list(p.values()),
                                            allow_unused=True)
            grads = {k: torch.zeros_like(v) if g is None else g
                     for (k, v), g in zip(p.items(), grads)}
            if self._optimizer is None:
                self.opt_state = adam_step_(p, grads, self.opt_state,
                                            self._lr)
            else:
                for k, v in p.items():
                    v.grad = grads[k]
                self._torch_opt.step()
            with torch.no_grad():
                p["log_std"].clamp_(min=pol.min_log_std)
        new_params = {k: v.detach().clone() for k, v in p.items()}
        self.policy.params = new_params
        self.policy.old_params = {k: v.clone() for k, v in new_params.items()}

        if self.save_logs:
            self.logger.log_kv("epoch", self.epochs)
            self.logger.log_kv("loss_after", float(self.loss(data)))
            self.logger.log_kv("time", timer.time() - ts)

    def train(self, **kwargs):
        obs = np.concatenate([p["observations"] for p in self.expert_paths])
        act = np.concatenate([p["actions"] for p in self.expert_paths])
        self.fit(dict(observations=obs, expert_actions=act), **kwargs)
