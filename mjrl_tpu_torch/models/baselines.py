"""Value-function baselines: zero, linear and quadratic least squares, and
an MLP (counterpart of ``mjrl_tpu/models/baselines.py``).

- Feature maps: obs clipped to [-10, 10] and divided by 10; a 1.0 bias
  column (linear / quadratic only); time features (t/1000)^{1..4} of the
  grid column.  Quadratic adds all pairwise products o_i * o_j, i <= j, in
  ``torch.triu_indices`` order (row major, as ``jnp.triu_indices``).
- Linear / quadratic fit: regularized least squares on Monte-Carlo returns
  with the reg coefficient multiplied by 10 on NaN, up to 10 attempts.
- MLP: ReLU MLP on [obs features, time features] -> scalar, fitted by
  minibatch Adam (AdamW with ``reg_coef`` > 0) over ``epochs`` permutations
  of the samples; the optimizer state persists across fits.
- Errors reported as relative squared error sum(e^2)/sum(R^2) (the MLP adds
  1e-8 to the denominator).

Everything operates on batched fixed-shape paths — observations
(N, T, obs_dim), returns (N, T), optional validity mask (N, T) — on the
tensors' own device.  ``fit(..., mesh=)`` fits on the paths of every rank
(each holding its N / R rows): the normal equations and the errors are
all-reduced, and the MLP's minibatches are drawn over all ranks' samples
with the gradient all-reduced per Adam step; every rank ends with the same
state.
"""

from dataclasses import dataclass
from typing import Tuple

import torch

from mjrl_tpu_torch.models.fc_network import (identity_transforms,
                                              init_mlp_params, mlp_forward)
from mjrl_tpu_torch.ops.adam import adam_copy, adam_init, adam_step_
from mjrl_tpu_torch.parallel.mesh import (all_reduce_sum, all_reduce_tree,
                                          local_index, masked_mean_grad,
                                          row_offset)


def time_features(T, dtype=torch.float32, device=None):
    """(T, 4) matrix of (t/1000)^{1,2,3,4}."""
    al = torch.arange(T, dtype=dtype, device=device) / 1000.0
    return torch.stack([al, al ** 2, al ** 3, al ** 4], dim=-1)


def _clip_obs(obs):
    return torch.clamp(obs, -10.0, 10.0) / 10.0


def _masked_rel_error(pred, returns, mask, eps=0.0, mesh=None):
    err = (returns - pred) * mask
    num, den = all_reduce_sum(torch.stack([torch.sum(err ** 2),
                                           torch.sum((returns * mask) ** 2)]),
                              mesh)
    return num / (den + eps)


def _lstsq_with_retry(featmat, returns, reg_coeff, mesh=None):
    """Solve (F^T F + reg I) c = F^T R; on NaN multiply reg by 10, up to 10
    attempts — as a fixed loop with a ``found`` flag, no host sync.  Under
    a ``mesh`` F^T F and F^T R are all-reduced (one collective) and every
    rank solves the same system."""
    red = all_reduce_tree({"ftf": featmat.T @ featmat,
                           "ftr": featmat.T @ returns}, mesh)
    ftf, ftr = red["ftf"], red["ftr"]
    eye = torch.eye(featmat.shape[-1], dtype=featmat.dtype,
                    device=featmat.device)
    coeffs = torch.zeros((featmat.shape[-1],), dtype=featmat.dtype,
                         device=featmat.device)
    found = torch.zeros((), dtype=torch.bool, device=featmat.device)
    reg = reg_coeff
    for _ in range(10):
        # solve_ex does not raise on a singular system (no host sync); a
        # failed factorization shows up as non-finite entries
        new, _ = torch.linalg.solve_ex(ftf + reg * eye, ftr)
        ok = torch.logical_not(torch.any(torch.isnan(new)))
        coeffs = torch.where(found, coeffs, torch.where(ok, new, coeffs))
        found = found | ok
        reg = reg * 10.0
    return coeffs


@dataclass(frozen=True)
class ZeroBaseline:
    """Predicts zeros."""
    obs_dim: int = 0

    def init(self, dtype=torch.float32, device=None):
        return ()

    def predict(self, state, obs):
        return torch.zeros(obs.shape[:-1], dtype=obs.dtype,
                           device=obs.device)

    def fit(self, state, obs, returns, mask=None, mesh=None):
        one = torch.ones((), dtype=obs.dtype, device=obs.device)
        return state, one, one


@dataclass(frozen=True)
class LinearBaseline:
    obs_dim: int
    reg_coeff: float = 1e-5

    def num_features(self):
        return self.obs_dim + 1 + 4

    def features(self, obs):
        """obs (..., T, n) -> (..., T, n + 5): [o, 1, t^1..t^4]."""
        o = _clip_obs(obs)
        T = obs.shape[-2]
        shape = obs.shape[:-1]
        ones = torch.ones(shape + (1,), dtype=obs.dtype, device=obs.device)
        tf = time_features(T, obs.dtype, obs.device).expand(shape + (4,))
        return torch.cat([o, ones, tf], dim=-1)

    def init(self, dtype=torch.float32, device=None):
        # zero coeffs predict zeros, matching the un-fitted baseline
        return torch.zeros((self.num_features(),), dtype=dtype,
                           device=device)

    def predict(self, coeffs, obs):
        return self.features(obs) @ coeffs.to(obs.dtype)

    def fit(self, coeffs, obs, returns, mask=None, mesh=None):
        """obs (N, T, n), returns (N, T) -> (new_coeffs, e_before, e_after)."""
        featmat = self.features(obs).reshape(-1, self.num_features())
        rets = returns.reshape(-1)
        m = torch.ones_like(rets) if mask is None else mask.reshape(-1)
        featmat = featmat * m[:, None]
        rets_m = rets * m
        e_before = _masked_rel_error(featmat @ coeffs.to(featmat.dtype),
                                     rets, m, mesh=mesh)
        new_coeffs = _lstsq_with_retry(featmat, rets_m, self.reg_coeff, mesh)
        e_after = _masked_rel_error(featmat @ new_coeffs, rets, m, mesh=mesh)
        return new_coeffs, e_before, e_after


@dataclass(frozen=True)
class QuadraticBaseline:
    obs_dim: int
    reg_coeff: float = 1e-3

    def num_features(self):
        n = self.obs_dim
        return int(n + n * (n + 1) // 2 + 1 + 4)

    def features(self, obs):
        """[o, o_i*o_j (i<=j), 1, t^1..t^4]."""
        o = _clip_obs(obs)
        iu, ju = torch.triu_indices(self.obs_dim, self.obs_dim,
                                    device=obs.device)
        quad = o[..., iu] * o[..., ju]
        T = obs.shape[-2]
        shape = obs.shape[:-1]
        ones = torch.ones(shape + (1,), dtype=obs.dtype, device=obs.device)
        tf = time_features(T, obs.dtype, obs.device).expand(shape + (4,))
        return torch.cat([o, quad, ones, tf], dim=-1)

    init = LinearBaseline.init
    predict = LinearBaseline.predict
    fit = LinearBaseline.fit


@dataclass(frozen=True)
class MLPBaseline:
    """ReLU MLP on [obs features, time features] -> scalar value.  State =
    (params, Adam state); the Adam state persists across fits."""
    obs_dim: int
    hidden_sizes: Tuple[int, ...] = (128, 128)
    learn_rate: float = 1e-3
    reg_coef: float = 0.0
    batch_size: int = 64
    epochs: int = 1

    def num_features(self):
        return self.obs_dim + 4

    def features(self, obs):
        o = _clip_obs(obs)
        T = obs.shape[-2]
        shape = obs.shape[:-1]
        tf = time_features(T, obs.dtype, obs.device).expand(shape + (4,))
        return torch.cat([o, tf], dim=-1)

    def init(self, generator, dtype=torch.float32, device=None):
        params = init_mlp_params(generator, self.num_features(), 1,
                                 self.hidden_sizes, dtype, device)
        return (params, adam_init(params))

    def _forward(self, params, feats):
        # float32 identity transforms, as the JAX package's: dividing by
        # float32(1 + 1e-8) == 1.0 leaves every input exact in float64 too
        tr = identity_transforms(self.num_features(), 1, torch.float32,
                                 feats.device)
        return mlp_forward(params, tr, feats, "relu")[..., 0]

    def predict(self, state, obs):
        return self._forward(state[0], self.features(obs))

    def fit(self, state, obs, returns, mask=None, generator=None,
            perms=None, mesh=None):
        """Minibatch Adam over ``epochs`` permutations of the samples,
        ``n_total // batch_size`` steps each (no last partial batch).  The
        permutations come from ``generator``, or for tests ``perms``
        (epochs, n_total).  Under a ``mesh`` the samples are every rank's
        (``n_total`` counts them all) and each rank takes the rows of a
        minibatch it holds.  -> ((params, adam state), e_before,
        e_after)."""
        params, opt_state = state[0], adam_copy(state[1])
        feats = self.features(obs).reshape(-1, self.num_features())
        rets = returns.reshape(-1)
        m = torch.ones_like(rets) if mask is None else mask.reshape(-1)
        n_local = rets.shape[0]
        lo, n_total = row_offset(n_local, mesh)
        bs = min(self.batch_size, n_total)
        num_steps = max(n_total // bs, 1)
        with torch.no_grad():
            e_before = _masked_rel_error(self._forward(params, feats), rets,
                                         m, eps=1e-8, mesh=mesh)
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        for e in range(self.epochs):
            perm = perms[e] if perms is not None else torch.randperm(
                n_total, generator=generator, device=generator.device)
            batches = torch.as_tensor(perm, device=feats.device)[
                :num_steps * bs].reshape(num_steps, bs)
            for idx in batches:
                idx, own = local_index(idx, lo, n_local)  # the rows it holds
                bm = m[idx] * own
                with torch.enable_grad():
                    pred = self._forward(p, feats[idx])
                    grads = masked_mean_grad((pred - rets[idx]) ** 2, bm, p,
                                             mesh)
                opt_state = adam_step_(p, grads, opt_state, self.learn_rate,
                                       self.reg_coef)
        params = {k: v.detach() for k, v in p.items()}
        with torch.no_grad():
            e_after = _masked_rel_error(self._forward(params, feats), rets,
                                        m, eps=1e-8, mesh=mesh)
        return (params, opt_state), e_before, e_after
