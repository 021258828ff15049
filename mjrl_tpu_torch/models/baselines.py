"""Value-function baselines: zero and linear least squares (counterpart of
``mjrl_tpu/models/baselines.py``).

- Feature map: obs clipped to [-10, 10] and divided by 10; a 1.0 bias
  column; time features (t/1000)^{1..4}.
- Fit: regularized least squares on Monte-Carlo returns with the reg
  coefficient multiplied by 10 on NaN, up to 10 attempts.
- Errors reported as relative squared error sum(e^2)/sum(R^2).

Everything operates on batched fixed-shape paths — observations
(N, T, obs_dim), returns (N, T), optional validity mask (N, T) — on the
tensors' own device.

``QuadraticBaseline`` and ``MLPBaseline`` are not ported yet
(ROADMAP.md M6b).
"""

from dataclasses import dataclass

import torch


def time_features(T, dtype=torch.float32, device=None):
    """(T, 4) matrix of (t/1000)^{1,2,3,4}."""
    al = torch.arange(T, dtype=dtype, device=device) / 1000.0
    return torch.stack([al, al ** 2, al ** 3, al ** 4], dim=-1)


def _clip_obs(obs):
    return torch.clamp(obs, -10.0, 10.0) / 10.0


def _masked_rel_error(pred, returns, mask, eps=0.0):
    err = (returns - pred) * mask
    return torch.sum(err ** 2) / (torch.sum((returns * mask) ** 2) + eps)


def _lstsq_with_retry(featmat, returns, reg_coeff):
    """Solve (F^T F + reg I) c = F^T R; on NaN multiply reg by 10, up to 10
    attempts — as a fixed loop with a ``found`` flag, no host sync."""
    ftf = featmat.T @ featmat
    ftr = featmat.T @ returns
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

    def fit(self, state, obs, returns, mask=None):
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

    def fit(self, coeffs, obs, returns, mask=None):
        """obs (N, T, n), returns (N, T) -> (new_coeffs, e_before, e_after)."""
        featmat = self.features(obs).reshape(-1, self.num_features())
        rets = returns.reshape(-1)
        m = torch.ones_like(rets) if mask is None else mask.reshape(-1)
        featmat = featmat * m[:, None]
        rets_m = rets * m
        e_before = _masked_rel_error(featmat @ coeffs.to(featmat.dtype),
                                     rets, m)
        new_coeffs = _lstsq_with_retry(featmat, rets_m, self.reg_coeff)
        e_after = _masked_rel_error(featmat @ new_coeffs, rets, m)
        return new_coeffs, e_before, e_after


def _not_ported(name):
    def ctor(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP.md M6b)")
    ctor.__name__ = name
    return ctor


QuadraticBaseline = _not_ported("QuadraticBaseline")
MLPBaseline = _not_ported("MLPBaseline")
