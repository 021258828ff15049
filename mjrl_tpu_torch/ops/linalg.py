"""Small symmetric positive-definite solves (counterpart of
``mjrl_tpu/ops/linalg.py``).

The joint-space systems of the physics engine are tiny (nv <= ~20) and
batched over environments.  They are factored by an unrolled Cholesky in
component form, ``a[..., i, j]`` one tensor each, with the JAX package's
pivot floor: where a pivot rounds to <= 0 it is floored at a tiny fraction
of the diagonal, so the solve stays finite instead of raising.  The
planar path (``physics/planar.py::_chol_factor_comp``) keeps its own copy
of the same factorisation on its dict of components.

Larger systems take ``torch.linalg.cholesky_ex``, which reports failure in
``info`` instead of checking it on the host.
"""

import torch

MAX_UNROLL = 20


def chol_factor(a):
    """Unrolled Cholesky of SPD ``a`` (..., n, n) -> lower factor as a
    list of rows of (...) component tensors (None above the diagonal)."""
    n = a.shape[-1]
    low = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - low[i][k] * low[j][k]
            if i == j:
                # pivot floor: an ill-conditioned SPD matrix can round to a
                # slightly negative pivot, and sqrt(neg) = NaN would poison
                # the rollout
                floor = 1e-10 * torch.abs(a[..., i, i]) + 1e-30
                low[i][j] = torch.sqrt(torch.maximum(s, floor))
            else:
                low[i][j] = s / low[j][j]
    return low


def chol_solve(low, b):
    """Solve L L^T x = b with a factor from ``chol_factor``; b (..., n)
    whose leading shape may carry extra dims to the right of the factor's
    (the factor's components broadcast against ``b[..., i]``)."""
    n = len(low)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - low[i][k] * y[k]
        y[i] = s / low[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - low[k][i] * x[k]
        x[i] = s / low[i][i]
    return torch.stack(x, dim=-1)


def chol_solve_unrolled(a, b):
    """Solve a x = b for SPD ``a`` (..., n, n), b (..., n) with the
    unrolled Cholesky and triangular solves."""
    return chol_solve(chol_factor(a), b)


class SPDFactor:
    """A factored SPD matrix (..., n, n) that solves one right-hand side
    (..., n) or many rows (..., C, n): the unrolled factor for n <=
    MAX_UNROLL, else ``cholesky_ex``."""

    def __init__(self, a):
        self.n = a.shape[-1]
        if self.n <= MAX_UNROLL:
            self.low = chol_factor(a)
            self.lib = None
        else:
            self.lib, _ = torch.linalg.cholesky_ex(a)

    def solve(self, b):
        if self.lib is not None:
            return torch.cholesky_solve(b.unsqueeze(-1), self.lib)[..., 0]
        return chol_solve(self.low, b)

    def solve_rows(self, rows):
        if self.lib is not None:
            return torch.cholesky_solve(rows.transpose(-1, -2),
                                        self.lib).transpose(-1, -2)
        lowb = [[None if x is None else x.unsqueeze(-1) for x in row]
                for row in self.low]
        return chol_solve(lowb, rows)


def spd_solve(a, b):
    """Solve an SPD system a (..., n, n) x = b (..., n)."""
    return SPDFactor(a).solve(b)


def spd_solve_rows(a, rows):
    """Solve a X^T = rows^T for many right-hand sides: rows (..., C, n)
    -> (..., C, n); the factor of ``a`` is taken once."""
    return SPDFactor(a).solve_rows(rows)
