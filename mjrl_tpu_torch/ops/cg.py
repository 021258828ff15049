"""Conjugate-gradient solve on parameter trees (counterpart of
``mjrl_tpu/ops/cg.py``).

Textbook CG that (a) operates on tensors or dicts of tensors so the
Fisher-vector product never leaves the device, and (b) honors ``x0``.

Runs a fixed number of iterations with a ``done`` flag emulating the
residual-tolerance early exit without a host sync — iterations after
convergence are no-ops.
"""

import torch

from mjrl_tpu_torch.ops.flat import (_map, tree_add_scaled, tree_dot,
                                     tree_zeros_like)


def cg_solve(f_Ax, b, x0=None, cg_iters=10, residual_tol=1e-10):
    """Solve A x = b where ``f_Ax`` maps a tree to a tree.

    Fixed ``cg_iters`` iterations; updates freeze once the squared residual
    drops below ``residual_tol``.
    """
    if x0 is None:
        x = tree_zeros_like(b)
        r = b
    else:
        x = x0
        r = _map(lambda bi, ax: bi - ax, b, f_Ax(x0))
    p = r
    rdotr = tree_dot(r, r)
    zero = torch.zeros_like(rdotr)
    one = torch.ones_like(rdotr)
    done = rdotr < residual_tol

    for _ in range(cg_iters):
        z = f_Ax(p)
        pz = tree_dot(p, z)
        # Guard divide-by-zero once converged/degenerate.
        v = torch.where(done | (pz == 0.0), zero,
                        rdotr / torch.where(pz == 0.0, one, pz))
        x = tree_add_scaled(x, p, v)
        r = tree_add_scaled(r, z, -v)
        newrdotr = tree_dot(r, r)
        mu = torch.where(done | (rdotr == 0.0), zero,
                         newrdotr / torch.where(rdotr == 0.0, one, rdotr))
        p = _map(lambda ri, pi: ri + mu * pi, r, p)
        new_done = done | (newrdotr < residual_tol)
        rdotr = torch.where(done, rdotr, newrdotr)
        done = new_done
    return x
