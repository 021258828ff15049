"""MuJoCo-grade implicit constraint solver, dual APGD (counterpart of the
non-contact half of ``mjrl_tpu/physics/solver.py``), batch-first.

Selecting ``solver="pgs"`` (aliases ``"newton"``/``"implicit"``) on the
builder moves joint limits from the penalty path (``dynamics.limit_qacc``)
to MuJoCo's soft-constraint formulation, solved exactly:

  qacc = argmin_a  1/2 (a - a_smooth)^T M (a - a_smooth)
                 + 1/2 sum_i active_i * min(J_i a - aref_i, 0)^2 / R_i

  aref_i = -B (J_i v) - K d(r_i) r_i        r_i = pos_i - margin_i (<= 0)
  K = 1/(dmax^2 tc^2 dr^2),  B = 2/(dmax tc)   from solref=(tc, dr),
      tc floored at 2*timestep
  d(r) = the solimp impedance ramp
  R_i = (1 - d_i)/d_i * diagApprox_i   (limits: dof_invweight0[dof];
      frictionless contacts: body_invweight0 of both bodies)

Rows, in MuJoCo's efc order: one boxed dry-friction row per dof with
frictionloss, one signed row per limited scalar dof, one row per ball
joint's rotation-angle limit, then one row per frictionless (condim 1)
plane-sphere contact (``physics/collision.py``).  Equality and tendon rows,
frictional contacts, other narrowphase pairs, the elliptic cone, the
primal Newton solver and the noslip pass are ROADMAP.md M9 and raise.

The dual is solved by ``solve_qacc``: Nesterov-accelerated projected
gradient descent in the diag(A+R)^(1/2)-scaled space, step 1/L with L from
``POWER_ITERS`` power iterations, adaptive (gradient-test) restart and a
fixed number of sweeps, warm-started across substeps.  The planar path's
``physics/planar.py::_solve_qacc`` is the same algorithm on a component
Cholesky factor, with the SOC branch this one leaves to M9.
"""

from types import SimpleNamespace

import numpy as np
import torch

from mjrl_tpu_torch.ops.linalg import SPDFactor
from mjrl_tpu_torch.physics.collision import (contact_coeffs, contact_condims,
                                              find_contacts,
                                              plane_sphere_pairs)
from mjrl_tpu_torch.physics.dynamics import ball_limit_terms
from mjrl_tpu_torch.physics.kinematics import model_tables
from mjrl_tpu_torch.physics.model import BALL, ELLIPTIC, Model

SWEEPS = 50       # APGD iterations for a cold (zero-impulse) solve
SWEEPS_WARM = 15  # iterations when warm-started from the previous substep
POWER_ITERS = 8   # power-iteration steps for the Lipschitz estimate


def impedance(solimp, violation):
    """MuJoCo solimp impedance ramp d(r) for violation r >= 0; solimp =
    (d0, dwidth, width, midpoint, power) (..., 5)."""
    return _impedance_components(
        tuple(solimp[..., i] for i in range(5)), violation)


def _kb(solref, solimp, timestep):
    """Constraint stiffness/damping in acceleration units; the timeconst
    is floored at 2*timestep like MuJoCo's implicit solvers."""
    return _kb_components(solref[..., 0], solref[..., 1], solimp[..., 1],
                          timestep)


def _kb_components(tc, dr, dmax, timestep):
    tc = torch.maximum(tc, 2.0 * timestep)
    k = 1.0 / torch.clamp(dmax * dmax * tc * tc * dr * dr, min=1e-12)
    b = 2.0 / torch.clamp(dmax * tc, min=1e-12)
    return k, b


def _impedance_components(si, violation):
    d0, dw, width, mid, power = si
    x = torch.clamp(violation / torch.clamp(width, min=1e-12), 0.0, 1.0)
    mid = torch.clamp(mid, 1e-4, 1.0 - 1e-4)
    y_lo = mid * (x / mid) ** power
    y_hi = 1.0 - (1.0 - mid) * ((1.0 - x) / (1.0 - mid)) ** power
    y = torch.where(x < mid, y_lo, y_hi)
    return torch.clamp(d0 + y * (dw - d0), 1e-4, 1.0 - 1e-4)


def check_supported(model: Model):
    """Raise for what the ported implicit solver does not hold."""
    if model.cone == ELLIPTIC:
        raise NotImplementedError(
            "the elliptic friction cone of the general solver needs "
            "ROADMAP.md M9")
    if model.noslip_iters:
        raise NotImplementedError(
            "the noslip post-pass (noslip_iterations > 0) needs ROADMAP.md "
            "M9")
    if model.ntendon or model.neq:
        raise NotImplementedError(
            "tendon and equality rows need ROADMAP.md M9")
    if model.contact_pairs and np.any(contact_condims(model) != 1):
        raise NotImplementedError(
            "frictional contacts (condim > 1) of the general solver need "
            "ROADMAP.md M9")


def _statics(model: Model, dtype, device):
    """Per-model constants of the row assembly, cached with the tables."""
    t = model_tables(model, dtype, device)
    if hasattr(t, "rows"):
        return t.rows
    check_supported(model)
    h = t.timestep
    s = SimpleNamespace()
    nv = model.nv
    fl = np.asarray(model.dof_frictionloss)
    s.fr_idx = np.flatnonzero(fl > 0)
    s.lim_idx = np.flatnonzero(np.asarray(model.dof_limited) > 0)
    s.ball = [j for j in range(model.njnt) if model.jnt_type[j] == BALL]
    eye = torch.eye(nv, dtype=dtype, device=device)
    lo, hi = [], []
    if s.fr_idx.size:
        fi = torch.tensor(s.fr_idx, device=device)
        _, b_f = _kb(t.dof_solref, t.dof_solimp, h)
        imp_f = impedance(t.dof_solimp, torch.zeros_like(t.dof_damping))
        s.fr_j = eye[fi]
        s.fr_b = b_f[fi]
        s.fr_r = ((1.0 - imp_f) / imp_f * t.dof_invweight0)[fi]
        flt = torch.tensor(fl[s.fr_idx], dtype=dtype, device=device)
        lo.append(-flt)
        hi.append(flt)
    if s.lim_idx.size:
        li = torch.tensor(s.lim_idx, device=device)
        s.lim_qpos = t.dof_qpos_idx[li]
        s.lim_eye = eye[li]
        s.lim_lo, s.lim_hi = t.dof_range[li, 0], t.dof_range[li, 1]
        s.lim_margin = t.dof_margin[li]
        s.lim_limited = t.dof_limited[li]
        k_l, b_l = _kb(t.dof_solref[li], t.dof_solimp[li], h)
        s.lim_k, s.lim_b = k_l, b_l
        s.lim_solimp = t.dof_solimp[li]
        s.lim_iw = t.dof_invweight0[li]
    s.ball_kb = {}
    for j in s.ball:
        s.ball_kb[j] = _kb(t.limit_solref[j], t.limit_solimp[j], h)
    s.ncon = len(model.contact_pairs)
    if s.ncon:
        g1, g2, _ = plane_sphere_pairs(model)
        gb = np.asarray(model.geom_body)
        b1, b2 = gb[g1], gb[g2]
        s.con_cf = contact_coeffs(model, dtype, device)         # (C, nv)

        def avg(tab, i):
            return 0.5 * (tab[g1, i] + tab[g2, i])

        s.con_si = tuple(avg(t.geom_solimp, i) for i in range(5))
        s.con_k, s.con_b = _kb_components(
            avg(t.geom_solref, 0), avg(t.geom_solref, 1), s.con_si[1], h)
        s.con_iw = t.body_invweight0[b1, 0] + t.body_invweight0[b2, 0]
    n_rest = s.lim_idx.size + len(s.ball) + s.ncon
    s.boxed = bool(s.fr_idx.size)
    lo.append(torch.zeros(n_rest, dtype=dtype, device=device))
    hi.append(torch.full((n_rest,), float("inf"), dtype=dtype,
                         device=device))
    s.lo, s.hi = torch.cat(lo), torch.cat(hi)
    t.rows = s
    return s


def n_constraint_rows(model: Model):
    """Static total row count: friction + limits + ball limits + contact
    rows (the shape of the warm-start impulses threaded through step_n)."""
    n_fr = int((np.asarray(model.dof_frictionloss) > 0).sum())
    n_lim = int((np.asarray(model.dof_limited) > 0).sum())
    n_ball = sum(1 for x in model.jnt_type if x == BALL)
    return n_fr + n_lim + n_ball + len(model.contact_pairs)


def constraint_rows(model: Model, data, cdof, qpos, qvel):
    """Assemble the constraint rows of a batch -> (J (B, C, nv), aref_pos
    (B, C), b_row (B, C), active (B, C), R (B, C), lo (C,), hi (C,)).

    The velocity part of the reference acceleration is kept separate:
    aref(v) = aref_pos - b_row * (J v)."""
    s = _statics(model, qpos.dtype, qpos.device)
    t = model_tables(model, qpos.dtype, qpos.device)
    B = qpos.shape[0]
    rows, arefs, brows, actives, regs = [], [], [], [], []

    if s.fr_idx.size:
        n = s.fr_idx.size
        rows.append(s.fr_j.expand(B, n, model.nv))
        arefs.append(qpos.new_zeros((B, n)))
        brows.append(s.fr_b.expand(B, n))
        actives.append(qpos.new_ones((B, n)))
        regs.append(s.fr_r.expand(B, n))

    if s.lim_idx.size:
        q = qpos[:, s.lim_qpos]
        lo, hi = s.lim_lo, s.lim_hi
        # nearer bound (a margin can activate a limit before violation)
        use_lower = (q - lo) <= (hi - q)
        sign = torch.where(use_lower, 1.0, -1.0).to(q.dtype)
        dist = torch.where(use_lower, q - lo, hi - q) - s.lim_margin
        active = s.lim_limited * (dist < 0)
        imp = impedance(s.lim_solimp, torch.clamp(-dist, min=0.0))
        rows.append(sign.unsqueeze(-1) * s.lim_eye)
        arefs.append(-s.lim_k * imp * dist)
        brows.append(s.lim_b.expand_as(dist))
        actives.append(active.to(q.dtype))
        regs.append((1.0 - imp) / imp * s.lim_iw)

    for bj, da, axis, bpos, _, _ in ball_limit_terms(model, qpos):
        k_b, b_b = s.ball_kb[bj]
        imp_b = impedance(t.limit_solimp[bj], torch.clamp(-bpos, min=0.0))
        jrow = qpos.new_zeros((B, model.nv))
        jrow[:, da:da + 3] = -axis
        rows.append(jrow.unsqueeze(1))
        arefs.append((-k_b * imp_b * bpos).unsqueeze(-1))
        brows.append(b_b.expand(B, 1))
        actives.append((t.jnt_limited[bj] * (bpos < 0)).to(qpos.dtype)
                       .unsqueeze(-1))
        regs.append(((1.0 - imp_b) / imp_b
                     * t.dof_invweight0[da]).unsqueeze(-1))

    if s.ncon:
        depths, point, normal, _, _ = find_contacts(model, data)
        # J[c, d] = cf[c, d] (cdof[d] . (p x n, n))
        u = torch.cat([torch.linalg.cross(point, normal, dim=-1), normal],
                      dim=-1)                                   # (B, C, 6)
        rows.append(torch.einsum("Bdk,BCk->BCd", cdof, u) * s.con_cf)
        imp_c = _impedance_components(s.con_si,
                                      torch.clamp(depths, min=0.0))
        arefs.append(-s.con_k * imp_c * -depths)
        brows.append(s.con_b.expand_as(depths))
        actives.append((depths > 0).to(depths.dtype))
        regs.append(torch.clamp((1.0 - imp_c) / imp_c * s.con_iw,
                                min=1e-12))

    if not rows:
        z = qpos.new_zeros((B, 0))
        return (qpos.new_zeros((B, 0, model.nv)), z, z, z, z, s.lo, s.hi)
    return (torch.cat(rows, dim=1), torch.cat(arefs, dim=1),
            torch.cat(brows, dim=1), torch.cat(actives, dim=1),
            torch.cat(regs, dim=1), s.lo, s.hi)


def _matvec(a, x):
    """(B, C, n) @ (B, n) -> (B, C)."""
    return torch.matmul(a, x.unsqueeze(-1)).squeeze(-1)


def _rmatvec(a, x):
    """(B, C, n)^T @ (B, C) -> (B, n)."""
    return torch.matmul(x.unsqueeze(-2), a).squeeze(-2)


def solve_qacc(m, a0, j, aref, active, r, lam0, sweeps=SWEEPS, lo=None,
               hi=None, factor=None):
    """Diagonally preconditioned APGD solve of the regularized dual
    min_lam 1/2 lam^T (A + R) lam - lam^T (aref - J a0) over the feasible
    set, A = J M^-1 J^T never materialized -> (qacc (B, nv), lam (B, C)).

    m (B, nv, nv) (or its ``factor``, an ``ops.linalg.SPDFactor``), a0
    (B, nv), j (B, C, nv), the rest (B, C); ``lo``/``hi`` (C,) impulse
    bounds (None: lam >= 0)."""
    factor = SPDFactor(m) if factor is None else factor
    minv_jt = factor.solve_rows(j)                           # (B, C, nv)
    diag = torch.sum(j * minv_jt, dim=-1)
    ds = torch.sqrt(torch.clamp(diag + r, min=1e-12))

    def op(v):     # preconditioned operator D^-1/2 (A + R) D^-1/2
        u = v / ds
        return (_matvec(j, _rmatvec(minv_jt, u)) + r * u) / ds

    def norm(x):
        return torch.clamp(torch.linalg.vector_norm(x, dim=-1), min=1e-12)

    v = active / norm(active).unsqueeze(-1)
    lmax = ds.new_ones(ds.shape[:-1])
    for _ in range(POWER_ITERS):
        w = op(v)
        lmax = norm(w)
        v = w / lmax.unsqueeze(-1)
    el = torch.clamp(1.1 * lmax, min=1e-8).unsqueeze(-1)

    rhs = (aref - _matvec(j, a0)) / ds
    mu = lam0 * active * ds
    boxed = lo is not None
    if boxed:
        mu_lo = lo * ds
        mu_hi = torch.where(torch.isinf(hi), hi, hi * ds)

    def project(z):
        if boxed:
            z = torch.minimum(torch.maximum(z, mu_lo), mu_hi)
        else:
            z = torch.clamp(z, min=0.0)
        return z * active

    y = mu
    tt = ds.new_ones(ds.shape[:-1])
    for _ in range(int(sweeps)):
        g = op(y) - rhs
        mu_new = project(y - g / el)
        # adaptive restart (gradient test): kill momentum when the momentum
        # direction opposes descent
        restart = torch.sum((y - mu_new) * (mu_new - mu), dim=-1) > 0
        tt = torch.where(restart, torch.ones_like(tt), tt)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tt * tt))
        mom = torch.where(restart, torch.zeros_like(tt), (tt - 1.0) / t_new)
        y = mu_new + mom.unsqueeze(-1) * (mu_new - mu)
        mu, tt = mu_new, t_new
    lam = mu / ds
    return a0 + _rmatvec(minv_jt, lam), lam


def constrained_qacc(model: Model, data, cdof, qpos, qvel, m,
                     qfrc_minus_bias, warm=None, sweeps=None):
    """qacc under the implicit solver -> (qacc, qacc_smooth, lam).

    ``warm`` (B, C) seeds the dual iteration with the previous substep's
    impulses (MuJoCo's warm start); None = cold zeros.  ``sweeps``
    overrides the APGD iteration count; None = ``SWEEPS``.  Every ported
    row keeps its identity from one solve to the next, so the impulses
    carry over whole (the JAX package's per-slot invalidation only acts on
    capped contact sets)."""
    factor = SPDFactor(m)
    a0 = factor.solve(qfrc_minus_bias)
    j, aref_pos, b_row, active, r, lo, hi = constraint_rows(
        model, data, cdof, qpos, qvel)
    lam0 = torch.zeros_like(aref_pos) if warm is None else warm
    if j.shape[1] == 0:
        return a0, a0, lam0
    s = _statics(model, qpos.dtype, qpos.device)
    aref = aref_pos - b_row * _matvec(j, qvel)
    qacc, lam = solve_qacc(m, a0, j, aref, active, r, lam0,
                           sweeps=SWEEPS if sweeps is None else sweeps,
                           lo=lo if s.boxed else None,
                           hi=hi if s.boxed else None, factor=factor)
    return qacc, a0, lam
