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
joint's rotation-angle limit, one row per fixed tendon (length limits, R
from ``ten_invweight0``), then the contact rows of every narrowphase slot
(``physics/collision.py``): one row per frictionless (condim 1) slot, then
four pyramidal facets n +- mu t1, n +- mu t2 per condim-3 slot, in MuJoCo's
tangent frame, every facet sharing the regularizer of diagApprox (iw1 +
iw2) 2 mu^2 (1 + mu^2).  A condim class with more slots than the model's
``contact_topk`` gives rows to its ``contact_topk`` deepest only, chosen
per environment and row build; ``slot_ids`` name the slot each row holds,
so a warm start is dropped row by row when the chosen set changes.
Equality rows, condim 4 and 6, the elliptic cone, the primal Newton solver
and the noslip pass are ROADMAP.md M9b and raise.

The dual is solved by ``solve_qacc``: Nesterov-accelerated projected
gradient descent in the diag(A+R)^(1/2)-scaled space, step 1/L with L from
``POWER_ITERS`` power iterations, adaptive (gradient-test) restart and a
fixed number of sweeps, warm-started across substeps.  The planar path's
``physics/planar.py::_solve_qacc`` is the same algorithm on a component
Cholesky factor, with the SOC branch this one leaves to M9b.
"""

from types import SimpleNamespace

import numpy as np
import torch

from mjrl_tpu_torch.ops.linalg import SPDFactor
from mjrl_tpu_torch.physics import math as pm
from mjrl_tpu_torch.physics.collision import (contact_coeffs,
                                              contact_geom_ids,
                                              contact_pair_condims,
                                              find_contacts)
from mjrl_tpu_torch.physics.dynamics import ball_limit_terms, tendon_lengths
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
            "ROADMAP.md M9b")
    if model.noslip_iters:
        raise NotImplementedError(
            "the noslip post-pass (noslip_iterations > 0) needs ROADMAP.md "
            "M9b")
    if model.neq:
        raise NotImplementedError(
            "equality constraint rows need ROADMAP.md M9b")
    if np.any(contact_pair_condims(model) > 3):
        raise NotImplementedError(
            "torsional and rolling friction (condim 4 and 6) of the general "
            "solver need ROADMAP.md M9b")


def _contact_counts(model: Model):
    """Static {condim: rows-per-facet count} after the contact_topk cap."""
    cd = contact_pair_condims(model)
    counts = {}
    for c in (1, 3):
        n = int((cd == c).sum())
        counts[c] = min(n, model.contact_topk) if model.contact_topk else n
    return counts


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
    if model.ntendon:
        s.ten_k, s.ten_b = _kb(t.ten_solref, t.ten_solimp, h)
    g1, g2 = contact_geom_ids(model)
    s.ncon = len(g1)
    n_con_rows = 0
    if s.ncon:
        gb = np.asarray(model.geom_body)
        b1, b2 = gb[g1], gb[g2]
        s.con_cf = contact_coeffs(model, dtype, device)         # (C, nv)

        def avg(tab, i):
            return 0.5 * (tab[g1, i] + tab[g2, i])

        s.con_si = tuple(avg(t.geom_solimp, i) for i in range(5))
        s.con_k, s.con_b = _kb_components(
            avg(t.geom_solref, 0), avg(t.geom_solref, 1), s.con_si[1], h)
        s.con_mu = torch.maximum(t.geom_friction[g1, 0],
                                 t.geom_friction[g2, 0])
        s.con_iw = t.body_invweight0[b1, 0] + t.body_invweight0[b2, 0]
        cd = contact_pair_condims(model)
        counts = _contact_counts(model)
        # (condim, slot ids of the class, capped) in row order
        s.classes = []
        for c, facets in ((1, 1), (3, 4)):
            idx = np.flatnonzero(cd == c)
            if idx.size:
                s.classes.append((c, torch.tensor(idx, device=device),
                                  counts[c] < idx.size))
                n_con_rows += facets * counts[c]
    n_rest = s.lim_idx.size + len(s.ball) + model.ntendon + n_con_rows
    s.n_static = s.fr_idx.size + n_rest - n_con_rows
    s.boxed = bool(s.fr_idx.size)
    lo.append(torch.zeros(n_rest, dtype=dtype, device=device))
    hi.append(torch.full((n_rest,), float("inf"), dtype=dtype,
                         device=device))
    s.lo, s.hi = torch.cat(lo), torch.cat(hi)
    t.rows = s
    return s


def n_constraint_rows(model: Model):
    """Static total row count: friction + limits + ball limits + tendon
    limits + contact rows after the contact_topk cap (the shape of the
    warm-start impulses threaded through step_n)."""
    n_fr = int((np.asarray(model.dof_frictionloss) > 0).sum())
    n_lim = int((np.asarray(model.dof_limited) > 0).sum())
    n_ball = sum(1 for x in model.jnt_type if x == BALL)
    cc = _contact_counts(model)
    return n_fr + n_lim + n_ball + model.ntendon + cc[1] + 4 * cc[3]


def _tangents(normal):
    """MuJoCo's contact tangent frame (mju_makeFrame): seed (0, 1, 0)
    unless |n_y| >= 0.5, then (0, 0, 1); Gram-Schmidt against n; t2 =
    n x t1."""
    vy = (torch.abs(normal[..., 1]) < 0.5).to(normal.dtype)
    vz = 1.0 - vy
    dotv = normal[..., 1] * vy + normal[..., 2] * vz
    t1 = torch.stack([-normal[..., 0] * dotv, vy - normal[..., 1] * dotv,
                      vz - normal[..., 2] * dotv], dim=-1)
    t1 = t1 / torch.sqrt(torch.sum(t1 * t1, dim=-1, keepdim=True) + 1e-24)
    return t1, pm.cross(normal, t1)


def _total_order(x):
    """Integer keys that sort as ``x`` in the IEEE total order (-0.0 below
    +0.0), the order in which ``jax.lax.top_k`` compares floats."""
    bits = x.contiguous().view(torch.int64 if x.element_size() == 8
                               else torch.int32)
    n = 8 * x.element_size() - 1
    return bits ^ ((bits >> n) & ((1 << n) - 1))


def _select(depths, idx, k):
    """The contact_topk cap of one condim class: the k deepest of the
    class's slots ``idx`` per row, as slot ids in ascending order (B, k).
    Among equal depths the lower slot wins, as ``jax.lax.top_k`` picks."""
    order = torch.sort(_total_order(depths[:, idx]), dim=1, descending=True,
                       stable=True).indices[:, :k]
    return torch.sort(idx[order], dim=1).values


def constraint_rows(model: Model, data, cdof, qpos, qvel):
    """Assemble the constraint rows of a batch -> (J (B, C, nv), aref_pos
    (B, C), b_row (B, C), active (B, C), R (B, C), lo (C,), hi (C,),
    slot_ids (B, C)).

    The velocity part of the reference acceleration is kept separate:
    aref(v) = aref_pos - b_row * (J v), so frozen rows are reused with only
    J v recomputed.  ``slot_ids`` is -1 on rows whose identity never
    changes and the emitted contact slot a contact row holds."""
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

    if model.ntendon:
        # one signed row per tendon with the constant Jacobian
        L = tendon_lengths(model, qpos)
        tlo, thi = t.ten_range[:, 0], t.ten_range[:, 1]
        t_below = torch.clamp(tlo - L, min=0.0)
        t_above = torch.clamp(L - thi, min=0.0)
        t_lower = t_below >= t_above
        t_sign = torch.where(t_lower, 1.0, -1.0).to(L.dtype)
        t_dist = torch.where(t_lower, L - tlo, thi - L)
        active_t = t.ten_limited * ((t_below > 0) | (t_above > 0))
        imp_t = impedance(t.ten_solimp, torch.clamp(-t_dist, min=0.0))
        rows.append(t_sign.unsqueeze(-1) * t.ten_J)
        arefs.append(-s.ten_k * imp_t * t_dist)
        brows.append(s.ten_b.expand_as(t_dist))
        actives.append(active_t.to(L.dtype))
        regs.append((1.0 - imp_t) / imp_t * t.ten_invweight0)

    id_parts = []
    if s.ncon:
        depths, point, normal, _, _ = find_contacts(model, data)
        pos_c = -depths                                   # dist - margin
        active_c = (depths > 0).to(depths.dtype)
        imp_c = _impedance_components(s.con_si,
                                      torch.clamp(depths, min=0.0))
        t1, t2 = _tangents(normal)

        def jac(dirs, pts, cf):
            # J[c, d] = cf[c, d] (cdof[d] . (p x dir, dir))
            u = torch.cat([pm.cross(pts, dirs), dirs], dim=-1)
            return torch.einsum("Bdk,BKk->BKd", cdof, u) * cf

        for cd, idx, capped in s.classes:
            if capped:
                ids = _select(depths, idx, model.contact_topk)
                i3 = ids.unsqueeze(-1).expand(-1, -1, 3)
                take = lambda x: torch.gather(x, 1, ids)
                take3 = lambda x: torch.gather(x, 1, i3)
                const = lambda x: x[ids]
            else:
                ids = idx.expand(B, -1)
                take = take3 = lambda x: x[:, idx]
                const = lambda x: x[idx]
            pts, cf = take3(point), const(s.con_cf)
            j_n = jac(take3(normal), pts, cf)
            t_k, t_b, t_imp = const(s.con_k), const(s.con_b), take(imp_c)
            t_pos, t_active = take(pos_c), take(active_c)
            aref_c = -t_k * t_imp * t_pos
            iw = const(s.con_iw)
            if cd == 1:
                facets = [(j_n, torch.clamp((1.0 - t_imp) / t_imp * iw,
                                            min=1e-12))]
            else:
                mue = const(s.con_mu)
                diag_approx = iw * 2.0 * mue * mue * (1.0 + mue * mue)
                r_f = torch.clamp((1.0 - t_imp) / t_imp * diag_approx,
                                  min=1e-12)
                mu_j = mue.unsqueeze(-1)
                facets = []
                for j_t in (jac(take3(t1), pts, cf), jac(take3(t2), pts, cf)):
                    for sign_f in (1.0, -1.0):
                        facets.append((j_n + sign_f * mu_j * j_t, r_f))
            for j_f, r_c in facets:
                rows.append(j_f)
                arefs.append(aref_c)
                brows.append(t_b.expand_as(t_pos))
                actives.append(t_active)
                regs.append(r_c.expand_as(t_pos))
                id_parts.append(ids)

    if not rows:
        z = qpos.new_zeros((B, 0))
        return (qpos.new_zeros((B, 0, model.nv)), z, z, z, z, s.lo, s.hi,
                torch.zeros((B, 0), dtype=torch.long, device=qpos.device))
    slot_ids = torch.cat(
        [torch.full((B, s.n_static), -1, dtype=torch.long,
                    device=qpos.device)] + id_parts, dim=1)
    return (torch.cat(rows, dim=1), torch.cat(arefs, dim=1),
            torch.cat(brows, dim=1), torch.cat(actives, dim=1),
            torch.cat(regs, dim=1), s.lo, s.hi, slot_ids)


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
                     qfrc_minus_bias, warm=None, sweeps=None, ctx=None):
    """qacc under the implicit solver -> (qacc, qacc_smooth, warm', ctx).

    ``warm``/``warm'`` is the (impulses (B, C), slot_ids (B, C)) pair that
    seeds the dual iteration from the previous substep's or RK4 stage's
    solve (MuJoCo's warm start); None = cold zeros.  An impulse whose row
    now holds another contact slot (the contact_topk set changed between
    row builds) is dropped.  ``sweeps`` overrides the APGD iteration count;
    None = ``SWEEPS``.  ``ctx`` (the returned ``constraint_rows`` tuple)
    reuses frozen rows: J, positions, impedances and regularizers from an
    earlier evaluation, with only the velocity part of aref recomputed."""
    factor = SPDFactor(m)
    a0 = factor.solve(qfrc_minus_bias)
    if ctx is None:
        ctx = constraint_rows(model, data, cdof, qpos, qvel)
    j, aref_pos, b_row, active, r, lo, hi, slot_ids = ctx
    if warm is None:
        lam0 = torch.zeros_like(aref_pos)
    else:
        lam_prev, ids_prev = warm
        lam0 = torch.where(slot_ids == ids_prev, lam_prev,
                           torch.zeros_like(lam_prev))
    if j.shape[1] == 0:
        return a0, a0, (lam0, slot_ids), ctx
    s = _statics(model, qpos.dtype, qpos.device)
    aref = aref_pos - b_row * _matvec(j, qvel)
    qacc, lam = solve_qacc(m, a0, j, aref, active, r, lam0,
                           sweeps=SWEEPS if sweeps is None else sweeps,
                           lo=lo if s.boxed else None,
                           hi=hi if s.boxed else None, factor=factor)
    return qacc, a0, (lam, slot_ids), ctx
