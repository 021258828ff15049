"""MuJoCo-grade implicit constraint solver (counterpart of
``mjrl_tpu/physics/solver.py``), batch-first.

Selecting ``solver="pgs"`` (aliases ``"newton"``/``"implicit"``) on the
builder moves joint limits, tendon limits, contacts and equality
constraints from the penalty path to MuJoCo's soft-constraint
formulation, solved exactly:

  qacc = argmin_a  1/2 (a - a_smooth)^T M (a - a_smooth)
                 + 1/2 sum_i active_i * psi_i(J_i a - aref_i) / R_i

  aref_i = -B (J_i v) - K d(r_i) r_i        r_i = pos_i - margin_i (<= 0)
  K = 1/(dmax^2 tc^2 dr^2),  B = 2/(dmax tc)   from solref=(tc, dr),
      tc floored at 2*timestep
  d(r) = the solimp impedance ramp
  R_i = (1 - d_i)/d_i * diagApprox_i   (limits: dof_invweight0[dof];
      contacts: body_invweight0 of both bodies, times 2 mu^2 (1 + mu^2)
      for pyramidal facets; equalities: the invweights of their objects)

Rows, in MuJoCo's efc order: the bilateral equality rows (1 per joint
coupling, 3 per connect, 6 per weld; impulses unbounded), one boxed
dry-friction row per dof with frictionloss, one signed row per limited
scalar dof, one row per ball joint's rotation-angle limit, one row per
fixed tendon, then the contact rows of every narrowphase slot
(``physics/collision.py``) by condim class: one row per frictionless
(condim 1) slot, then per condim-3, -4 and -6 slot its 2 (condim - 1)
pyramidal facets n +- mu t1, n +- mu t2 (slide, friction[0]), n +- mu_t
n_rot (torsion about the normal, friction[1]; condim >= 4), n +- mu_r
t1_rot, n +- mu_r t2_rot (rolling, friction[2]; condim 6), each friction
the elementwise max over the geom pair, in MuJoCo's tangent frame, every
facet of a contact sharing the slide regularizer.  Under the elliptic cone
a condim-3 slot gives 3 rows [n, t1, t2] (blocks of K rows each) sharing
the normal row's regularizer, projected onto the cone mu lam_n >= |lam_t|
(condim 4 and 6 are clamped to 3 there).  A condim class with more slots
than the model's ``contact_topk`` gives rows to its ``contact_topk``
deepest only, chosen per environment and row build; ``slot_ids`` name the
slot each row holds, so a warm start is dropped row by row when the chosen
set changes.

Solvers: ``solve_qacc``, the dual by Nesterov-accelerated projected
gradient descent in the diag(A+R)^(1/2)-scaled space (step 1/L, L from
``POWER_ITERS`` power iterations, gradient-test restart, a fixed number of
sweeps, 4 x as many under the elliptic cone), warm-started across
substeps; ``solve_qacc_newton``, MuJoCo's primal Newton solver (exact
Hessian with a tiny ridge, exact line search), when the model sets
``newton_iters`` on a pyramidal cone; then, when the model sets
``noslip_iters``, ``noslip_qacc`` reruns the friction dimensions without
regularization at fixed normal loads (after Newton, and after APGD on a
pyramidal cone).  The planar path's ``physics/planar.py::_solve_qacc`` is
the same APGD on a component Cholesky factor.
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
from mjrl_tpu_torch.physics.dynamics import (ball_limit_terms,
                                             equality_terms, tendon_lengths)
from mjrl_tpu_torch.physics.kinematics import model_tables
from mjrl_tpu_torch.physics.model import (BALL, ELLIPTIC, EQ_CONNECT, EQ_WELD,
                                          Model)

SWEEPS = 50       # APGD iterations for a cold (zero-impulse) solve
SWEEPS_WARM = 15  # iterations when warm-started from the previous substep
POWER_ITERS = 8   # power-iteration steps for the Lipschitz estimate
NEWTON_ITERS = 25      # outer Newton iterations
NEWTON_LS_ITERS = 8    # exact 1D Newton line-search iterations
NOSLIP_SWEEPS = 100    # APGD sweeps of the noslip friction post-pass
CLASSES = (1, 3, 4, 6)  # contact condim classes, in row order


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


def _contact_counts(model: Model):
    """Static {condim: slot count} after the contact_topk cap (keys 1, 3,
    4 and 6; the elliptic cone only ever has 1 and 3)."""
    cd = contact_pair_condims(model)
    counts = {}
    for c in CLASSES:
        n = int((cd == c).sum())
        counts[c] = min(n, model.contact_topk) if model.contact_topk else n
    return counts


def _facets(model: Model, cd):
    """Rows per slot of condim class ``cd``."""
    if cd == 1:
        return 1
    return 3 if model.cone == ELLIPTIC else 2 * (cd - 1)


def _n_static(model: Model):
    """Rows before the contacts -> (equality, dry friction, the rest:
    limits, ball limits and tendons)."""
    n_eq = sum({EQ_CONNECT: 3, EQ_WELD: 6}.get(k, 1) for k in model.eq_kind)
    n_fr = int((np.asarray(model.dof_frictionloss) > 0).sum())
    n_lim = int((np.asarray(model.dof_limited) > 0).sum())
    n_ball = sum(1 for x in model.jnt_type if x == BALL)
    return n_eq, n_fr, n_lim + n_ball + model.ntendon


def n_constraint_rows(model: Model):
    """Static total row count: equality + friction + limits + ball limits
    + tendon limits + contact rows after the contact_topk cap (the shape of
    the warm-start impulses threaded through step_n)."""
    cc = _contact_counts(model)
    return sum(_n_static(model)) + sum(_facets(model, c) * cc[c]
                                       for c in CLASSES)


def _soc_layout(model: Model):
    """Static (start, K) of the elliptic contact triple block [n (K), t1
    (K), t2 (K)] within the rows."""
    cc = _contact_counts(model)
    return sum(_n_static(model)) + cc[1], cc[3]


def _noslip_layout(model: Model):
    """Static row indices of the friction dimensions for the noslip pass
    -> (pair_plus, pair_minus, fr_rows): the + and - facet of every
    pyramidal tangent, torsion and rolling direction, and the dof
    dry-friction rows."""
    n_eq, n_fr, n_rest = _n_static(model)
    cc = _contact_counts(model)
    base = n_eq + n_fr + n_rest + cc[1]
    plus, minus = [], []
    for cd in (3, 4, 6):
        K = cc[cd]
        for f in range(cd - 1 if K else 0):
            plus += range(base + 2 * f * K, base + 2 * f * K + K)
            minus += range(base + (2 * f + 1) * K, base + (2 * f + 2) * K)
        base += 2 * (cd - 1) * K
    return (np.asarray(plus, np.int64), np.asarray(minus, np.int64),
            np.arange(n_eq, n_eq + n_fr, dtype=np.int64))


def _statics(model: Model, dtype, device):
    """Per-model constants of the row assembly, cached with the tables."""
    t = model_tables(model, dtype, device)
    if hasattr(t, "rows"):
        return t.rows
    h = t.timestep
    s = SimpleNamespace()
    nv = model.nv
    fl = np.asarray(model.dof_frictionloss)
    s.fr_idx = np.flatnonzero(fl > 0)
    s.lim_idx = np.flatnonzero(np.asarray(model.dof_limited) > 0)
    s.ball = [j for j in range(model.njnt) if model.jnt_type[j] == BALL]
    s.eq_kb = [_kb(t.eq_solref[i], t.eq_solimp[i], h)
               for i in range(model.neq)]
    eye = torch.eye(nv, dtype=dtype, device=device)
    n_eq, n_fr, n_rest = _n_static(model)
    inf = float("inf")
    lo = [torch.full((n_eq,), -inf, dtype=dtype, device=device)]
    hi = [torch.full((n_eq,), inf, dtype=dtype, device=device)]
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
        # friction combined by elementwise max over the geom pair
        s.con_mu, s.con_mu_tors, s.con_mu_roll = (
            torch.maximum(t.geom_friction[g1, k], t.geom_friction[g2, k])
            for k in range(3))
        s.con_iw = t.body_invweight0[b1, 0] + t.body_invweight0[b2, 0]
        cd = contact_pair_condims(model)
        counts = _contact_counts(model)
        # (condim, slot ids of the class, capped) in row order
        s.classes = []
        for c in CLASSES:
            idx = np.flatnonzero(cd == c)
            if idx.size:
                s.classes.append((c, torch.tensor(idx, device=device),
                                  counts[c] < idx.size))
                n_con_rows += _facets(model, c) * counts[c]
    s.n_static = n_eq + n_fr + n_rest
    lo.append(torch.zeros(n_rest + n_con_rows, dtype=dtype, device=device))
    hi.append(torch.full((n_rest + n_con_rows,), inf, dtype=dtype,
                         device=device))
    s.lo, s.hi = torch.cat(lo), torch.cat(hi)
    s.soc = None
    if model.cone == ELLIPTIC and _contact_counts(model)[3]:
        st, K = _soc_layout(model)
        s.lo[st:st + 3 * K] = -inf
        s.soc = (st, K)
    s.noslip = tuple(torch.tensor(a, device=device)
                     for a in _noslip_layout(model))
    t.rows = s
    return s


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
    slot_ids (B, C), soc_mu (B, K)).

    The velocity part of the reference acceleration is kept separate:
    aref(v) = aref_pos - b_row * (J v), so frozen rows are reused with only
    J v recomputed.  ``slot_ids`` is -1 on rows whose identity never
    changes and the emitted contact slot a contact row holds.  ``soc_mu``
    is the friction of the elliptic cone's K contact triples (K = 0 on a
    pyramidal cone)."""
    s = _statics(model, qpos.dtype, qpos.device)
    t = model_tables(model, qpos.dtype, qpos.device)
    B = qpos.shape[0]
    rows, arefs, brows, actives, regs = [], [], [], [], []

    # equality rows first (MuJoCo's efc order), bilateral
    for i, jrows, res, imppos, iw in equality_terms(model, data, cdof, qpos):
        k_e, b_e = s.eq_kb[i]
        imp_e = impedance(t.eq_solimp[i], imppos).unsqueeze(-1)
        rows.append(jrows)
        arefs.append(-k_e * imp_e * res)
        brows.append(b_e.expand_as(res))
        actives.append(t.eq_active[i].expand_as(res))
        regs.append(((1.0 - imp_e) / imp_e * iw).expand_as(res))

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
    soc_mu = qpos.new_zeros((B, 0))
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

        def jac_rot(dirs, cf):
            # pure-torque rows (torsion, rolling): cdof's angular part
            return torch.einsum("Bdk,BKk->BKd", cdof[..., :3], dirs) * cf

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
            pts, cf, t_n = take3(point), const(s.con_cf), take3(normal)
            j_n = jac(t_n, pts, cf)
            t_k, t_b, t_imp = const(s.con_k), const(s.con_b), take(imp_c)
            t_pos, t_active = take(pos_c), take(active_c)
            aref_c = -t_k * t_imp * t_pos
            iw = const(s.con_iw)
            if cd == 1:
                facets = [(j_n, aref_c, torch.clamp(
                    (1.0 - t_imp) / t_imp * iw, min=1e-12))]
            elif model.cone == ELLIPTIC:
                # [n, t1, t2] sharing the normal row's impedance and
                # regularizer; the tangent rows have no position term
                r_e = torch.clamp((1.0 - t_imp) / t_imp * iw, min=1e-12)
                zero = torch.zeros_like(aref_c)
                facets = [(j_n, aref_c, r_e),
                          (jac(take3(t1), pts, cf), zero, r_e),
                          (jac(take3(t2), pts, cf), zero, r_e)]
                soc_mu = const(s.con_mu).expand_as(t_pos)
            else:
                mue = const(s.con_mu)
                diag_approx = iw * 2.0 * mue * mue * (1.0 + mue * mue)
                r_f = torch.clamp((1.0 - t_imp) / t_imp * diag_approx,
                                  min=1e-12)
                dirs = [(jac(take3(t1), pts, cf), mue),
                        (jac(take3(t2), pts, cf), mue)]
                if cd >= 4:
                    dirs.append((jac_rot(t_n, cf), const(s.con_mu_tors)))
                if cd >= 6:
                    mu_r = const(s.con_mu_roll)
                    dirs.append((jac_rot(take3(t1), cf), mu_r))
                    dirs.append((jac_rot(take3(t2), cf), mu_r))
                facets = []
                for j_t, mu_i in dirs:
                    for sign_f in (1.0, -1.0):
                        facets.append((j_n + sign_f * mu_i.unsqueeze(-1)
                                       * j_t, aref_c, r_f))
            for j_f, a_f, r_c in facets:
                rows.append(j_f)
                arefs.append(a_f)
                brows.append(t_b.expand_as(t_pos))
                actives.append(t_active)
                regs.append(r_c.expand_as(t_pos))
                id_parts.append(ids)

    if not rows:
        z = qpos.new_zeros((B, 0))
        return (qpos.new_zeros((B, 0, model.nv)), z, z, z, z, s.lo, s.hi,
                torch.zeros((B, 0), dtype=torch.long, device=qpos.device),
                soc_mu)
    slot_ids = torch.cat(
        [torch.full((B, s.n_static), -1, dtype=torch.long,
                    device=qpos.device)] + id_parts, dim=1)
    return (torch.cat(rows, dim=1), torch.cat(arefs, dim=1),
            torch.cat(brows, dim=1), torch.cat(actives, dim=1),
            torch.cat(regs, dim=1), s.lo, s.hi, slot_ids, soc_mu)


def _matvec(a, x):
    """(B, C, n) @ (B, n) -> (B, C)."""
    return torch.matmul(a, x.unsqueeze(-1)).squeeze(-1)


def _rmatvec(a, x):
    """(B, C, n)^T @ (B, C) -> (B, n)."""
    return torch.matmul(x.unsqueeze(-2), a).squeeze(-2)


def _norm(x):
    return torch.clamp(torch.linalg.vector_norm(x, dim=-1), min=1e-12)


def _lipschitz(op, v):
    """1.1 x the largest eigenvalue of ``op`` by POWER_ITERS power
    iterations from v (B, n), floored at 1e-8 -> (B, 1)."""
    v = v / _norm(v).unsqueeze(-1)
    for _ in range(POWER_ITERS):
        w = op(v)
        lmax = _norm(w)
        v = w / lmax.unsqueeze(-1)
    return torch.clamp(1.1 * lmax, min=1e-8).unsqueeze(-1)


def _apgd(op, rhs, project, mu, sweeps, el):
    """Nesterov-accelerated projected gradient descent with the adaptive
    (gradient-test) restart: ``sweeps`` steps of 1/el from mu."""
    y = mu
    tt = mu.new_ones(mu.shape[:-1])
    for _ in range(int(sweeps)):
        g = op(y) - rhs
        mu_new = project(y - g / el)
        # kill momentum when the momentum direction opposes descent
        restart = torch.sum((y - mu_new) * (mu_new - mu), dim=-1) > 0
        tt = torch.where(restart, torch.ones_like(tt), tt)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * tt * tt))
        mom = torch.where(restart, torch.zeros_like(tt), (tt - 1.0) / t_new)
        y = mu_new + mom.unsqueeze(-1) * (mu_new - mu)
        mu, tt = mu_new, t_new
    return mu


def solve_qacc(m, a0, j, aref, active, r, lam0, lo, hi, sweeps=SWEEPS,
               factor=None, soc=None):
    """Diagonally preconditioned APGD solve of the regularized dual
    min_lam 1/2 lam^T (A + R) lam - lam^T (aref - J a0) over the feasible
    set, A = J M^-1 J^T never materialized -> (qacc (B, nv), lam (B, C)).

    m (B, nv, nv) (or its ``factor``, an ``ops.linalg.SPDFactor``), a0
    (B, nv), j (B, C, nv), the rest (B, C); ``lo``/``hi`` (C,) impulse
    bounds (-inf on bilateral rows and elliptic triples).  ``soc`` = (start, K, mu (B, K)): the elliptic
    contact triples [n, t1, t2] at rows start.. start + 3K; the normal row
    keeps its scale and the tangent pair shares one (their geometric mean),
    so the cone stays circular in the scaled space with the opening mu
    d_t / d_n, and each triple is projected onto it in closed form."""
    factor = SPDFactor(m) if factor is None else factor
    minv_jt = factor.solve_rows(j)                           # (B, C, nv)
    diag = torch.sum(j * minv_jt, dim=-1)
    ds = torch.sqrt(torch.clamp(diag + r, min=1e-12))
    if soc is not None:
        st, K, mu_g = soc
        ds_n = ds[:, st:st + K]
        ds_t = torch.sqrt(ds[:, st + K:st + 2 * K]
                          * ds[:, st + 2 * K:st + 3 * K])
        ds = torch.cat([ds[:, :st + K], ds_t, ds_t, ds[:, st + 3 * K:]], 1)
        mu_g = mu_g * ds_t / ds_n

    def op(v):     # preconditioned operator D^-1/2 (A + R) D^-1/2
        u = v / ds
        return (_matvec(j, _rmatvec(minv_jt, u)) + r * u) / ds

    el = _lipschitz(op, active)
    rhs = (aref - _matvec(j, a0)) / ds
    mu_lo = torch.where(torch.isinf(lo), lo, lo * ds)
    mu_hi = torch.where(torch.isinf(hi), hi, hi * ds)

    def project(z):
        z = torch.minimum(torch.maximum(z, mu_lo), mu_hi)
        if soc is not None:
            # the SOC projection of each triple (its -inf lo passed it
            # through the clamp untouched)
            n_i = z[:, st:st + K]
            t1_i = z[:, st + K:st + 2 * K]
            t2_i = z[:, st + 2 * K:st + 3 * K]
            sn = torch.sqrt(t1_i * t1_i + t2_i * t2_i)
            inside = sn <= mu_g * n_i
            below = mu_g * sn <= -n_i
            c = (mu_g * sn + n_i) / (1.0 + mu_g * mu_g)
            zero = torch.zeros_like(c)
            n_p = torch.where(inside, n_i, torch.where(below, zero, c))
            tsc = torch.where(inside, torch.ones_like(c), torch.where(
                below, zero, mu_g * c / torch.clamp(sn, min=1e-30)))
            z = torch.cat([z[:, :st], n_p, t1_i * tsc, t2_i * tsc,
                           z[:, st + 3 * K:]], dim=1)
        return z * active

    mu = _apgd(op, rhs, project, lam0 * active * ds, sweeps, el)
    lam = mu / ds
    return a0 + _rmatvec(minv_jt, lam), lam


def noslip_qacc(model: Model, m, j, aref, lam, lo, hi, qacc, factor=None):
    """MuJoCo's noslip post-pass -> qacc'.

    It reruns the friction dimensions after the main solve without the
    constraint softening, holding the normal loads fixed: per pyramidal
    facet pair the tangent force is lam+ - lam- with the sum s fixed, so
    the friction subproblem is a box QP over d in [-s, s] (dry-friction
    rows: [-floss, floss]) toward zero slip (dry friction: its -b v
    target).  Solved by the dual's preconditioned APGD, NOSLIP_SWEEPS
    sweeps; an inactive pair has s = 0, so its box is a point."""
    s_ = _statics(model, qacc.dtype, qacc.device)
    ip, im, ifr = s_.noslip
    if len(ip) + len(ifr) == 0:
        return qacc
    factor = SPDFactor(m) if factor is None else factor
    b_rows = torch.cat([0.5 * (j[:, ip] - j[:, im]), j[:, ifr]], dim=1)
    d0 = torch.cat([lam[:, ip] - lam[:, im], lam[:, ifr]], dim=1)
    s = lam[:, ip] + lam[:, im]
    d_lo = torch.cat([-s, lo[ifr].expand(s.shape[0], -1)], dim=1)
    d_hi = torch.cat([s, hi[ifr].expand(s.shape[0], -1)], dim=1)
    # facet pairs share their aref: the pair's target is zero slip
    aref_f = torch.cat([0.5 * (aref[:, ip] - aref[:, im]), aref[:, ifr]],
                       dim=1)
    minv_bt = factor.solve_rows(b_rows)                      # (B, P, nv)
    a_base = qacc - _rmatvec(minv_bt, d0)
    rhs = aref_f - _matvec(b_rows, a_base)
    diag = torch.sum(b_rows * minv_bt, dim=-1)
    ds = torch.sqrt(torch.clamp(diag, min=1e-12))

    def op(v):
        return _matvec(b_rows, _rmatvec(minv_bt, v / ds)) / ds

    el = _lipschitz(op, torch.ones_like(ds))
    mu_lo, mu_hi = d_lo * ds, d_hi * ds

    def project(z):
        return torch.minimum(torch.maximum(z, mu_lo), mu_hi)

    mu = _apgd(op, rhs / ds, project, project(d0 * ds), NOSLIP_SWEEPS, el)
    return a_base + _rmatvec(minv_bt, mu / ds)


def solve_qacc_newton(m, a0, j, aref, active, r, lo, hi,
                      iters=NEWTON_ITERS):
    """MuJoCo's primal Newton solve of the same soft-constraint QP ->
    (qacc, lam): minimize over a

        f(a) = 1/2 (a - a0)^T M (a - a0) + sum_i active_i psi_i(J_i a - aref_i)

    with psi_i from the impulse bounds (C,): x^2 / 2R on a bilateral row
    (lo -inf, hi +inf), min(x, 0)^2 / 2R on a unilateral one (lo 0, hi
    +inf), the Huber cost of the force clipped to [lo, hi] on a boxed
    dry-friction row.  Each row's force is then clamp(x / R, glo, ghi), with
    (glo, ghi) = (lo, hi) but (-inf, 0) on unilateral rows, and its Hessian
    weight is 1 where glo < x / R < ghi: no infinite bound is ever
    multiplied.  Each iteration: the exact Hessian M + J^T diag(w) J plus a
    ridge of 1e-9 trace(M) / nv, a Cholesky solve, and NEWTON_LS_ITERS
    steps of an exact 1D Newton line search on the piecewise quadratic, its
    step clipped to [0, 2] afterwards."""
    unilateral = ~((torch.isneginf(lo) & torch.isposinf(hi))
                   | (torch.isfinite(lo) & torch.isfinite(hi)))
    glo = torch.where(unilateral, torch.full_like(lo, -float("inf")), lo)
    ghi = torch.where(unilateral, torch.zeros_like(hi), hi)

    def row_terms(x):
        """Per-row force psi'(x) and Hessian weight psi''(x)."""
        xr = x / r
        g_row = torch.minimum(torch.maximum(xr, glo), ghi)
        w = ((xr > glo) & (xr < ghi)).to(x.dtype)
        return active * g_row, active * w / r

    nv = m.shape[-1]
    ridge = (1e-9 * torch.diagonal(m, dim1=-2, dim2=-1).sum(-1) / nv)
    ridge = ridge[:, None, None] * torch.eye(nv, dtype=m.dtype,
                                             device=m.device)
    a = a0
    for _ in range(int(iters)):
        x = _matvec(j, a) - aref
        g_row, w = row_terms(x)
        da = a - a0
        grad = _matvec(m, da) + _rmatvec(j, g_row)
        jw = j * torch.sqrt(w).unsqueeze(-1)
        h = m + torch.matmul(jw.transpose(-1, -2), jw) + ridge
        step = -SPDFactor(h).solve(grad)
        dx = _matvec(j, step)
        mdd = torch.sum(step * _matvec(m, step), dim=-1)
        mdr = torch.sum(step * _matvec(m, da), dim=-1)
        alpha = torch.ones_like(mdd)
        for _ in range(NEWTON_LS_ITERS):
            ga, wa = row_terms(x + alpha.unsqueeze(-1) * dx)
            f1 = mdr + alpha * mdd + torch.sum(ga * dx, dim=-1)
            f2 = mdd + torch.sum(wa * dx * dx, dim=-1)
            alpha = alpha - f1 / torch.clamp(f2, min=1e-12)
        a = a + torch.clamp(alpha, 0.0, 2.0).unsqueeze(-1) * step
    lam = -row_terms(_matvec(j, a) - aref)[0]
    return a, lam


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
    earlier evaluation, with only the velocity part of aref recomputed.

    The primal Newton solver takes over when the model sets
    ``newton_iters`` and its cone is pyramidal (it needs no warm start,
    but its impulses are returned in the warm format); the noslip pass
    follows Newton, and APGD on a pyramidal cone, when the model sets
    ``noslip_iters``."""
    factor = SPDFactor(m)
    a0 = factor.solve(qfrc_minus_bias)
    if ctx is None:
        ctx = constraint_rows(model, data, cdof, qpos, qvel)
    j, aref_pos, b_row, active, r, lo, hi, slot_ids, soc_mu = ctx
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
    pyramidal = model.cone != ELLIPTIC
    if model.newton_iters and pyramidal:
        qacc, lam = solve_qacc_newton(m, a0, j, aref, active, r, lo, hi,
                                      iters=model.newton_iters)
    else:
        sw = SWEEPS if sweeps is None else sweeps
        soc = None
        if s.soc is not None:
            # the cone-coupled dual converges ~4 x slower than the
            # pyramidal facets
            soc = s.soc + (soc_mu,)
            sw = 4 * sw
        qacc, lam = solve_qacc(m, a0, j, aref, active, r, lam0, lo, hi,
                               sweeps=sw, factor=factor, soc=soc)
    if model.noslip_iters and pyramidal:
        qacc = noslip_qacc(model, m, j, aref, lam, lo, hi, qacc, factor)
    return qacc, a0, (lam, slot_ids), ctx
