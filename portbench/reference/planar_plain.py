"""The plain planar step, frozen for the benchmark.

A copy of the port's plain PyTorch planar step (the smooth Euler branch of
K1 and the contact / RK4 branch of K2), taken when the benchmark was
defined, so that later changes to the program cannot move the yardstick:
the operation counters (``portbench/counts.py``) run on it, and the
reference of ``correct`` steps sampled transitions with it in float64.
It imports nothing of the program.  Its model parameters are the frozen
``PlanarParams`` of each configuration, ``configs/<config>.planar.json``.

    q2, v2 = step_n_arrays(params, qpos, qvel, ctrl, n)
"""

import json
from typing import NamedTuple, Tuple

import numpy as np
import torch

# the model's integrator and cone codes
EULER = 0
RK4 = 1
ELLIPTIC_CONE = 1


class PlanarParams(NamedTuple):
    """Static host-side description of a planar tree (python floats /
    numpy; baked into the kernel as constants).

    The plane is spanned by two world axes (ax1, ax2) with the hinge
    axis ax1 x ax2; 2D components of a world vector v are
    (v[ax1], v[ax2]).  Swimmer uses (x, y)/hinge +z; the gym locomotion
    suite (hopper/walker/cheetah) uses (z, x)/hinge +y."""
    nv: int
    nbody: int                   # moving bodies (world excluded)
    offsets: Tuple               # (nbody, 2) parent->body frame offset
    mass: Tuple                  # (nbody,)
    izz: Tuple                   # (nbody,) inertia about the hinge axis
    com: Tuple                   # (nbody, 2) CoM in body frame
    # fluid constants per body
    box: Tuple                   # (nbody, 3) equivalent-box semi-axes
    r0: Tuple                    # (nbody, 3, 3) inertial frame at phi=0
    viscosity: float
    density: float
    # per-dof tables (nv; dof 0,1 slide, 2.. hinge)
    damping: Tuple
    armature: Tuple
    limited: Tuple
    lo: Tuple
    hi: Tuple
    limit_k: Tuple
    limit_b: Tuple
    solimp: Tuple                # (nv, 5) per-dof limit solimp
    invweight0: Tuple            # (nv,) diag(M^-1) at qpos0
    # actuators: (joint dof index, gear, lo, hi, limited)
    actuators: Tuple
    timestep: float
    body_dof: Tuple              # (nbody,) index of the body's hinge dof
    # ---- tree / basis generalization (defaults = the swimmer chain) --
    parent: Tuple = ()           # (nbody,) parent moving-body idx, -1=root
    slide_dirs: Tuple = ((1.0, 0.0), (0.0, 1.0))   # 2D dirs of dof 0, 1
    slide_ref: Tuple = (0.0, 0.0)                  # FK ref of dof 0, 1
    hinge_sign: Tuple = ()       # (nbody,) +-1: hinge axis vs plane normal
    jpos: Tuple = ()             # (nbody, 2) hinge anchor in body frame
    stiffness: Tuple = ()        # (nv,) joint springs (0 = none)
    spring_ref: Tuple = ()       # (nv,) spring reference
    gravity2: Tuple = (0.0, 0.0)  # in-plane gravity
    ax1: int = 0                 # world axis index of 2D component 1
    ax2: int = 1                 # world axis index of 2D component 2
    integrator: int = EULER
    # ground/point contacts (plane-sphere + capsule end caps):
    # (body, (lx, ly), radius, up (2,), h0, k, b, solimp(5,), mu, iw)
    contacts_pt: Tuple = ()
    # capsule-capsule pairs (2D closest point):
    # (bA, pA0 (2,), pA1 (2,), rA, bB, pB0, pB1, rB, k, b, solimp, mu, iw)
    contacts_cc: Tuple = ()
    # friction-cone type (model.cone): PYRAMIDAL=0 emits 4 facet rows
    # per contact; ELLIPTIC=1 emits the [n, t1, t2] triple block with a
    # second-order-cone dual projection (t2 is the out-of-plane tangent,
    # a structurally zero row kept for regularizer/preconditioner parity
    # with the 3D engine — see _constraint_rows_comp)
    cone: int = 0



def _tuples(x):
    return tuple(_tuples(v) for v in x) if isinstance(x, list) else x


def load_params(path):
    """The frozen ``PlanarParams`` of a configuration (a JSON object of
    its fields)."""
    with open(path) as f:
        return PlanarParams(**{k: _tuples(v) for k, v in json.load(f).items()})


# ---------------------------------------------------------------------------
# component helpers (every value is an equally shaped tensor; tuples = vec2)
# ---------------------------------------------------------------------------

def _impedance_scalar(si, violation):
    """MuJoCo solimp impedance ramp with a STATIC (python float) solimp
    tuple and a tensor violation."""
    d0, dw, width, mid, power = si
    mid = min(max(mid, 1e-4), 1.0 - 1e-4)
    x = torch.clamp(violation / max(width, 1e-12), 0.0, 1.0)
    y_lo = mid * (x / mid) ** power
    y_hi = 1.0 - (1.0 - mid) * ((1.0 - x) / (1.0 - mid)) ** power
    y = torch.where(x < mid, y_lo, y_hi)
    return torch.clamp(d0 + y * (dw - d0), 1e-4, 1.0 - 1e-4)


def _perp(v):
    return (-v[1], v[0])


def _dot2(a, b):
    return a[0] * b[0] + a[1] * b[1]


def _cross2(a, b):
    return a[0] * b[1] - a[1] * b[0]


def _tree_tables(p: PlanarParams):
    """(parent, hinge_sign, jpos) with chain-era defaults filled in."""
    nb = p.nbody
    par = p.parent if p.parent else tuple(range(-1, nb - 1))
    hs = p.hinge_sign if p.hinge_sign else (1.0,) * nb
    jp = p.jpos if p.jpos else ((0.0, 0.0),) * nb
    return par, hs, jp


def chain_mask(p: PlanarParams):
    """chain[b][d] = 1 iff dof d drives body b (static)."""
    par, _, _ = _tree_tables(p)
    chain = [[0.0] * p.nv for _ in range(p.nbody)]
    for b in range(p.nbody):
        chain[b][0] = chain[b][1] = 1.0
        chain[b][p.body_dof[b]] = 1.0
        a = par[b]
        while a >= 0:
            chain[b][p.body_dof[a]] = 1.0
            a = par[a]
    return chain


def _planar_ctx(p: PlanarParams, q):
    """FK + per-dof motion axes.

    Returns (phi (nbody,), org (nbody, vec2), sdofs (nv, (omega, vec2)),
    coms (nbody, vec2 world CoM), chain mask (static)).

    Trees with off-origin hinge anchors: a body's frame is
    parent-offset, then rotation by sign*q about the anchor
    (org = anchor - R(phi) jpos); the root's slides move along
    ``slide_dirs`` with FK refs subtracted.
    """
    nb = p.nbody
    par, hs, jp = _tree_tables(p)
    d0, d1 = p.slide_dirs
    q0 = q[0] - p.slide_ref[0]
    q1 = q[1] - p.slide_ref[1]
    phi = [None] * nb
    org = [None] * nb
    anchors = [None] * nb
    phi[0] = hs[0] * q[p.body_dof[0]]
    org[0] = (p.offsets[0][0] + q0 * d0[0] + q1 * d1[0],
              p.offsets[0][1] + q0 * d0[1] + q1 * d1[1])
    anchors[0] = org[0]                     # root anchor at body origin
    for b in range(1, nb):
        pb = par[b]
        c, s = torch.cos(phi[pb]), torch.sin(phi[pb])
        ox, oy = p.offsets[b]
        jx, jy = jp[b]
        ax = org[pb][0] + c * (ox + jx) - s * (oy + jy)
        ay = org[pb][1] + s * (ox + jx) + c * (oy + jy)
        phi[b] = phi[pb] + hs[b] * q[p.body_dof[b]]
        cb, sb = torch.cos(phi[b]), torch.sin(phi[b])
        org[b] = (ax - (cb * jx - sb * jy), ay - (sb * jx + cb * jy))
        anchors[b] = (ax, ay)

    coms = []
    for b in range(nb):
        c, s = torch.cos(phi[b]), torch.sin(phi[b])
        cx, cy = p.com[b]
        coms.append((org[b][0] + c * cx - s * cy,
                     org[b][1] + s * cx + c * cy))

    zero = torch.zeros_like(q[0])
    one = torch.ones_like(q[0])
    sdofs = [None] * p.nv
    sdofs[0] = (zero, (d0[0] * one, d0[1] * one))
    sdofs[1] = (zero, (d1[0] * one, d1[1] * one))
    for b in range(nb):
        a = anchors[b]
        sg = hs[b]
        sdofs[p.body_dof[b]] = (sg * one, (sg * a[1], -sg * a[0]))

    return phi, org, sdofs, coms, chain_mask(p)


def _apply_inertia(p, b, com_w, mot):
    """h = I_b mot for planar motion (omega, u) -> (n_z, f)."""
    w, u = mot
    m = p.mass[b]
    pc = _perp(com_w)
    f = (m * (u[0] + w * pc[0]), m * (u[1] + w * pc[1]))
    n = p.izz[b] * w + _cross2(com_w, f)
    return n, f


def fluid_constants(p: PlanarParams, b):
    """Static inertia-box fluid coefficients of body b ->
    (c_v, c_w, quad_f (3,), quad_t (3,)): viscous force/torque
    coefficients and the quadratic-drag coefficients 0.5*density*area_i,
    0.5*density*tco_i, all python floats (double precision)."""
    bx = p.box[b]
    diam = (bx[0] + bx[1] + bx[2]) * 2.0 / 3.0
    area = [4.0 * bx[1] * bx[2], 4.0 * bx[0] * bx[2], 4.0 * bx[0] * bx[1]]
    tco = [bx[0] * (bx[1] ** 4 + bx[2] ** 4),
           bx[1] * (bx[0] ** 4 + bx[2] ** 4),
           bx[2] * (bx[0] ** 4 + bx[1] ** 4)]
    c_v = float(-3.0 * np.pi * diam * p.viscosity)
    c_w = float(-np.pi * diam ** 3 * p.viscosity)
    return (c_v, c_w,
            [0.5 * float(p.density * area[i]) for i in range(3)],
            [0.5 * float(p.density * tco[i]) for i in range(3)])


def _fluid(p, b, phi, com_w, vel_b):
    """World-origin planar fluid force (n_z, f) on body b (the planar
    reduction of MuJoCo's inertia-box fluid model)."""
    w, u = vel_b
    # CoM linear velocity
    pc = _perp(com_w)
    vx = u[0] + w * pc[0]
    vy = u[1] + w * pc[1]
    c, s = torch.cos(phi), torch.sin(phi)
    # world -> inertial frame: R = Rz(phi) R0; v_l = R0^T Rz(-phi) v
    vrx = c * vx + s * vy
    vry = -s * vx + c * vy
    r0 = p.r0[b]
    v_l = [r0[0][i] * vrx + r0[1][i] * vry for i in range(3)]
    w_l = [r0[2][i] * w for i in range(3)]      # R0^T (0,0,w)

    c_v, c_w, quad_f, quad_t = fluid_constants(p, b)
    f_l = [c_v * v_l[i] - quad_f[i] * torch.abs(v_l[i]) * v_l[i]
           for i in range(3)]
    t_l = [c_w * w_l[i] - quad_t[i] * torch.abs(w_l[i]) * w_l[i]
           for i in range(3)]

    # back to world: a_w = Rz(phi) R0 a_l; keep f xy and torque z
    fr = [sum(r0[i][k] * f_l[k] for k in range(3)) for i in range(3)]
    tr2 = sum(r0[2][k] * t_l[k] for k in range(3))
    f_w = (c * fr[0] - s * fr[1], s * fr[0] + c * fr[1])
    n_z = tr2 + _cross2(com_w, f_w)
    return n_z, f_w


def _planar_smooth(p: PlanarParams, q, v, ctrl):
    """Smooth dynamics -> (m dict (upper triangle), qfrc list
    (constraint-free), ctx)."""
    nv = p.nv
    ctx = _planar_ctx(p, q)
    phi, org, sdofs, coms, chain = ctx
    par, _, _ = _tree_tables(p)

    # body velocities (accumulate down the tree) + cdofdot
    vel = [None] * p.nbody
    sdot = [None] * nv
    zero = torch.zeros_like(q[0])
    sdot[0] = sdot[1] = (zero, (zero, zero))
    # carrier velocity before the root hinge = the slide translations
    d0, d1 = p.slide_dirs
    root_carrier = (zero, (v[0] * d0[0] + v[1] * d1[0],
                           v[0] * d0[1] + v[1] * d1[1]))
    for b in range(p.nbody):
        d = p.body_dof[b]
        w_c, u_c = root_carrier if par[b] < 0 else vel[par[b]]
        # cdofdot for hinge d: carrier velocity BEFORE this dof
        sd = sdofs[d]
        sdot[d] = (zero, (w_c * -sd[1][1] - sd[0] * -u_c[1],
                          w_c * sd[1][0] - sd[0] * u_c[0]))
        vel[b] = (w_c + sd[0] * v[d],
                  (u_c[0] + sd[1][0] * v[d], u_c[1] + sd[1][1] * v[d]))

    # mass matrix (upper triangle) + armature
    iu = {}
    for b in range(p.nbody):
        for d in range(nv):
            if chain[b][d]:
                iu[(b, d)] = _apply_inertia(p, b, coms[b], sdofs[d])
    m = {}
    for d in range(nv):
        for e in range(d, nv):
            acc = 0.0
            for b in range(p.nbody):
                if chain[b][d] and chain[b][e]:
                    n, f = iu[(b, e)]
                    acc = acc + sdofs[d][0] * n + _dot2(sdofs[d][1], f)
            m[(d, e)] = acc + (p.armature[d] if d == e else 0.0)

    # bias: f_b = I avp + v x* (I v); avp_b = sum_d sdot_d qd (chain)
    has_fluid = bool(p.viscosity or p.density)
    has_gravity = p.gravity2 != (0.0, 0.0)
    bias = [0.0] * nv
    for b in range(p.nbody):
        aw, aux, auy = zero, zero, zero
        for d in range(nv):
            if chain[b][d]:
                aw = aw + sdot[d][0] * v[d]
                aux = aux + sdot[d][1][0] * v[d]
                auy = auy + sdot[d][1][1] * v[d]
        n1, f1 = _apply_inertia(p, b, coms[b], (aw, (aux, auy)))
        nh, fh = _apply_inertia(p, b, coms[b], vel[b])
        w_b, u_b = vel[b]
        # force cross: (u x f, w * perp(f))
        n2 = _cross2(u_b, fh)
        f2 = (w_b * -fh[1], w_b * fh[0])
        n_tot = n1 + n2
        f_tot = (f1[0] + f2[0], f1[1] + f2[1])
        if has_fluid:
            nf, ff = _fluid(p, b, phi[b], coms[b], vel[b])
            n_tot = n_tot - nf
            f_tot = (f_tot[0] - ff[0], f_tot[1] - ff[1])
        if has_gravity:
            fg = (p.mass[b] * p.gravity2[0], p.mass[b] * p.gravity2[1])
            n_tot = n_tot - _cross2(coms[b], fg)
            f_tot = (f_tot[0] - fg[0], f_tot[1] - fg[1])
        for d in range(nv):
            if chain[b][d]:
                bias[d] = bias[d] + sdofs[d][0] * n_tot \
                    + _dot2(sdofs[d][1], f_tot)

    # applied forces: actuators + joint damping + joint springs
    qfrc = [-p.damping[d] * v[d] - bias[d] for d in range(nv)]
    if p.stiffness and any(p.stiffness):
        for d in range(nv):
            if p.stiffness[d]:
                qfrc[d] = qfrc[d] - p.stiffness[d] * (q[d]
                                                      - p.spring_ref[d])
    for i, (d, gear, lo, hi, lim) in enumerate(p.actuators):
        c = torch.clamp(ctrl[i], lo, hi) if lim else ctrl[i]
        qfrc[d] = qfrc[d] + gear * c
    return m, qfrc, ctx


PGS_SWEEPS = 12      # projected Gauss-Seidel sweeps of the limit dual


def planar_substep(p: PlanarParams, q, v, ctrl):
    """One semi-implicit Euler physics step on component lists
    (q (nv,), v (nv,), ctrl (nu,)) -> (q', v')."""
    nv = p.nv
    m, qfrc, ctx = _planar_smooth(p, q, v, ctrl)

    h = p.timestep

    def chol(mdict):
        low = {}
        for j in range(nv):
            for i in range(j, nv):
                s_ = mdict[(j, i)] if j <= i else mdict[(i, j)]
                for k in range(j):
                    s_ = s_ - low[(i, k)] * low[(j, k)]
                if i == j:
                    low[(j, j)] = torch.sqrt(torch.clamp(s_, min=1e-12))
                else:
                    low[(i, j)] = s_ / low[(j, j)]
        return low

    def solve(low, rhs):
        yv = [None] * nv
        for i in range(nv):
            s_ = rhs[i]
            for k in range(i):
                s_ = s_ - low[(i, k)] * yv[k]
            yv[i] = s_ / low[(i, i)]
        out = [None] * nv
        for i in reversed(range(nv)):
            s_ = yv[i]
            for k in range(i + 1, nv):
                s_ = s_ - low[(k, i)] * out[k]
            out[i] = s_ / low[(i, i)]
        return out

    low = chol(m)

    # MuJoCo-grade IMPLICIT joint limits: the exact soft-constraint dual
    # over the limited dofs (J = +-e_d rows), solved with projected
    # Gauss-Seidel (n_l <= ~6 rows: GS converges in a few sweeps).
    lim_dofs = [d for d in range(nv) if p.limited[d]]
    if lim_dofs:
        a0 = solve(low, qfrc)
        nl = len(lim_dofs)
        sign, aref, active, reg = [], [], [], []
        minv_cols = []
        zero = torch.zeros_like(q[0])
        one = torch.ones_like(q[0])
        for d in lim_dofs:
            below = torch.clamp(p.lo[d] - q[d], min=0.0)
            above = torch.clamp(q[d] - p.hi[d], min=0.0)
            use_lower = below >= above
            sg = torch.where(use_lower, one, -one)
            dist = torch.where(use_lower, q[d] - p.lo[d], p.hi[d] - q[d])
            act = ((below > 0) | (above > 0)).to(q[d].dtype)
            imp = _impedance_scalar(p.solimp[d],
                                    torch.clamp(-dist, min=0.0))
            aref.append(-p.limit_b[d] * sg * v[d]
                        - p.limit_k[d] * imp * dist)
            reg.append(torch.clamp((1.0 - imp) / imp * p.invweight0[d],
                                   min=1e-12))
            sign.append(sg)
            active.append(act)
            e_d = [one if e == d else zero for e in range(nv)]
            minv_cols.append(solve(low, e_d))
        amat = [[sign[i] * sign[j] * minv_cols[j][lim_dofs[i]]
                 for j in range(nl)] for i in range(nl)]
        bvec = [aref[i] - sign[i] * a0[lim_dofs[i]] for i in range(nl)]
        lam = [zero] * nl
        for _ in range(PGS_SWEEPS):
            for i in range(nl):
                g = sum(amat[i][j] * lam[j] for j in range(nl)) \
                    + reg[i] * lam[i] - bvec[i]
                lam[i] = active[i] * torch.clamp(
                    lam[i] - g / (amat[i][i] + reg[i]), min=0.0)
        for i in range(nl):              # qfrc += J^T lambda
            qfrc[lim_dofs[i]] = qfrc[lim_dofs[i]] + sign[i] * lam[i]

    # integrate with implicit joint damping: (M + h diag(B)) qacc = qfrc
    if any(p.damping):
        for d in range(nv):
            m[(d, d)] = m[(d, d)] + h * p.damping[d]
        low = chol(m)
    qacc = solve(low, qfrc)

    v2 = [v[d] + h * qacc[d] for d in range(nv)]
    q2 = [q[d] + h * v2[d] for d in range(nv)]
    return q2, v2


def planar_step_n(p: PlanarParams, q, v, ctrl, n: int):
    """n substeps (frame_skip); component lists in/out."""
    for _ in range(n):
        q, v = planar_substep(p, q, v, ctrl)
    return q, v


def needs_contact_path(p: PlanarParams) -> bool:
    return bool(p.contacts_pt or p.contacts_cc or p.integrator != EULER)


# ---------------------------------------------------------------------------
# contact / RK4 path (hopper / walker2d / half-cheetah-class models with
# ground contacts).  This is the PLAIN PYTORCH VERSION of the contact kernel
# (csrc/planar_contact.cuh).  Row assembly and the Cholesky factor stay in
# component form, shared with the smooth branch; the dual solve runs on
# stacked (..., C) / (..., C, nv) tensors with explicit sums, as
# planar_contact_step_n + solver.solve_qacc do in the JAX package.
# ---------------------------------------------------------------------------

# dual-solve constants (own copy of mjrl_tpu/physics/solver.py:61-63)
SWEEPS = 50       # APGD iterations for a cold (zero-impulse) solve
SWEEPS_WARM = 15  # iterations when warm-started from the previous solve
POWER_ITERS = 8   # power-iteration steps for the Lipschitz estimate


def _seg_closest_2d(a0, a1, b0, b1):
    """Closest points between 2D segments -> (c1 (2,), c2 (2,), dist)."""
    d1 = (a1[0] - a0[0], a1[1] - a0[1])
    d2 = (b1[0] - b0[0], b1[1] - b0[1])
    r = (a0[0] - b0[0], a0[1] - b0[1])
    a = _dot2(d1, d1) + 1e-12
    e = _dot2(d2, d2) + 1e-12
    f = _dot2(d2, r)
    c = _dot2(d1, r)
    b = _dot2(d1, d2)
    denom = a * e - b * b
    ok = torch.abs(denom) > 1e-12
    s = torch.where(
        ok,
        torch.clamp((b * f - c * e)
                    / torch.where(ok, denom, torch.ones_like(denom)),
                    0.0, 1.0),
        torch.zeros_like(denom))
    t = torch.clamp((b * s + f) / e, 0.0, 1.0)
    s = torch.clamp((b * t - c) / a, 0.0, 1.0)
    c1 = (a0[0] + d1[0] * s, a0[1] + d1[1] * s)
    c2 = (b0[0] + d2[0] * t, b0[1] + d2[1] * t)
    d = (c2[0] - c1[0], c2[1] - c1[1])
    dist = torch.sqrt(_dot2(d, d) + 1e-18)
    return c1, c2, dist


def capsule_axis_distance(p: PlanarParams, qpos):
    """Smallest distance between the axes of any capsule-capsule pair of
    ``p`` at the poses qpos (..., nv) -> (...,) tensor (inf without such
    pairs).  Where two axes cross, the contact normal (c2 - c1) / |c2 - c1|
    is 0 / 0 and rounding alone turns it: comparisons between two
    implementations of the step keep their states away from such poses."""
    phi, org, _, _, _ = _planar_ctx(p, [qpos[..., d] for d in range(p.nv)])
    best = torch.full_like(qpos[..., 0], float("inf"))

    def world(b, pt):
        c, s = torch.cos(phi[b]), torch.sin(phi[b])
        return (org[b][0] + c * pt[0] - s * pt[1],
                org[b][1] + s * pt[0] + c * pt[1])
    for c in p.contacts_cc:
        best = torch.minimum(best, _seg_closest_2d(
            world(c[0], c[1]), world(c[0], c[2]),
            world(c[4], c[5]), world(c[4], c[6]))[2])
    return best


def _constraint_rows_comp(p: PlanarParams, ctx, q, v):
    """Component-form constraint rows for the contact path ->
    (rows [C][nv], aref_pos [C], b_row [C], active [C], R [C], zero) —
    ``zero`` is the literal zero tensor used for off-chain Jacobian
    entries (``row[d] is zero`` marks a structural zero).

    One signed row per limited scalar dof, then per contact either one
    frictionless normal row (condim 1) or 4 pyramidal facet rows (the
    out-of-plane tangent pair degenerates to two duplicate normal rows,
    kept for parity with the 3D path's regularization); elliptic triples
    are flushed last in block order [n(K), t1(K), t2(K)]."""
    phi, org, sdofs, coms, chain = ctx
    nv = p.nv
    zero = torch.zeros_like(q[0])
    one = torch.ones_like(q[0])
    rows, arefs, brows, actives, regs = [], [], [], [], []

    # scalar-dof limits (signed identity rows); unlimited dofs are
    # statically dropped
    for d in range(nv):
        if not p.limited[d]:
            continue
        below = torch.clamp(p.lo[d] - q[d], min=0.0)
        above = torch.clamp(q[d] - p.hi[d], min=0.0)
        use_lower = below >= above
        sg = torch.where(use_lower, one, -one)
        dist = torch.where(use_lower, q[d] - p.lo[d], p.hi[d] - q[d])
        act = p.limited[d] * ((below > 0) | (above > 0)).to(q[d].dtype)
        imp = _impedance_scalar(p.solimp[d], torch.clamp(-dist, min=0.0))
        rows.append([sg * one if e == d else zero for e in range(nv)])
        arefs.append(-p.limit_k[d] * imp * dist)
        brows.append(p.limit_b[d] * one)
        actives.append(act)
        regs.append(torch.clamp((1.0 - imp) / imp * p.invweight0[d],
                                min=1e-12))

    def point_vel_rows(b, pc, direction):
        """J over dofs: chain-masked velocity of material point pc on
        body b along ``direction``."""
        out = []
        for d in range(nv):
            if chain[b][d]:
                w_d, u_d = sdofs[d]
                vp = (u_d[0] - w_d * pc[1], u_d[1] + w_d * pc[0])
                out.append(_dot2(vp, direction))
            else:
                out.append(zero)
        return out

    ell = []   # elliptic triples: (jn, jt, aref_n, brow, act, reg_e)

    def add_contact(jn, jt, depth, kc, bc, si, mu, iw, cd=3):
        imp = _impedance_scalar(si, torch.clamp(depth, min=0.0))
        act = (depth > 0).to(q[0].dtype)
        aref = kc * imp * depth
        brow = bc * one
        if cd == 1:
            # frictionless: ONE normal row, R from the raw invweight sum
            rows.append(jn)
            arefs.append(aref)
            brows.append(brow)
            actives.append(act)
            regs.append(torch.clamp((1.0 - imp) / imp * iw, min=1e-12))
            return
        if p.cone == ELLIPTIC_CONE:
            reg_e = torch.clamp((1.0 - imp) / imp * iw, min=1e-12)
            ell.append((jn, jt, aref, brow, act, reg_e))
            return
        reg = torch.clamp((1.0 - imp) / imp
                          * (iw * 2.0 * mu * mu * (1.0 + mu * mu)),
                          min=1e-12)
        for jrow in (jn, jn,
                     [jn[d] + mu * jt[d] for d in range(nv)],
                     [jn[d] - mu * jt[d] for d in range(nv)]):
            rows.append(jrow)
            arefs.append(aref)
            brows.append(brow)
            actives.append(act)
            regs.append(reg)

    for (b, (lx, ly), r, up, h0, kc, bc, si, mu, iw, cd) in p.contacts_pt:
        c, s = torch.cos(phi[b]), torch.sin(phi[b])
        px = org[b][0] + c * lx - s * ly
        py = org[b][1] + s * lx + c * ly
        d_up = up[0] * px + up[1] * py - h0     # center above plane
        depth = r - d_up
        # contact point midway between the surfaces (MuJoCo convention)
        pc = (px - up[0] * 0.5 * (d_up + r), py - up[1] * 0.5 * (d_up + r))
        tng = _perp(up)
        jn = point_vel_rows(b, pc, up)
        jt = point_vel_rows(b, pc, tng)
        add_contact(jn, jt, depth, kc, bc, si, mu, iw, cd)

    for (bA, pA0, pA1, rA, bB, pB0, pB1, rB,
         kc, bc, si, mu, iw, cd) in p.contacts_cc:
        def world(bb, pt):
            c, s = torch.cos(phi[bb]), torch.sin(phi[bb])
            return (org[bb][0] + c * pt[0] - s * pt[1],
                    org[bb][1] + s * pt[0] + c * pt[1])
        c1, c2, dist = _seg_closest_2d(world(bA, pA0), world(bA, pA1),
                                       world(bB, pB0), world(bB, pB1))
        n2 = ((c2[0] - c1[0]) / dist, (c2[1] - c1[1]) / dist)
        depth = (rA + rB) - dist
        pc = (0.5 * (c1[0] + n2[0] * rA + c2[0] - n2[0] * rB),
              0.5 * (c1[1] + n2[1] * rA + c2[1] - n2[1] * rB))
        tng = _perp(n2)
        jnB = point_vel_rows(bB, pc, n2)
        jnA = point_vel_rows(bA, pc, n2)
        jn = [jnB[d] - jnA[d] for d in range(nv)]
        jtB = point_vel_rows(bB, pc, tng)
        jtA = point_vel_rows(bA, pc, tng)
        jt = [jtB[d] - jtA[d] for d in range(nv)]
        add_contact(jn, jt, depth, kc, bc, si, mu, iw, cd)

    if ell:
        # t2 (the out-of-plane tangent) has an identically-zero Jacobian in
        # planar motion but is kept so the triple's shared tangent
        # preconditioner scale sqrt(ds_t1 * ds_t2) matches the 3D engine's
        zrow = [zero] * nv
        for jn, _jt, aref, brow, act, reg_e in ell:
            rows.append(jn); arefs.append(aref); brows.append(brow)
            actives.append(act); regs.append(reg_e)
        for _jn, jt, _aref, brow, act, reg_e in ell:
            rows.append(jt); arefs.append(zero); brows.append(brow)
            actives.append(act); regs.append(reg_e)
        for _jn, _jt, _aref, brow, act, reg_e in ell:
            rows.append(zrow); arefs.append(zero); brows.append(brow)
            actives.append(act); regs.append(reg_e)

    return rows, arefs, brows, actives, regs, zero


def _constraint_rows(p: PlanarParams, ctx, q, v):
    """Stacked view of _constraint_rows_comp -> (J (..., C, nv),
    aref_pos (..., C), b_row (..., C), active (..., C), R (..., C))."""
    rows, arefs, brows, actives, regs, _ = \
        _constraint_rows_comp(p, ctx, q, v)
    J = torch.stack([torch.stack(rw, dim=-1) for rw in rows], dim=-2)
    st = lambda xs: torch.stack(xs, dim=-1)
    return J, st(arefs), st(brows), st(actives), st(regs)


def n_planar_rows(p: PlanarParams):
    n_lim = sum(1 for d in range(p.nv) if p.limited[d])
    per = 3 if p.cone == ELLIPTIC_CONE else 4
    cds = [c[10] for c in p.contacts_pt] + [c[13] for c in p.contacts_cc]
    return n_lim + sum(1 if cd == 1 else per for cd in cds)


def _planar_soc(p: PlanarParams):
    """(st, K, mu tuple) of the elliptic triple block, or None.
    Frictionless (condim 1) contacts emit single inline rows BEFORE the
    flushed triple block, so they shift st and leave K."""
    if p.cone != ELLIPTIC_CONE:
        return None
    fr_pt = [c for c in p.contacts_pt if c[10] != 1]
    fr_cc = [c for c in p.contacts_cc if c[13] != 1]
    K = len(fr_pt) + len(fr_cc)
    if not K:
        return None
    n_cd1 = (len(p.contacts_pt) - len(fr_pt)
             + len(p.contacts_cc) - len(fr_cc))
    st = sum(1 for d in range(p.nv) if p.limited[d]) + n_cd1
    mus = tuple(float(c[8]) for c in fr_pt) \
        + tuple(float(c[11]) for c in fr_cc)
    return st, K, mus


def _chol_factor_comp(m, nv):
    """Unrolled Cholesky of the upper-triangle dict from _planar_smooth
    -> low[i][j] components (pivot floor 1e-10 |m_ii| + 1e-30)."""
    low = [[None] * nv for _ in range(nv)]
    for i in range(nv):
        for jj in range(i + 1):
            s = m[(jj, i)]
            for k in range(jj):
                s = s - low[i][k] * low[jj][k]
            if i == jj:
                floor = 1e-10 * torch.abs(m[(i, i)]) + 1e-30
                low[i][jj] = torch.sqrt(torch.maximum(s, floor))
            else:
                low[i][jj] = s / low[jj][jj]
    return low


def _chol_solve_comp(low, b):
    n = len(b)
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - low[i][k] * y[k]
        y[i] = s / low[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - low[k][i] * x[k]
        x[i] = s / low[i][i]
    return x


def _m_matvec_comp(m, x, nv):
    out = []
    for d in range(nv):
        s = None
        for e in range(nv):
            t = m[(min(d, e), max(d, e))] * x[e]
            s = t if s is None else s + t
        out.append(s)
    return out


def _solve_qacc(low, a0, J, aref, active, reg, lam0, sweeps, soc=None):
    """Diagonally preconditioned APGD solve of the regularized dual
    min_lam 1/2 lam^T (A + R) lam - lam^T (aref - J a0) over the feasible
    set, A = J M^-1 J^T never materialized -> (qacc (..., nv),
    lam (..., C)).  Step 1/L with L from ``POWER_ITERS`` power iterations,
    Nesterov momentum with adaptive (gradient-test) restart, a fixed number
    of sweeps.

    ``low``: component Cholesky factor of M; a0 (..., nv); J (..., C, nv);
    the rest (..., C).  ``soc=(st, K, mus)``: elliptic contact triples
    [n(K), t1(K), t2(K)] starting at row st: the tangent pair shares one
    preconditioner scale sqrt(ds_t1 * ds_t2), the cone opening becomes
    mu' = mu * ds_t / ds_n, and the projection is the closed-form
    second-order-cone projection instead of the nonnegative clamp."""
    C, nv = J.shape[-2], J.shape[-1]
    lowb = [[None if x is None else x.unsqueeze(-1) for x in row]
            for row in low]
    minv_jt = torch.stack(
        _chol_solve_comp(lowb, [J[..., d] for d in range(nv)]), dim=-1)
    diag = torch.sum(J * minv_jt, dim=-1)
    ds = torch.sqrt(torch.clamp(diag + reg, min=1e-12))
    if soc is not None:
        st, K, mus = soc
        ds_n = ds[..., st:st + K]
        ds_t = torch.sqrt(ds[..., st + K:st + 2 * K]
                          * ds[..., st + 2 * K:st + 3 * K])
        ds = torch.cat([ds[..., :st + K], ds_t, ds_t,
                        ds[..., st + 3 * K:]], dim=-1)
        mu_g = torch.tensor(mus, dtype=ds.dtype, device=ds.device) \
            * ds_t / ds_n

    def op(x):     # preconditioned operator D^-1/2 (A + R) D^-1/2
        u = x / ds
        w = torch.sum(minv_jt * u.unsqueeze(-1), dim=-2)
        return (torch.sum(J * w.unsqueeze(-2), dim=-1) + reg * u) / ds

    def norm(x):
        return torch.clamp(torch.sqrt(torch.sum(x * x, dim=-1)), min=1e-12)

    x = active / norm(active).unsqueeze(-1)
    lmax = torch.ones_like(ds[..., 0])
    for _ in range(POWER_ITERS):
        w = op(x)
        lmax = norm(w)
        x = w / lmax.unsqueeze(-1)
    el = torch.clamp(1.1 * lmax, min=1e-8).unsqueeze(-1)

    rhs = (aref - torch.sum(J * a0.unsqueeze(-2), dim=-1)) / ds
    mu0 = lam0 * active * ds

    def project(z):
        """Nonnegative clamp, except elliptic triples, which go through
        the closed-form SOC projection (a negative normal iterate can
        still project to a nonzero impulse)."""
        if soc is None:
            return torch.clamp(z, min=0.0) * active
        n_i = z[..., st:st + K]
        t1_i = z[..., st + K:st + 2 * K]
        t2_i = z[..., st + 2 * K:st + 3 * K]
        s = torch.sqrt(t1_i * t1_i + t2_i * t2_i)
        inside = s <= mu_g * n_i
        below = mu_g * s <= -n_i
        c = (mu_g * s + n_i) / (1.0 + mu_g * mu_g)
        zeros, ones = torch.zeros_like(c), torch.ones_like(c)
        n_p = torch.where(inside, n_i, torch.where(below, zeros, c))
        tsc = torch.where(inside, ones, torch.where(
            below, zeros, mu_g * c / torch.clamp(s, min=1e-30)))
        z = torch.cat([torch.clamp(z[..., :st], min=0.0), n_p, t1_i * tsc,
                       t2_i * tsc,
                       torch.clamp(z[..., st + 3 * K:], min=0.0)], dim=-1)
        return z * active

    mu, y = mu0, mu0
    t = torch.ones_like(lmax)
    for _ in range(sweeps):
        g = op(y) - rhs
        mu_new = project(y - g / el)
        # adaptive restart (gradient test): kill momentum when the
        # momentum direction opposes descent
        restart = torch.sum((y - mu_new) * (mu_new - mu), dim=-1) > 0
        t = torch.where(restart, torch.ones_like(t), t)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        mom = torch.where(restart, torch.zeros_like(t), (t - 1.0) / t_new)
        y = mu_new + mom.unsqueeze(-1) * (mu_new - mu)
        mu, t = mu_new, t_new
    lam = mu / ds
    return a0 + torch.sum(minv_jt * lam.unsqueeze(-1), dim=-2), lam


def _contact_qacc(p: PlanarParams, qpos, qvel, ctrl, lam0, sweeps):
    """Constrained acceleration -> (qacc (..., nv), a0 (..., nv),
    lam (..., C), m (upper-triangle dict of components), qfrc (..., nv))."""
    nv = p.nv
    q = [qpos[..., d] for d in range(nv)]
    v = [qvel[..., d] for d in range(nv)]
    u = [ctrl[..., i] for i in range(len(p.actuators))]
    m, qfrc, ctx = _planar_smooth(p, q, v, u)
    zero = torch.zeros_like(q[0])
    # structurally constant slots of M are python floats
    m = {k: (x if torch.is_tensor(x) else zero + x) for k, x in m.items()}
    low = _chol_factor_comp(m, nv)
    a0 = torch.stack(_chol_solve_comp(low, qfrc), dim=-1)
    J, aref_pos, brow, active, reg = _constraint_rows(p, ctx, q, v)
    aref = aref_pos - brow * torch.sum(J * qvel.unsqueeze(-2), dim=-1)
    qacc, lam = _solve_qacc(low, a0, J, aref, active, reg, lam0, sweeps,
                            soc=_planar_soc(p))
    return qacc, a0, lam, m, torch.stack(qfrc, dim=-1)


def planar_contact_step_n(p: PlanarParams, qpos, qvel, ctrl, n: int):
    """One control step (``n`` substeps) for contact/RK4 planar models on
    (..., nv)/(..., nu) tensors.  Implicit-solver semantics: Euler
    integrates smooth + constraint force with M + h diag(B); RK4 uses the
    constrained qacc directly, rebuilding the rows at every stage;
    impulses warm-start across substeps and stages (``SWEEPS`` for the
    first solve of the step, ``SWEEPS_WARM`` after)."""
    h = p.timestep
    nv = p.nv
    lam = torch.zeros(qpos.shape[:-1] + (n_planar_rows(p),),
                      dtype=qpos.dtype, device=qpos.device)
    sweeps = SWEEPS

    if p.integrator == EULER:
        for _ in range(n):
            qacc_c, a0, lam, m, qf = _contact_qacc(p, qpos, qvel, ctrl, lam,
                                                   sweeps)
            sweeps = SWEEPS_WARM
            dqa = qacc_c - a0
            qfrc_con = _m_matvec_comp(m, [dqa[..., d] for d in range(nv)],
                                      nv)
            md = dict(m)
            for d in range(nv):
                md[(d, d)] = md[(d, d)] + h * p.damping[d]
            low2 = _chol_factor_comp(md, nv)
            qacc = torch.stack(_chol_solve_comp(
                low2, [qf[..., d] + qfrc_con[d] for d in range(nv)]), dim=-1)
            qvel = qvel + h * qacc
            qpos = qpos + h * qvel
        return qpos, qvel

    for _ in range(n):
        k1v, _, lam, _, _ = _contact_qacc(p, qpos, qvel, ctrl, lam, sweeps)
        sweeps = SWEEPS_WARM
        k1p = qvel
        k2p = qvel + 0.5 * h * k1v
        k2v, _, lam, _, _ = _contact_qacc(p, qpos + 0.5 * h * k1p, k2p, ctrl,
                                          lam, sweeps)
        k3p = qvel + 0.5 * h * k2v
        k3v, _, lam, _, _ = _contact_qacc(p, qpos + 0.5 * h * k2p, k3p, ctrl,
                                          lam, sweeps)
        k4p = qvel + h * k3v
        k4v, _, lam, _, _ = _contact_qacc(p, qpos + h * k3p, k4p, ctrl, lam,
                                          sweeps)
        qpos = qpos + h * (k1p + 2 * k2p + 2 * k3p + k4p) / 6.0
        qvel = qvel + h * (k1v + 2 * k2v + 2 * k3v + k4v) / 6.0
    return qpos, qvel


# ---------------------------------------------------------------------------
# array-facing wrapper ((..., nv) tensors, batch leading)
# ---------------------------------------------------------------------------

def step_n_arrays(p: PlanarParams, qpos, qvel, ctrl, n: int):
    """(..., nv), (..., nv), (..., nu) tensors -> stepped (..., nv) x2.

    Contact-bearing or RK4 models take the stacked dual path; smooth Euler
    chains (swimmer) take the pure component path, one tensor per
    coordinate."""
    if needs_contact_path(p):
        return planar_contact_step_n(p, qpos, qvel, ctrl, n)
    q = [qpos[..., d] for d in range(p.nv)]
    v = [qvel[..., d] for d in range(p.nv)]
    u = [ctrl[..., i] for i in range(len(p.actuators))]
    q2, v2 = planar_step_n(p, q, v, u, n)
    return torch.stack(q2, dim=-1), torch.stack(v2, dim=-1)
