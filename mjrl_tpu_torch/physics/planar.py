"""Planar-chain fast path: specialized dynamics for swimmer-class models.

Counterpart of ``mjrl_tpu/physics/planar.py``.  The full pipeline — FK, CRB
mass matrix, Coriolis bias, the MuJoCo inertia-box fluid model, implicit
joint limits, actuation, semi-implicit Euler — specialized to trees moving
in a plane: 3-component spatial algebra (omega_z, vx, vy), angles instead
of quaternions, static unrolling over the (tiny) chain.

``extract_planar`` (pure numpy, host side) checks applicability statically
and returns a ``PlanarParams`` or None.

The dynamics are written in SHAPE-AGNOSTIC component style: all state is
lists of equally shaped tensors, every op elementwise.  With ``(B,)``
components this file is the PLAIN PYTORCH VERSION of the hand-written CUDA
kernel in ``csrc/planar_body.cuh`` (bound in ``ops/cuda_planar.py``): the
CPU tests run it, CPU tensors are stepped by it, and the kernel is held
against it on the GPU.

Ported: the smooth Euler branch (swimmer).  The contact / RK4 branch
(hopper, walker2d, half-cheetah) raises ``NotImplementedError`` — K2,
ROADMAP.md queue 2.
"""

from typing import NamedTuple, Tuple

import numpy as np
import torch

from mjrl_tpu_torch.physics.model import (CAPSULE, ELLIPTIC as ELLIPTIC_CONE,
                                          EULER, HINGE, PGS, PLANE, RK4,
                                          SLIDE, SPHERE, Model)


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


def extract_planar(model: Model):
    """PlanarParams if the model is a supported planar tree, else None.

    Only implicit-solver (``solver="newton"``) models qualify: the fast
    path implements MuJoCo's soft-constraint limit/contact response
    (the exact dual QP), not the penalty approximation.

    Supported: a root body with two axis-aligned slides + one hinge
    (any of the three coordinate planes; the gym locomotion suite's
    (x, z)/hinge-y and the swimmer's (x, y)/hinge-z both qualify),
    descendant bodies with one hinge each about +-the plane normal
    (anchors may be off-origin), branching trees, in-plane gravity,
    joint springs, Euler or RK4, and ground contacts (plane-sphere,
    plane-capsule end caps, capsule-capsule)."""
    if model.solver != PGS or model.integrator not in (EULER, RK4):
        return None
    cone = int(getattr(model, "cone", 0))
    if model.nq != model.nv or model.nbody < 2 or model.ntendon \
            or model.neq:
        return None
    # dof dry friction (frictionloss rows) and limit margins are only
    # implemented in the general solver — such models must not diverge
    # between engines
    if model.dof_frictionloss is not None \
            and (np.asarray(model.dof_frictionloss) > 0).any():
        return None
    if model.dof_margin is not None \
            and (np.asarray(model.dof_margin) > 0).any():
        return None
    jt = list(model.jnt_type)
    axes = np.asarray(model.jnt_axis)
    jpos3 = np.asarray(model.jnt_pos)
    if len(model.body_jnts[1]) != 3:
        return None
    j0, j1, j2 = model.body_jnts[1]
    if not (jt[j0] == SLIDE and jt[j1] == SLIDE and jt[j2] == HINGE):
        return None
    sa0, sa1, ha = axes[j0], axes[j1], axes[j2]
    eye = np.eye(3)
    def axis_id(a):
        for k in range(3):
            if np.allclose(a, eye[k]):
                return k
        return None
    i0, i1 = axis_id(sa0), axis_id(sa1)
    ih = axis_id(ha)
    if i0 is None or i1 is None or ih is None or ih in (i0, i1):
        return None
    if model.jnt_dofadr[j0] != 0 or model.jnt_dofadr[j1] != 1:
        return None
    # basis (e1, e2) with e1 x e2 = hinge axis
    cross = np.cross(eye[i0], eye[i1])
    if np.allclose(cross, eye[ih]):
        ax1, ax2 = i0, i1
        slide_dirs = ((1.0, 0.0), (0.0, 1.0))
    elif np.allclose(-cross, eye[ih]):
        ax1, ax2 = i1, i0
        slide_dirs = ((0.0, 1.0), (1.0, 0.0))
    else:
        return None
    e1, e2, h3 = eye[ax1], eye[ax2], eye[ih]
    if np.linalg.norm(jpos3[j2]) > 1e-6:
        return None

    def to2d(v):
        return (float(v[ax1]), float(v[ax2]))

    body_dof = [model.jnt_dofadr[j2]]
    parent = [-1]
    hinge_sign = [1.0]
    jpos2 = [(0.0, 0.0)]
    dof_ref = np.asarray(model.dof_ref)
    for b in range(2, model.nbody):
        pb = model.body_parent[b]
        if pb < 1:
            return None
        if len(model.body_jnts[b]) != 1:
            return None
        j = model.body_jnts[b][0]
        if jt[j] != HINGE:
            return None
        if np.allclose(axes[j], h3):
            hinge_sign.append(1.0)
        elif np.allclose(axes[j], -h3):
            hinge_sign.append(-1.0)
        else:
            return None
        if abs(float(jpos3[j] @ h3)) > 1e-6:
            return None
        if abs(float(dof_ref[model.jnt_dofadr[j]])) > 1e-9:
            return None
        jpos2.append(to2d(jpos3[j]))
        body_dof.append(model.jnt_dofadr[j])
        parent.append(pb - 1)
    bp = np.asarray(model.body_pos)
    bq = np.asarray(model.body_quat)
    ip = np.asarray(model.body_ipos)
    # child offsets/all CoMs in-plane, frames unrotated.  The ROOT's
    # out-of-plane offset is a constant shift with no planar dynamics
    # (swimmer's torso sits at z=0.03) — but it must be folded into
    # plane-contact heights, so keep it.
    root_oop = float(bp[1] @ h3)
    if np.abs(bp[2:] @ h3).max(initial=0.0) > 1e-6 \
            or np.abs(ip[1:] @ h3).max(initial=0.0) > 1e-6:
        return None
    for b in range(1, model.nbody):
        if not np.allclose(bq[b], [1.0, 0, 0, 0], atol=1e-9):
            return None

    g3 = np.asarray(model.gravity)
    gravity2 = to2d(g3)

    # inertial-frame constants
    def np_quat_mat(q):
        w, x, y, z = q / np.linalg.norm(q)
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x),
             2 * (x * x + y * y) * -1 + 1]])

    iq = np.asarray(model.body_iquat)
    inertia = np.asarray(model.body_inertia)
    mass = np.asarray(model.body_mass)
    r0s, ihh, boxes = [], [], []
    for b in range(1, model.nbody):
        r0 = np_quat_mat(np.asarray(iq[b], np.float64))
        iw = r0 @ np.diag(inertia[b]) @ r0.T
        # the hinge axis must be principal-ish for I_hh constancy
        off = abs(iw[ax1, ih]) + abs(iw[ax2, ih])
        if off > 1e-6 * max(iw[ih, ih], 1e-9):
            return None
        ihh.append(float(iw[ih, ih]))
        r0s.append(r0)
        ia, ib, ic = inertia[b]
        m = max(float(mass[b]), 1e-12)
        boxes.append([
            float(0.5 * np.sqrt(max(6.0 * (ib + ic - ia) / m, 1e-12))),
            float(0.5 * np.sqrt(max(6.0 * (ia + ic - ib) / m, 1e-12))),
            float(0.5 * np.sqrt(max(6.0 * (ia + ib - ic) / m, 1e-12)))])

    h = float(model.timestep)
    solref = np.asarray(model.dof_solref)
    solimp = np.asarray(model.dof_solimp)
    # implicit-solver constants (solver.py _kb): tc floored at 2*timestep,
    # dmax from solimp
    tc = np.maximum(solref[:, 0], 2.0 * h)
    dr = solref[:, 1]
    dmax = solimp[:, 1]
    limit_k = 1.0 / np.maximum(dmax * dmax * tc * tc * dr * dr, 1e-12)
    limit_b = 2.0 / np.maximum(dmax * tc, 1e-12)
    rng = np.asarray(model.dof_range)
    acts = []
    for i, j in enumerate(model.actuator_joint):
        if not model.actuator_simple:
            return None
        acts.append((int(model.jnt_dofadr[j]),
                     float(np.asarray(model.gear)[i]),
                     float(np.asarray(model.ctrlrange)[i, 0]),
                     float(np.asarray(model.ctrlrange)[i, 1]),
                     float(np.asarray(model.ctrllimited)[i])))

    # ---- contact candidates (static): supported pair types only ------
    gtypes = list(model.geom_type)
    gbody = list(model.geom_body)
    gpos = np.asarray(model.geom_pos)
    gquat = np.asarray(model.geom_quat)
    gsize = np.asarray(model.geom_size)
    gfric = np.asarray(model.geom_friction)
    gsolref = np.asarray(model.geom_solref)
    gsolimp = np.asarray(model.geom_solimp)
    biw = np.asarray(model.body_invweight0)

    def geom_axis_b(g):
        return np_quat_mat(np.asarray(gquat[g], np.float64))[:, 2]

    def cap_ends_2d(g):
        """capsule endpoint centers in the body frame, 2D; None if the
        axis leaves the plane."""
        a = geom_axis_b(g)
        if abs(float(a @ h3)) > 1e-6:
            return None
        half = float(gsize[g, 1])
        p = gpos[g]
        return [to2d(p - half * a), to2d(p + half * a)], float(gsize[g, 0])

    def combine(ga, gb):
        tcc = max(0.5 * float(gsolref[ga, 0] + gsolref[gb, 0]), 2.0 * h)
        drc = 0.5 * float(gsolref[ga, 1] + gsolref[gb, 1])
        si = tuple(0.5 * float(gsolimp[ga, k] + gsolimp[gb, k])
                   for k in range(5))
        dmaxc = si[1]
        kc = 1.0 / max(dmaxc * dmaxc * tcc * tcc * drc * drc, 1e-12)
        bc = 2.0 / max(dmaxc * tcc, 1e-12)
        mu = max(float(gfric[ga, 0]), float(gfric[gb, 0]))
        return kc, bc, si, mu

    contacts_pt, contacts_cc = [], []
    # per-pair condim (aligned with contact_pairs; geom-max fallback for
    # builders predating the field).  condim 1 pairs emit ONE exact
    # frictionless row (matching the general solver — the old 4-facet
    # emission gave them friction they shouldn't have; advisor finding,
    # round 4); condim 4/6 pairs need torsional/rolling rows the fast
    # path doesn't implement, so such models take the general solver.
    # ELLIPTIC clamps 4/6 -> 3 like collision.contact_pair_condims.
    gcondim = list(model.geom_condim)
    pair_cds = (list(model.contact_pair_condim)
                if model.contact_pair_condim else
                [max(int(gcondim[a]), int(gcondim[b]))
                 for (a, b) in model.contact_pairs])
    if model.cone == ELLIPTIC_CONE:
        pair_cds = [min(cd, 3) for cd in pair_cds]
    elif any(cd in (4, 6) for cd in pair_cds):
        return None
    for (a, b), cd in zip(model.contact_pairs, pair_cds):
        ta, tb = gtypes[a], gtypes[b]
        if tb == PLANE:
            a, b = b, a
            ta, tb = tb, ta
        if ta == PLANE:
            if gbody[a] != 0:
                return None
            n3 = np_quat_mat(np.asarray(gquat[a], np.float64))[:, 2]
            if abs(float(n3 @ h3)) > 1e-6:
                return None
            up = to2d(n3)
            h0 = float(gpos[a] @ n3)
            bidx = gbody[b] - 1
            if bidx < 0:
                return None
            kc, bc, si, mu = combine(a, b)
            iw = float(biw[gbody[b], 0])
            if tb == SPHERE:
                contacts_pt.append((bidx, to2d(gpos[b]),
                                    float(gsize[b, 0]), up, h0,
                                    kc, bc, si, mu, iw, cd))
            elif tb == CAPSULE:
                ends = cap_ends_2d(b)
                if ends is None:
                    return None
                (p0, p1), r = ends
                contacts_pt.append((bidx, p0, r, up, h0, kc, bc, si,
                                    mu, iw, cd))
                contacts_pt.append((bidx, p1, r, up, h0, kc, bc, si,
                                    mu, iw, cd))
            else:
                return None
        elif ta == CAPSULE and tb == CAPSULE:
            ea = cap_ends_2d(a)
            eb = cap_ends_2d(b)
            if ea is None or eb is None:
                return None
            (pa0, pa1), ra = ea
            (pb0, pb1), rb = eb
            kc, bc, si, mu = combine(a, b)
            iw = float(biw[gbody[a], 0] + biw[gbody[b], 0])
            contacts_cc.append((gbody[a] - 1, pa0, pa1, ra,
                                gbody[b] - 1, pb0, pb1, rb,
                                kc, bc, si, mu, iw, cd))
        else:
            return None

    # capsule-capsule pairs without any ground plane (swimmer-class
    # chains): keep the round-1 pure component path, which ignores the
    # (practically unreachable) self-contacts — the cross-simulator
    # learning validation gates this approximation (docs/BENCHMARKS.md)
    if contacts_cc and not contacts_pt:
        contacts_cc = []
    # plane contacts require fully in-plane geometry (no constant
    # out-of-plane root shift, contact geoms centered in the plane)
    if contacts_pt:
        if abs(root_oop) > 1e-6:
            return None
        for (a, b) in model.contact_pairs:
            for g in (a, b):
                if gbody[g] > 0 and abs(float(gpos[g] @ h3)) > 1e-6:
                    return None

    # fluid generalization beyond the xy-plane is untested; the only
    # fluid model in the suite (swimmer) is xy
    if (float(model.viscosity) or float(model.density)) \
            and (ax1, ax2) != (0, 1):
        return None

    return PlanarParams(
        nv=model.nv, nbody=model.nbody - 1,
        offsets=tuple(to2d(bp[b]) for b in range(1, model.nbody)),
        mass=tuple(float(m) for m in mass[1:]),
        izz=tuple(ihh),
        com=tuple(to2d(ip[b]) for b in range(1, model.nbody)),
        box=tuple(tuple(bx) for bx in boxes),
        r0=tuple(tuple(tuple(float(x) for x in row) for row in r)
                 for r in r0s),
        viscosity=float(model.viscosity),
        density=float(model.density),
        damping=tuple(float(x) for x in np.asarray(model.dof_damping)),
        armature=tuple(float(x) for x in np.asarray(model.dof_armature)),
        limited=tuple(float(x) for x in np.asarray(model.dof_limited)),
        lo=tuple(float(x) for x in rng[:, 0]),
        hi=tuple(float(x) for x in rng[:, 1]),
        limit_k=tuple(float(x) for x in limit_k),
        limit_b=tuple(float(x) for x in limit_b),
        solimp=tuple(tuple(float(x) for x in row) for row in solimp),
        invweight0=tuple(float(x)
                         for x in np.asarray(model.dof_invweight0)),
        actuators=tuple(acts),
        timestep=h,
        body_dof=tuple(body_dof),
        parent=tuple(parent),
        slide_dirs=slide_dirs,
        slide_ref=(float(dof_ref[model.jnt_dofadr[j0]]),
                   float(dof_ref[model.jnt_dofadr[j1]])),
        hinge_sign=tuple(hinge_sign),
        jpos=tuple(jpos2),
        stiffness=tuple(float(x)
                        for x in np.asarray(model.dof_stiffness)),
        spring_ref=tuple(float(x) for x in dof_ref),
        gravity2=gravity2,
        ax1=int(ax1), ax2=int(ax2),
        integrator=int(model.integrator),
        contacts_pt=tuple(contacts_pt),
        contacts_cc=tuple(contacts_cc),
        cone=cone)


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
# array-facing wrapper ((..., nv) tensors, batch leading)
# ---------------------------------------------------------------------------

def step_n_arrays(p: PlanarParams, qpos, qvel, ctrl, n: int):
    """(..., nv), (..., nv), (..., nu) tensors -> stepped (..., nv) x2.

    Smooth Euler chains (swimmer) take the component path, one tensor per
    coordinate.  Contact-bearing or RK4 models are not ported yet."""
    if needs_contact_path(p):
        raise NotImplementedError("K2, ROADMAP queue 2")
    q = [qpos[..., d] for d in range(p.nv)]
    v = [qvel[..., d] for d in range(p.nv)]
    u = [ctrl[..., i] for i in range(len(p.actuators))]
    q2, v2 = planar_step_n(p, q, v, u, n)
    return torch.stack(q2, dim=-1), torch.stack(v2, dim=-1)
