"""Contact narrowphase and penalty contact forces of the general engine
(counterpart of ``mjrl_tpu/physics/collision.py``), batch-first.

Pairs are grouped statically by primitive type (``_grouped_pairs``, the
JAX package's ``_GROUP_ORDER`` and per-pair slot expansion), and each
group is evaluated on (B, n, 3) tensors.  The JAX package keeps every
component in its own array because a TPU pads the minor axis to 128
lanes; the port has no such padding and gathers into (B, C, 3) tensors.

Supported primitive pairs, each emitting a fixed number of slots:
- sphere-plane and capsule-plane (one slot per end cap);
- sphere-box; capsule-box, a 2-slot manifold at the ends of the segment
  clipped to the contact face (24-trip ternary search for the deepest
  point, MuJoCo mjc_CapsuleBox semantics as the JAX package probes them);
- cylinder-box by 5 spheres sampled along the axis;
- box-box, a 4-slot face manifold (edge-edge cases approximated by the
  nearest face, as in the JAX package);
- capsule-capsule, capsule-sphere and sphere-sphere by closest points.
Any other pair (plane-box, meshes) is skipped, as the JAX package skips it.
A slot's depth > 0 means active; depths include the pair's summed margins.
"""

from types import SimpleNamespace

import numpy as np
import torch

from mjrl_tpu_torch.physics import math as pm
from mjrl_tpu_torch.physics.kinematics import ancestor_mask, geom_frames, \
    model_tables
from mjrl_tpu_torch.physics.model import (BOX, CAPSULE, CYLINDER, ELLIPTIC,
                                          EULER, PLANE, SPHERE, Model)

# samples along cylinder axes for box contacts
_AXIS_SAMPLES = 5

# trips of the capsule-box ternary search
_TERNARY_TRIPS = 24

# penetration width where the penalty normal response saturates (m)
CONTACT_WIDTH = 0.02

_GROUP_ORDER = ("plane_sphere", "plane_capsule", "box_sphere",
                "box_capsule", "box_axis", "box_box",
                "capsule_sphere", "capsule_capsule", "sphere_sphere")


def _grouped_pairs(model: Model):
    """Split contact_pairs into per-primitive groups (host side, static):
    dict of lists of (g1, g2, pair_idx, k) with g1 the plane/box/capsule
    reference geom and k the slot within the pair's manifold."""
    groups = {k: [] for k in _GROUP_ORDER}
    for pi, (a, b) in enumerate(model.contact_pairs):
        ta, tb = model.geom_type[a], model.geom_type[b]
        if (tb == PLANE) or (tb == BOX and ta != PLANE) or \
           (tb in (CAPSULE, CYLINDER) and ta == SPHERE):
            a, b = b, a
            ta, tb = tb, ta
        if ta == PLANE and tb == SPHERE:
            groups["plane_sphere"].append((a, b, pi, 0))
        elif ta == PLANE and tb in (CAPSULE, CYLINDER):
            for k in (0, 1):        # one contact per end cap
                groups["plane_capsule"].append((a, b, pi, k))
        elif ta == BOX and tb == SPHERE:
            groups["box_sphere"].append((a, b, pi, 0))
        elif ta == BOX and tb == CAPSULE:
            for k in (0, 1):
                groups["box_capsule"].append((a, b, pi, k))
        elif ta == BOX and tb == CYLINDER:
            for k in range(_AXIS_SAMPLES):
                groups["box_axis"].append((a, b, pi, k))
        elif ta == BOX and tb == BOX:
            for k in range(4):
                groups["box_box"].append((a, b, pi, k))
        elif ta in (CAPSULE, CYLINDER) and tb == SPHERE:
            groups["capsule_sphere"].append((a, b, pi, 0))
        elif ta == CAPSULE and tb == CAPSULE:
            groups["capsule_capsule"].append((a, b, pi, 0))
        elif ta == SPHERE and tb == SPHERE:
            groups["sphere_sphere"].append((a, b, pi, 0))
    return groups


def _emitted(model: Model):
    """Every emitted slot in ``find_contacts`` order: (g1, g2, pair_idx,
    k) tuples."""
    groups = _grouped_pairs(model)
    return [p for key in _GROUP_ORDER for p in groups[key]]


def contact_geom_ids(model: Model):
    """Static (g1, g2) int arrays in ``find_contacts``' emission order."""
    slots = _emitted(model)
    return (np.array([p[0] for p in slots], np.int32),
            np.array([p[1] for p in slots], np.int32))


def contact_pair_condims(model: Model):
    """Static per-slot condim, aligned with ``find_contacts`` (from the
    per-pair condim table; the elliptic cone clamps 4 and 6 to 3)."""
    cd = model.contact_pair_condim
    out = np.array([cd[p[2]] for p in _emitted(model)], np.int32)
    return np.minimum(out, 3) if model.cone == ELLIPTIC else out


def _tables(model: Model, dtype, device):
    """The static slot tables of a model, built once with its other
    tables: per group its geom ids and slot numbers; per slot the body ids
    of both sides and the (C, nv) chain coefficients."""
    t = model_tables(model, dtype, device)
    if hasattr(t, "pairs"):
        return t.pairs
    ids = lambda x: torch.tensor(np.asarray(x, np.int64), device=device)
    groups = {}
    for key, lst in _grouped_pairs(model).items():
        if lst:
            groups[key] = SimpleNamespace(
                i1=ids([p[0] for p in lst]), i2=ids([p[1] for p in lst]),
                k=torch.tensor([float(p[3]) for p in lst], dtype=dtype,
                               device=device),
                ki=ids([p[3] for p in lst]))
    g1, g2 = contact_geom_ids(model)
    gb = np.asarray(model.geom_body, np.int64)
    mask = ancestor_mask(model).astype(np.float64)
    t.pairs = SimpleNamespace(
        groups=groups, g1=ids(g1), g2=ids(g2), b1=ids(gb[g1]),
        b2=ids(gb[g2]),
        cf=torch.tensor(mask[gb[g2]] - mask[gb[g1]], dtype=dtype,
                        device=device).reshape(len(g1), model.nv))
    return t.pairs


# ---------------------------------------------------------------------------
# primitives: each returns (depth (B, n), point (B, n, 3), normal
# (B, n, 3)); depth > 0 penetrates, the normal points from geom1 into geom2
# ---------------------------------------------------------------------------

def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _norm(a):
    return torch.sqrt(_dot(a, a) + 1e-24)


def _sphere_plane(c, r, p0, n):
    d = _dot(c - p0, n)
    depth = r - d
    # MuJoCo convention: contact point midway between the two surfaces
    return depth, c - n * (0.5 * (d + r)).unsqueeze(-1), n


def _sphere_box(c, r, m, bpos, bs):
    """Spheres (centres c, radii r) against oriented boxes (rotations m,
    centres bpos, half-sizes bs (n, 3))."""
    cl = pm.mat_t_vec(m, c - bpos)
    q = torch.maximum(torch.minimum(cl, bs), -bs)
    e = cl - q
    dist = _norm(e)
    inside = (torch.abs(cl) <= bs).all(-1)
    slack = bs - torch.abs(cl)
    m0, m1, m2 = slack[..., 0], slack[..., 1], slack[..., 2]
    use0 = (m0 <= m1) & (m0 <= m2)
    use1 = ~use0 & (m1 <= m2)
    use2 = ~(use0 | use1)
    sgn = torch.sign(cl) + (cl == 0).to(cl.dtype)
    n_in = torch.stack([use0, use1, use2], dim=-1).to(cl.dtype) * sgn
    n_loc = torch.where(inside.unsqueeze(-1), n_in,
                        e / dist.unsqueeze(-1))
    m_min = torch.minimum(m0, torch.minimum(m1, m2))
    depth = torch.where(inside, r + m_min, r - dist)
    # midway between the box surface (for an inside centre: its projection
    # onto the nearest face) and the sphere surface
    p_ref = torch.where(inside.unsqueeze(-1),
                        cl + n_loc * m_min.unsqueeze(-1), q)
    p_loc = p_ref - n_loc * (0.5 * depth).unsqueeze(-1)
    return depth, pm.mat_vec(m, p_loc) + bpos, pm.mat_vec(m, n_loc)


def _capsule_box_ends(gx, gm, size, i1, i2):
    """Clipped-segment ends of capsule(i2)-box(i1) slots -> (tlo, thi,
    a_w, seg_w): the two segment parameters and the world segment (origin,
    direction).  The contact face is the one nearest the deepest segment
    point (24-trip ternary search); the segment is clipped to that face's
    rectangle."""
    half = size[i2, 1].unsqueeze(-1)
    bpos = gx[:, i1]
    bm = gm[:, i1]
    bs = size[i1]
    axis = gm[:, i2, :, 2]
    cw = gx[:, i2]
    a_w = cw - axis * half
    b_w = cw + axis * half
    al = pm.mat_t_vec(bm, a_w - bpos)
    d = pm.mat_t_vec(bm, b_w - a_w)

    def phi(t):
        """Signed distance of the segment point t to the box surface."""
        p = al + t.unsqueeze(-1) * d
        q = torch.maximum(torch.minimum(p, bs), -bs)
        e = p - q
        sl = bs - torch.abs(p)
        m = torch.minimum(torch.minimum(sl[..., 0], sl[..., 1]), sl[..., 2])
        return torch.where(m >= 0, -m, torch.sqrt(_dot(e, e) + 1e-24))

    lo = torch.zeros_like(al[..., 0])
    hi = 1.0 - lo
    for _ in range(_TERNARY_TRIPS):
        t1 = lo + (hi - lo) / 3.0
        t2 = hi - (hi - lo) / 3.0
        take = phi(t1) > phi(t2)
        lo, hi = torch.where(take, t1, lo), torch.where(take, hi, t2)
    ts = 0.5 * (lo + hi)

    # the contact face at the deepest point: inside -> the min-slack axis,
    # outside -> the clamp residual's largest axis
    p = al + ts.unsqueeze(-1) * d
    q = torch.maximum(torch.minimum(p, bs), -bs)
    e = p - q
    slack = bs - torch.abs(p)
    inside = (slack >= 0).all(-1)
    kidx = torch.where(inside, torch.argmin(slack, dim=-1),
                       torch.argmax(torch.abs(e), dim=-1))

    # clip the segment's t-interval to the face rectangle of the two
    # non-normal axes
    tlo = torch.zeros_like(ts)
    thi = torch.ones_like(ts)
    for j in range(3):
        dj, alj, sj = d[..., j], al[..., j], bs[:, j]
        degen = torch.abs(dj) <= 1e-12
        safe = torch.where(degen, torch.ones_like(dj), dj)
        ta = (-sj - alj) / safe
        tb = (sj - alj) / safe
        inside_j = (torch.abs(alj) <= sj).to(ts.dtype)
        jlo = torch.where(degen, 1.0 - inside_j, torch.minimum(ta, tb))
        jhi = torch.where(degen, inside_j, torch.maximum(ta, tb))
        skip = kidx == j
        tlo = torch.where(skip, tlo, torch.maximum(tlo, jlo))
        thi = torch.where(skip, thi, torch.minimum(thi, jhi))
    tlo = torch.clamp(tlo, 0.0, 1.0)
    thi = torch.clamp(thi, 0.0, 1.0)
    bad = thi < tlo
    return (torch.where(bad, ts, tlo), torch.where(bad, ts, thi), a_w,
            b_w - a_w)


def _box_box_manifold(gx, gm, size, i1, i2):
    """4-slot box-box face manifold -> [(depth, point, normal)] * 4.

    The reference face is the least-overlapping face axis over both boxes
    (edge-edge winners are approximated by the nearest face); the 4
    contacts are the incident face's corners clamped into the reference
    rectangle, each with its own depth along the reference normal and the
    surface-midpoint position convention."""
    p1c, p2c = gx[:, i1], gx[:, i2]
    m1, m2 = gm[:, i1], gm[:, i2]
    s1, s2 = size[i1], size[i2]
    dpc = p2c - p1c

    def col(m, k):
        return m[..., :, k]

    def sel_axis(m, kidx):
        return torch.gather(m, -1, kidx[..., None, None].expand(
            m.shape[:-1] + (1,))).squeeze(-1)

    def sel_size(s, kidx):
        return torch.gather(s.expand(kidx.shape + (3,)), -1,
                            kidx.unsqueeze(-1)).squeeze(-1)

    def face_overlap(mr, sr, mo, so, dvec):
        """Min face-axis overlap of the reference box against the other
        -> (overlap, axis index); dvec = other centre - reference centre."""
        overls = []
        for k in range(3):
            u = col(mr, k)
            rb = sum(so[:, j] * torch.abs(_dot(u, col(mo, j)))
                     for j in range(3))
            overls.append(sr[:, k] + rb - torch.abs(_dot(dvec, u)))
        st = torch.stack(overls, dim=-1)
        return torch.min(st, dim=-1).values, torch.argmin(st, dim=-1)

    def manifold(mr, sr, mo, so, rc, oc, dvec):
        _, kidx = face_overlap(mr, sr, mo, so, dvec)
        u = sel_axis(mr, kidx)
        du = _dot(dvec, u)
        sgn = torch.sign(du) + (du == 0).to(du.dtype)
        n = u * sgn.unsqueeze(-1)                # reference face normal
        sk = sel_size(sr, kidx)
        # incident face of the other box: its most anti-parallel axis
        dots = torch.stack([_dot(n, col(mo, j)) for j in range(3)], dim=-1)
        midx = torch.argmax(torch.abs(dots), dim=-1)
        vm = sel_axis(mo, midx)
        dm = torch.gather(dots, -1, midx.unsqueeze(-1)).squeeze(-1)
        sm = -(torch.sign(dm) + (dm == 0).to(dm.dtype))
        szm = sel_size(so, midx)
        aidx = torch.where(midx == 0, 1, 0)
        bidx = torch.where(midx == 2, 1, 2)
        va, vb = sel_axis(mo, aidx), sel_axis(mo, bidx)
        sza, szb = sel_size(so, aidx), sel_size(so, bidx)
        fc = oc + vm * (sm * szm).unsqueeze(-1)  # incident face centre
        normal_k = (torch.arange(3, device=kidx.device)
                    == kidx.unsqueeze(-1))
        out = []
        for sa in (-1.0, 1.0):
            for sb in (-1.0, 1.0):
                corner = fc + (va * (sa * sza).unsqueeze(-1)
                               + vb * (sb * szb).unsqueeze(-1))
                pl = pm.mat_t_vec(mr, corner - rc)
                # clamp the in-plane coordinates into the reference face
                pl = torch.where(normal_k, pl, torch.maximum(
                    torch.minimum(pl, sr), -sr))
                nc = torch.gather(pl, -1, kidx.unsqueeze(-1)).squeeze(-1)
                depth = sk - sgn * nc
                # halfway between the corner and the reference face plane
                mid = sgn * (sk - 0.5 * depth)
                pw = torch.where(normal_k, mid.unsqueeze(-1), pl)
                out.append((depth, pm.mat_vec(mr, pw) + rc, n))
        return out

    ov1, _ = face_overlap(m1, s1, m2, s2, dpc)
    ov2, _ = face_overlap(m2, s2, m1, s1, -dpc)
    man1 = manifold(m1, s1, m2, s2, p1c, p2c, dpc)
    man2 = manifold(m2, s2, m1, s1, p2c, p1c, -dpc)
    use1 = ov1 <= ov2
    u3 = use1.unsqueeze(-1)
    # the emitted normal points from geom i1 into i2: flip reference-i2
    return [(torch.where(use1, d1, d2), torch.where(u3, pt1, pt2),
             torch.where(u3, n1, -n2))
            for (d1, pt1, n1), (d2, pt2, n2) in zip(man1, man2)]


def _capsule_capsule(a1, b1, r1, a2, b2, r2):
    """Closest points of segments (a1, b1) and (a2, b2) with radii."""
    d1 = b1 - a1
    d2 = b2 - a2
    r = a1 - a2
    a = _dot(d1, d1) + 1e-12
    e = _dot(d2, d2) + 1e-12
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b
    ok = torch.abs(denom) > 1e-12
    s = torch.where(ok, torch.clamp(
        (b * f - c * e) / torch.where(ok, denom, torch.ones_like(denom)),
        0.0, 1.0), torch.zeros_like(denom))
    t = torch.clamp((b * s + f) / e, 0.0, 1.0)
    s = torch.clamp((b * t - c) / a, 0.0, 1.0)
    c1 = a1 + d1 * s.unsqueeze(-1)
    c2 = a2 + d2 * t.unsqueeze(-1)
    d = c2 - c1
    dist = _norm(d)
    n = d / dist.unsqueeze(-1)
    point = 0.5 * ((c1 + n * r1.unsqueeze(-1))
                   + (c2 - n * r2.unsqueeze(-1)))
    return (r1 + r2) - dist, point, n


def find_contacts(model: Model, data):
    """Every emitted slot of a batch -> (depths (B, C), point (B, C, 3),
    normal (B, C, 3), g1 (C,), g2 (C,)) with g1/g2 long tensors of geom
    ids.  ``data`` is a kinematics ``Data`` (its geom frames are taken here
    when absent)."""
    p = _tables(model, data.xpos.dtype, data.xpos.device)
    if data.geom_xpos is None:
        gx, gm = geom_frames(model, data)
    else:
        gx, gm = data.geom_xpos, data.geom_xmat
    size = model_tables(model, gx.dtype, gx.device).geom_size
    G = p.groups
    out = []
    if "plane_sphere" in G:
        g = G["plane_sphere"]
        out.append(_sphere_plane(gx[:, g.i2], size[g.i2, 0], gx[:, g.i1],
                                 gm[:, g.i1, :, 2]))
    if "plane_capsule" in G:
        g = G["plane_capsule"]
        sgn = 2.0 * g.k - 1.0               # end 0 -> -axis, end 1 -> +axis
        c = gx[:, g.i2] + gm[:, g.i2, :, 2] * (sgn * size[g.i2, 1]
                                               ).unsqueeze(-1)
        out.append(_sphere_plane(c, size[g.i2, 0], gx[:, g.i1],
                                 gm[:, g.i1, :, 2]))
    if "box_sphere" in G:
        g = G["box_sphere"]
        out.append(_sphere_box(gx[:, g.i2], size[g.i2, 0], gm[:, g.i1],
                               gx[:, g.i1], size[g.i1]))
    if "box_capsule" in G:
        g = G["box_capsule"]
        tlo, thi, a_w, seg_w = _capsule_box_ends(gx, gm, size, g.i1, g.i2)
        bm, bpos, bs, r_c = gm[:, g.i1], gx[:, g.i1], size[g.i1], \
            size[g.i2, 0]
        end = lambda t: a_w + seg_w * t.unsqueeze(-1)
        d, pt, n = _sphere_box(end(torch.where(g.k == 0, tlo, thi)), r_c,
                               bm, bpos, bs)
        # both end depths, for MuJoCo's deep-contact rule
        d_lo = _sphere_box(end(tlo), r_c, bm, bpos, bs)[0]
        d_hi = _sphere_box(end(thi), r_c, bm, bpos, bs)[0]
        # suppress a slot when the clip interval collapsed (both slots
        # name one point; slot 0 stays) or when the deeper end's centre is
        # inside the box (a single contact at the deepest end)
        collapse = thi - tlo < 1e-9
        submerged = torch.maximum(d_lo, d_hi) > r_c
        hi_deeper = d_hi > d_lo
        d = torch.where((g.k == 0) & submerged & hi_deeper, -1.0, d)
        d = torch.where((g.k == 1) & (collapse | (submerged & ~hi_deeper)),
                        -1.0, d)
        out.append((d, pt, n))
    if "box_axis" in G:
        g = G["box_axis"]
        t = 2.0 * g.k / (_AXIS_SAMPLES - 1) - 1.0       # [-1, 1]
        c = gx[:, g.i2] + gm[:, g.i2, :, 2] * (t * size[g.i2, 1]
                                               ).unsqueeze(-1)
        out.append(_sphere_box(c, size[g.i2, 0], gm[:, g.i1], gx[:, g.i1],
                               size[g.i1]))
    if "box_box" in G:
        g = G["box_box"]
        man = _box_box_manifold(gx, gm, size, g.i1, g.i2)
        ki = g.ki
        d = torch.stack([m[0] for m in man], -1)
        d = torch.gather(d, -1, ki.expand(d.shape[:-1]).unsqueeze(-1))
        pick = lambda j: torch.gather(
            torch.stack([m[j] for m in man], -1), -1,
            ki[:, None, None].expand(man[0][j].shape + (1,))).squeeze(-1)
        out.append((d.squeeze(-1), pick(1), pick(2)))
    if "capsule_sphere" in G:
        g = G["capsule_sphere"]
        ax1 = gm[:, g.i1, :, 2] * size[g.i1, 1].unsqueeze(-1)
        c1, c2 = gx[:, g.i1], gx[:, g.i2]
        out.append(_capsule_capsule(c1 - ax1, c1 + ax1, size[g.i1, 0],
                                    c2, c2, size[g.i2, 0]))
    if "capsule_capsule" in G:
        g = G["capsule_capsule"]
        ax1 = gm[:, g.i1, :, 2] * size[g.i1, 1].unsqueeze(-1)
        ax2 = gm[:, g.i2, :, 2] * size[g.i2, 1].unsqueeze(-1)
        c1, c2 = gx[:, g.i1], gx[:, g.i2]
        out.append(_capsule_capsule(c1 - ax1, c1 + ax1, size[g.i1, 0],
                                    c2 - ax2, c2 + ax2, size[g.i2, 0]))
    if "sphere_sphere" in G:
        g = G["sphere_sphere"]
        c1, c2 = gx[:, g.i1], gx[:, g.i2]
        out.append(_capsule_capsule(c1, c1, size[g.i1, 0], c2, c2,
                                    size[g.i2, 0]))
    B = gx.shape[0]
    if not out:
        z = gx.new_zeros((B, 0))
        return z, gx.new_zeros((B, 0, 3)), gx.new_zeros((B, 0, 3)), \
            p.g1, p.g2
    depths = torch.cat([o[0] for o in out], dim=1)
    point = torch.cat([o[1] for o in out], dim=1)
    normal = torch.cat([o[2] for o in out], dim=1)
    # MuJoCo combines pair margins by sum (includemargin)
    t = model_tables(model, gx.dtype, gx.device)
    margin = t.geom_margin[p.g1] + t.geom_margin[p.g2]
    return depths + margin, point, normal, p.g1, p.g2


def contact_coeffs(model: Model, dtype, device):
    """(C, nv) chain coefficients mask[body2] - mask[body1] of the slots:
    a contact force acts on every dof above body2 and against every dof
    above body1."""
    return _tables(model, dtype, device).cf


def contact_qfrc(model: Model, data, cdof, cvel, qvel, m_diag):
    """Generalized penalty contact forces (B, nv).

    The normal force uses unit-impedance acceleration semantics,
    f_n = m_eff (k depth - b v_n), with the per-contact effective mass from
    the diagonal approximation m_eff = 1 / sum_d J_nd^2 / M_dd; friction is
    a damper capped at mu f_n."""
    depths, point, normal, g1, g2 = find_contacts(model, data)
    if depths.shape[1] == 0:
        return torch.zeros_like(qvel)
    t = model_tables(model, qvel.dtype, qvel.device)
    p = _tables(model, qvel.dtype, qvel.device)
    cf = p.cf

    def pvel(b):                       # velocity of body b at the points
        return cvel[:, b, 3:] + pm.cross(cvel[:, b, :3], point)

    vrel = pvel(p.b2) - pvel(p.b1)
    vn = torch.sum(vrel * normal, dim=-1)
    vt = vrel - normal * vn.unsqueeze(-1)
    vt_norm = torch.sqrt(torch.sum(vt * vt, dim=-1)) + 1e-9
    un = torch.cat([pm.cross(point, normal), normal], dim=-1)
    jn = torch.einsum("Bdk,BCk->BCd", cdof, un) * cf
    m_eff = 1.0 / (torch.sum(jn * jn / m_diag.unsqueeze(1), dim=-1) + 1e-8)

    floor = 4.0 if model.integrator == EULER else 2.0
    timeconst = torch.clamp(floor * t.timestep, min=0.02)
    k_gain = 1.0 / (timeconst * timeconst)
    b_gain = 2.0 / timeconst
    active = (depths > 0).to(qvel.dtype)
    depths_c = torch.clamp(depths, 0.0, CONTACT_WIDTH)
    fn = torch.clamp(m_eff * (k_gain * depths_c - b_gain * vn),
                     min=0.0) * active
    mu = torch.maximum(t.geom_friction[g1, 0], t.geom_friction[g2, 0])
    ft_mag = torch.minimum(mu * fn, m_eff * b_gain * vt_norm)
    f_world = normal * fn.unsqueeze(-1) \
        - vt * (ft_mag / vt_norm).unsqueeze(-1)
    sf = torch.cat([pm.cross(point, f_world), f_world], dim=-1)
    return torch.einsum("Bdk,BCk,Cd->Bd", cdof, sf, cf)
