"""Smooth forward dynamics: mass matrix, bias forces, passive forces,
actuation, in world-origin spatial coordinates (counterpart of
``mjrl_tpu/physics/dynamics.py``), batch-first.

- spatial inertias are never materialized as 6x6 matrices: I_b v is
  applied directly from (mass, world inertia, CoM): p = m (v + w x c),
  L0 = I_w w + c x p;
- the mass matrix is assembled as M[d, e] = sum_b mask[b,d] mask[b,e]
  S_d . (I_b S_e) over the static ancestor-dof mask, and every sum over
  the tree is one contraction with that mask (or with ``pre_mask``, the
  dofs that move the frame carrying each dof);
- terms whose coefficients are all exact zeros in the model (no joint
  springs, no damping, no fluid) are left out: they add exact zeros.

Fixed tendons have a constant Jacobian ``ten_J``: their passive
spring/damper forces, their penalty length limits and tendon
transmissions map back through it.  Equality constraints (joint coupling,
connect, weld) give residuals and Jacobian rows (``equality_terms``) to
the implicit solver's rows and to the penalty path's reference
acceleration (``equality_qacc``).
"""

import numpy as np
import torch

from mjrl_tpu_torch.physics import math as pm
from mjrl_tpu_torch.physics.kinematics import (Data, ancestor_mask,
                                               model_tables)
from mjrl_tpu_torch.physics.model import (BALL, EQ_CONNECT, EQ_JOINT,
                                          EQ_WELD, EULER, FREE, HINGE,
                                          JNT_NV, SLIDE, Model)

# saturation width for the penalty limit response (rad or m)
LIMIT_WIDTH = 0.02


def joint_dofs(model: Model, j):
    """Static list of dof indices for joint j."""
    da = model.jnt_dofadr[j]
    return list(range(da, da + JNT_NV[model.jnt_type[j]]))


def pre_mask(model: Model) -> np.ndarray:
    """(nv, nv) mask: pre[d, e] = 1 iff dof e moves the frame whose
    velocity carries dof d's axis (MuJoCo mj_comVel): the ancestors' dofs
    and the earlier dofs of the same body, except that a ball joint's three
    dofs all see the velocity before the joint, and a free joint's rotation
    dofs see its full velocity (its translation dofs have cdofdot = 0)."""
    pre = np.zeros((model.nv, model.nv))
    mask = ancestor_mask(model)
    for b in range(1, model.nbody):
        chain = list(np.flatnonzero(mask[model.body_parent[b]]))
        for j in model.body_jnts[b]:
            dofs = joint_dofs(model, j)
            if model.jnt_type[j] == FREE:
                for d in dofs[3:]:
                    pre[d, chain + dofs] = 1.0
            elif model.jnt_type[j] == BALL:
                for d in dofs:
                    pre[d, chain] = 1.0
            else:
                for d in dofs:
                    pre[d, chain] = 1.0
                    chain = chain + [d]
                continue
            chain = chain + dofs
    return pre


def _tables(model, ref):
    t = model_tables(model, ref.dtype, ref.device)
    if not hasattr(t, "pre"):
        t.pre = torch.tensor(pre_mask(model), dtype=ref.dtype,
                             device=ref.device)
        types = model.jnt_type
        t.scalar_joints = all(x in (HINGE, SLIDE) for x in types)
        t.hinge = torch.tensor([x == HINGE for x in types],
                               device=ref.device).unsqueeze(-1)
        t.all_ctrl_limited = bool(np.all(model.ctrllimited > 0))
        t.ctrl_limited = t.ctrllimited > 0
        if model.actuator_simple:
            t.act_dof = torch.tensor(
                [model.jnt_dofadr[j] for j in model.actuator_joint],
                dtype=torch.long, device=ref.device)
        else:
            moment, lengths, balls = _actuator_moments(model)
            t.act_moment = torch.tensor(moment, dtype=ref.dtype,
                                        device=ref.device)
            t.act_len_moment = torch.tensor(lengths, dtype=ref.dtype,
                                            device=ref.device)
            t.act_balls = balls
    return t


def _actuator_moments(model: Model):
    """Constant transmission tables of the affine actuators -> (moment
    (nu, nv): force f_i acts as f_i * moment[i], whose product with qvel
    is the actuator velocity; length (nu, nv): its product with the
    scalar-dof qpos is the length of joint and tendon transmissions; balls:
    [(i, qposadr, dofadr)] of actuators on ball joints, whose length is
    gear . rotvec(quaternion); a free joint's actuator has no length)."""
    moment = np.zeros((model.nu, model.nv))
    lengths = np.zeros((model.nu, model.nv))
    balls = []
    for i, j in enumerate(model.actuator_joint):
        tid = model.actuator_tendon[i]
        if tid >= 0:
            moment[i] = model.gear[i] * model.ten_J[tid]
            lengths[i] = moment[i]
            continue
        da, jt = model.jnt_dofadr[j], model.jnt_type[j]
        if jt == BALL:
            moment[i, da:da + 3] = model.actuator_gearv[i, :3]
            balls.append((i, model.jnt_qposadr[j], da))
        elif jt == FREE:
            moment[i, da:da + 6] = model.actuator_gearv[i]
        else:
            moment[i, da] = model.gear[i]
            lengths[i] = moment[i]
    return moment, lengths, balls


# ---------------------------------------------------------------------------
# Motion subspace and velocities
# ---------------------------------------------------------------------------

def compute_cdof(model: Model, data: Data):
    """(B, nv, 6) world-origin motion axes per dof.

    hinge: (axis, anchor x axis); slide: (0, axis); ball: the post-joint
    body frame's 3 axes anchored at the joint anchor (qvel = local angular
    velocity); free: 3 world translation axes followed by 3 body-frame
    rotation axes anchored at the body origin."""
    t = _tables(model, data.xpos)
    B = data.xpos.shape[0]
    if t.scalar_joints:
        a = data.xaxis
        ang = torch.where(t.hinge, a, torch.zeros_like(a))
        lin = torch.where(t.hinge, pm.cross(data.xanchor, a), a)
        return torch.cat([ang, lin], dim=-1)
    cols = []
    for j in range(model.njnt):
        jt = model.jnt_type[j]
        if jt == HINGE:
            a = data.xaxis[:, j]
            cols.append(torch.cat([a, pm.cross(data.xanchor[:, j], a)], -1))
        elif jt == SLIDE:
            a = data.xaxis[:, j]
            cols.append(torch.cat([torch.zeros_like(a), a], -1))
        elif jt == BALL:
            rot = data.xmat[:, model.jnt_body[j]]
            anchor = data.xanchor[:, j:j + 1].expand(B, 3, 3)
            a = rot.transpose(-1, -2)                  # rows = axes
            cols.append(torch.cat([a, pm.cross(anchor, a)], -1))
        elif jt == FREE:
            b = model.jnt_body[j]
            eye = torch.eye(3, dtype=data.xpos.dtype,
                            device=data.xpos.device)
            cols.append(torch.cat([torch.zeros_like(eye), eye],
                                  -1).expand(B, 3, 6))
            a = data.xmat[:, b].transpose(-1, -2)
            anchor = data.xpos[:, b:b + 1].expand(B, 3, 3)
            cols.append(torch.cat([a, pm.cross(anchor, a)], -1))
        else:
            raise NotImplementedError(f"joint type {jt}")
    if not cols:
        return data.xpos.new_zeros((B, 0, 6))
    return torch.cat([c if c.dim() == 3 else c.unsqueeze(1) for c in cols],
                     dim=1)


def compute_velocities(model: Model, data: Data, cdof, qvel):
    """Body spatial velocities (B, nbody, 6) and cdof time derivatives
    (B, nv, 6): cdofdot[d] = (velocity of the frame carrying dof d) x
    cdof[d], that velocity taken over ``pre_mask``'s dofs."""
    t = _tables(model, qvel)
    vd = cdof * qvel.unsqueeze(-1)                          # (B, nv, 6)
    cvel = torch.einsum("bd,Bdk->Bbk", t.mask, vd)
    vpre = torch.einsum("de,Bek->Bdk", t.pre, vd)
    return cvel, pm.motion_cross(vpre, cdof)


# ---------------------------------------------------------------------------
# Spatial inertia application (no 6x6 materialization)
# ---------------------------------------------------------------------------

def _inertia_ctx(model: Model, data: Data):
    """(mass (nbody,), I_world (B, nbody, 3, 3), com (B, nbody, 3))."""
    t = model_tables(model, data.xpos.dtype, data.xpos.device)
    i_world = pm.rot_diag_rot_t(data.ximat, t.body_inertia)
    return t.body_mass, i_world, data.xipos


def _apply_inertia(mass, i_world, com, motion):
    """h = I motion for world-origin spatial motion vectors (..., 6) =
    (omega, v0) -> (L0, p): p = m (v0 + w x c); L0 = I_w w + c x p."""
    w, v = motion[..., :3], motion[..., 3:]
    p = mass.unsqueeze(-1) * (v + pm.cross(w, com))
    l0 = pm.mat_vec(i_world, w) + pm.cross(com, p)
    return torch.cat([l0, p], dim=-1)


# ---------------------------------------------------------------------------
# Mass matrix and bias
# ---------------------------------------------------------------------------

def mass_and_bias(model: Model, data: Data, cdof, cvel, cdofdot, qvel):
    """(M (B, nv, nv), qfrc_bias (B, nv)) sharing one inertia context."""
    t = _tables(model, cdof)
    mass, i_world, com = _inertia_ctx(model, data)
    u = _apply_inertia(mass[:, None], i_world[:, :, None], com[:, :, None],
                       cdof[:, None])
    m = torch.einsum("bde,Bdk,Bbek->Bde", t.mask2, cdof, u) \
        + torch.diag(t.dof_armature)
    # bias
    avp = torch.einsum("bd,Bdk->Bbk", t.mask, cdofdot * qvel.unsqueeze(-1))
    iv = _apply_inertia(mass, i_world, com, cvel)
    f = _apply_inertia(mass, i_world, com, avp) + pm.force_cross(cvel, iv)
    if np.any(model.gravity != 0):
        mg = mass[:, None] * t.gravity[None, :]            # (nbody, 3)
        f_grav = torch.cat([pm.cross(data.xipos, mg),
                            mg.expand_as(data.xipos)], dim=-1)
        f = f - f_grav
    return m, project_body_forces(model, cdof, f)


def body_spatial_inertias(model: Model, data: Data):
    """(B, nbody, 6, 6) world-origin spatial inertias (a diagnostic; the
    dynamics apply the inertias without building them)."""
    mass, i_world, com = _inertia_ctx(model, data)
    return pm.spatial_inertia(mass.expand(com.shape[:-1]), i_world, com)


def mass_matrix(model: Model, data: Data, cdof):
    """Dense joint-space inertia M (B, nv, nv), armature included."""
    zero_v = cdof.new_zeros(cdof.shape[:-1])
    m, _ = mass_and_bias(model, data, cdof,
                         cdof.new_zeros(data.xipos.shape[:-1] + (6,)),
                         torch.zeros_like(cdof), zero_v)
    return m


def bias_force(model: Model, data: Data, cdof, cvel, cdofdot, qvel):
    """qfrc_bias (B, nv): Coriolis, centrifugal and gravity forces, such
    that M qacc + qfrc_bias = qfrc_applied."""
    return mass_and_bias(model, data, cdof, cvel, cdofdot, qvel)[1]


def project_body_forces(model: Model, cdof, forces):
    """Map per-body world-origin spatial forces (B, nbody, 6) to qfrc
    (B, nv)."""
    t = _tables(model, cdof)
    return torch.einsum("bd,Bdk,Bbk->Bd", t.mask, cdof, forces)


# ---------------------------------------------------------------------------
# Passive forces
# ---------------------------------------------------------------------------

def _dof_q(model, qpos):
    t = _tables(model, qpos)
    return qpos[:, t.dof_qpos_idx]


def spring_force(model: Model, qpos):
    """Joint springs: -stiffness * (qpos - springref) on slide/hinge dofs,
    and quaternion springs -stiffness * rotvec(ref^-1 (x) q) on ball and
    free-joint orientations (the free joint's translational spring pulls
    toward qpos0)."""
    t = _tables(model, qpos)
    qfrc = -t.dof_stiffness * (_dof_q(model, qpos) - t.dof_ref)
    for j in model.jnt_spring_quat:          # static: sprung ball/free
        k = t.jnt_stiffness[j]
        qa, da = model.jnt_qposadr[j], model.jnt_dofadr[j]
        parts = [qfrc[:, :da]]
        if model.jnt_type[j] == BALL:
            dq = pm.quat_mul(pm.quat_inv(t.qpos0[qa:qa + 4]),
                             qpos[:, qa:qa + 4])
            parts.append(qfrc[:, da:da + 3] - k * pm.quat_to_rotvec(dq))
            rest = da + 3
        else:
            parts.append(qfrc[:, da:da + 3]
                         - k * (qpos[:, qa:qa + 3] - t.qpos0[qa:qa + 3]))
            dq = pm.quat_mul(pm.quat_inv(t.qpos0[qa + 3:qa + 7]),
                             qpos[:, qa + 3:qa + 7])
            parts.append(qfrc[:, da + 3:da + 6]
                         - k * pm.quat_to_rotvec(dq))
            rest = da + 6
        qfrc = torch.cat(parts + [qfrc[:, rest:]], dim=-1)
    return qfrc


def damping_force(model: Model, qvel):
    t = _tables(model, qvel)
    return -t.dof_damping * qvel


def tendon_lengths(model: Model, qpos):
    """Fixed-tendon lengths L = ten_J q over the scalar dofs (B, ntendon);
    ball/free columns of ten_J are structurally zero."""
    t = _tables(model, qpos)
    return _dof_q(model, qpos) @ t.ten_J.T


def tendon_passive_force(model: Model, qpos, qvel):
    """qfrc_passive of fixed tendons: a deadband spring (zero inside
    [springlength0, springlength1], linear outside) plus linear damping on
    the tendon velocity, mapped back through the constant Jacobian."""
    t = _tables(model, qpos)
    L = tendon_lengths(model, qpos)
    V = qvel @ t.ten_J.T
    lo, hi = t.ten_springlength[:, 0], t.ten_springlength[:, 1]
    displacement = torch.where(L > hi, hi - L,
                               torch.where(L < lo, lo - L,
                                           torch.zeros_like(L)))
    frc = t.ten_stiffness * displacement - t.ten_damping * V
    return frc @ t.ten_J


def tendon_limit_qacc(model: Model, qpos, qvel):
    """Penalty-path reference acceleration for fixed-tendon length limits
    (the tendon analog of ``limit_qacc``; the implicit solver holds them
    as constraint rows)."""
    t = _tables(model, qpos)
    L = tendon_lengths(model, qpos)
    V = qvel @ t.ten_J.T
    lo, hi = t.ten_range[:, 0], t.ten_range[:, 1]
    below = torch.clamp(lo - L, min=0.0)
    above = torch.clamp(L - hi, min=0.0)
    dist = below - above          # signed: positive pushes the length up
    active = t.ten_limited * ((below > 0) | (above > 0)).to(L.dtype)
    floor = (4.0 if model.integrator == EULER else 2.0) * t.timestep
    timeconst = torch.maximum(t.ten_solref[:, 0], floor)
    dampratio = t.ten_solref[:, 1]
    k = 1.0 / torch.clamp(timeconst * timeconst * dampratio * dampratio,
                          min=1e-12)
    b = 2.0 / torch.clamp(timeconst, min=1e-12)
    aref = (k * torch.clamp(dist, -LIMIT_WIDTH, LIMIT_WIDTH) - b * V) \
        * active
    return aref @ t.ten_J


def limit_qacc(model: Model, qpos, qvel):
    """Soft joint-limit response as a reference ACCELERATION (the penalty
    path's approximation of MuJoCo's soft constraint): aref = k dist -
    b qvel on every violated limited dof, from solref = (timeconst,
    dampratio), with the timeconst floored for explicit integration and
    the positional response saturated at ``LIMIT_WIDTH``."""
    t = _tables(model, qpos)
    floor = (4.0 if model.integrator == EULER else 2.0) * t.timestep
    timeconst = torch.maximum(t.dof_solref[:, 0], floor)
    dampratio = t.dof_solref[:, 1]
    k = 1.0 / torch.clamp(timeconst * timeconst * dampratio * dampratio,
                          min=1e-12)
    b = 2.0 / torch.clamp(timeconst, min=1e-12)
    lo, hi = t.dof_range[:, 0], t.dof_range[:, 1]
    q = _dof_q(model, qpos)
    below = torch.clamp(lo - q, min=0.0)
    above = torch.clamp(q - hi, min=0.0)
    dist = below - above
    active = ((below > 0) | (above > 0)).to(q.dtype)
    dist = torch.clamp(dist, -LIMIT_WIDTH, LIMIT_WIDTH)
    aref = k * dist - b * qvel * active
    return t.dof_limited * active * aref


def ball_limit_terms(model: Model, qpos):
    """Rotation-angle limit terms for ball joints: the total rotation
    angle theta = 2 atan2(|q_xyz|, |q_w|) is held below jnt_range[1]; the
    constraint Jacobian over the joint's 3 dofs is -axis, with axis the
    rotation axis flipped into the minimal-angle cover.

    -> list of (j, dofadr, axis (B, 3), pos (B,), k, b), one per ball
    joint; ``pos`` = range[1] - theta (negative when violated)."""
    t = _tables(model, qpos)
    out = []
    for j in range(model.njnt):
        if model.jnt_type[j] != BALL:
            continue
        qa = model.jnt_qposadr[j]
        q = qpos[:, qa:qa + 4]
        q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-18)
        vnorm = torch.sqrt(torch.sum(q[:, 1:] * q[:, 1:], dim=-1) + 1e-18)
        theta = 2.0 * torch.atan2(vnorm, torch.abs(q[:, 0]))
        sgn = torch.sign(q[:, 0] + (q[:, 0] == 0).to(q.dtype))
        axis = q[:, 1:] / vnorm.unsqueeze(-1) * sgn.unsqueeze(-1)
        pos = t.jnt_range[j, 1] - theta
        floor = (4.0 if model.integrator == EULER else 2.0) * t.timestep
        timeconst = torch.maximum(t.limit_solref[j, 0], floor)
        dampratio = t.limit_solref[j, 1]
        k = 1.0 / torch.clamp(timeconst * timeconst * dampratio * dampratio,
                              min=1e-12)
        b = 2.0 / torch.clamp(timeconst, min=1e-12)
        out.append((j, model.jnt_dofadr[j], axis, pos, k, b))
    return out


def ball_limit_qacc(model: Model, qpos, qvel):
    """Penalty-path reference acceleration for ball-joint limits (the
    3-dof analog of limit_qacc)."""
    t = _tables(model, qpos)
    qacc = torch.zeros_like(qvel)
    for j, da, axis, pos, k, b in ball_limit_terms(model, qpos):
        viol = torch.clamp(pos, max=0.0)
        active = (pos < 0).to(qvel.dtype) * t.jnt_limited[j]
        jrow = -axis
        jv = jrow[:, 0] * qvel[:, da] + jrow[:, 1] * qvel[:, da + 1] \
            + jrow[:, 2] * qvel[:, da + 2]
        aref = (-k * torch.clamp(viol, -LIMIT_WIDTH, 0.0) - b * jv) * active
        add = torch.zeros_like(qvel)
        add[:, da:da + 3] = jrow * aref.unsqueeze(-1)
        qacc = qacc + add
    return qacc


def equality_terms(model: Model, data: Data, cdof, qpos):
    """Residuals and Jacobians of the equality constraints -> a list of
    (i, jrows (B, k, nv), res (B, k), imppos (B,), iw), one entry per
    constraint: k = 1 for a joint coupling, 3 for a connect, 6 for a weld.
    ``imppos`` is the impedance position (|res|, or ||res|| for connect and
    weld), ``iw`` the diagApprox inverse weight (a scalar, or (6,) for a
    weld).  Joint: res = (q1 - q1_0) - poly(q2 - q2_0), the quartic
    eq_data[:5]; connect: res = world(anchor on body1) - world(anchor on
    body2); weld: the connect rows, then ts * vec(q2^-1 q1 relq)."""
    t = _tables(model, qpos)
    out = []
    dtype, dev = qpos.dtype, qpos.device
    eye = torch.eye(model.nv, dtype=dtype, device=dev)
    for i in range(model.neq):
        kind = model.eq_kind[i]
        if kind == EQ_JOINT:
            j1, j2 = model.eq_obj1[i], model.eq_obj2[i]
            d1, qa1 = model.jnt_dofadr[j1], model.jnt_qposadr[j1]
            c = t.eq_data[i, :5]
            q1 = qpos[:, qa1] - t.qpos0[qa1]
            if j2 >= 0:
                d2, qa2 = model.jnt_dofadr[j2], model.jnt_qposadr[j2]
                dq = qpos[:, qa2] - t.qpos0[qa2]
                poly = c[0] + dq * (c[1] + dq * (c[2] + dq * (c[3]
                                                             + dq * c[4])))
                dpoly = c[1] + dq * (2 * c[2] + dq * (3 * c[3]
                                                      + dq * 4 * c[4]))
                res = q1 - poly
                jrow = eye[d1] - dpoly.unsqueeze(-1) * eye[d2]
                iw = t.dof_invweight0[d1] + t.dof_invweight0[d2]
            else:
                res = q1 - c[0]
                jrow = eye[d1].expand(qpos.shape[0], -1)
                iw = t.dof_invweight0[d1]
            out.append((i, jrow.unsqueeze(1), res.unsqueeze(-1),
                        torch.abs(res), iw))
        elif kind == EQ_CONNECT:
            b1, b2 = model.eq_obj1[i], model.eq_obj2[i]
            p1 = data.xpos[:, b1] + pm.mat_vec(data.xmat[:, b1],
                                               t.eq_data[i, :3])
            p2 = data.xpos[:, b2] + pm.mat_vec(data.xmat[:, b2],
                                               t.eq_data[i, 3:6])
            res = p1 - p2
            out.append((i, _point_diff_rows(t, cdof, b1, b2, p1, p2), res,
                        torch.sqrt(torch.sum(res * res, -1) + 1e-18),
                        t.body_invweight0[b1, 0] + t.body_invweight0[b2, 0]))
        elif kind == EQ_WELD:
            b1, b2 = model.eq_obj1[i], model.eq_obj2[i]
            relq, ts = t.eq_data[i, 6:10], t.eq_data[i, 10]
            p1 = data.xpos[:, b1] + pm.mat_vec(data.xmat[:, b1],
                                               t.eq_data[i, 3:6])
            p2 = data.xpos[:, b2] + pm.mat_vec(data.xmat[:, b2],
                                               t.eq_data[i, :3])
            jpos = _point_diff_rows(t, cdof, b1, b2, p1, p2)
            q1 = pm.mat_to_quat(data.xmat[:, b1])
            q2i = pm.quat_inv(pm.mat_to_quat(data.xmat[:, b2]))
            res_rot = ts * pm.quat_mul(pm.quat_mul(q2i, q1), relq)[:, 1:]
            # d res_rot / d phi1 for an incremental world rotation (1,
            # phi1 / 2) o q1 of body1; body2's (1, phi2 / 2) o q2 enters
            # through q2^-1 with the opposite sign, so A2 = -A1
            half = 0.5 * torch.eye(3, dtype=dtype, device=dev)
            dq = torch.cat([torch.zeros((3, 1), dtype=dtype, device=dev),
                            half], dim=-1)                      # (3, 4)
            a1 = ts * pm.quat_mul(pm.quat_mul(pm.quat_mul(
                q2i.unsqueeze(1), dq), q1.unsqueeze(1)), relq)[..., 1:]
            # a1 (B, 3 (phi), 3 (res)); rows over the angular cdof of the
            # dofs moving body1 and not body2, minus the converse
            ang = cdof[..., :3] * (t.mask[b1] - t.mask[b2]).unsqueeze(-1)
            jrot = torch.einsum("Bkr,Bdk->Brd", a1, ang)
            res = torch.cat([p1 - p2, res_rot], dim=-1)
            iw_t = t.body_invweight0[b1, 0] + t.body_invweight0[b2, 0]
            iw_r = t.body_invweight0[b1, 1] + t.body_invweight0[b2, 1]
            out.append((i, torch.cat([jpos, jrot], dim=1), res,
                        torch.sqrt(torch.sum(res * res, -1) + 1e-18),
                        torch.stack([iw_t, iw_t, iw_t, iw_r, iw_r, iw_r])))
        else:
            raise NotImplementedError(f"equality kind {kind}")
    return out


def _point_diff_rows(t, cdof, b1, b2, p1, p2):
    """(B, 3, nv) Jacobian of the world difference of point p1 on body b1
    and point p2 on body b2 (connect and weld)."""
    ang, lin = cdof[..., :3], cdof[..., 3:]
    v1 = lin + pm.cross(ang, p1.unsqueeze(1).expand_as(ang))
    v2 = lin + pm.cross(ang, p2.unsqueeze(1).expand_as(ang))
    return (t.mask[b1].unsqueeze(-1) * v1
            - t.mask[b2].unsqueeze(-1) * v2).transpose(-1, -2)


def equality_qacc(model: Model, data: Data, cdof, qpos, qvel):
    """Penalty-path reference acceleration of the equality constraints: a
    critically damped bilateral response from eq_solref, the position
    term saturated 10 x wider than the limits' (the implicit solver holds
    them as constraint rows)."""
    t = _tables(model, qvel)
    qacc = torch.zeros_like(qvel)
    floor = (4.0 if model.integrator == EULER else 2.0) * t.timestep
    width = 10.0 * LIMIT_WIDTH
    for i, jrows, res, _, _ in equality_terms(model, data, cdof, qpos):
        timeconst = torch.maximum(t.eq_solref[i, 0], floor)
        dampratio = t.eq_solref[i, 1]
        k = 1.0 / torch.clamp(timeconst * timeconst * dampratio * dampratio,
                              min=1e-12)
        b = 2.0 / torch.clamp(timeconst, min=1e-12)
        jv = torch.matmul(jrows, qvel.unsqueeze(-1)).squeeze(-1)
        aref = (-k * torch.clamp(res, -width, width) - b * jv) \
            * t.eq_active[i]
        qacc = qacc + torch.matmul(aref.unsqueeze(-2), jrows).squeeze(-2)
    return qacc


def fluid_force(model: Model, data: Data, cvel):
    """MuJoCo's 'equivalent inertia box' fluid model (viscosity +
    density), per body in the inertial frame, mapped back to world-origin
    spatial forces (B, nbody, 6)."""
    t = _tables(model, cvel)
    i0, i1, i2 = (t.body_inertia[:, 0], t.body_inertia[:, 1],
                  t.body_inertia[:, 2])
    m = torch.clamp(t.body_mass, min=1e-12)
    lx = torch.sqrt(torch.clamp(6.0 * (i1 + i2 - i0) / m, min=1e-12)) * 0.5
    ly = torch.sqrt(torch.clamp(6.0 * (i0 + i2 - i1) / m, min=1e-12)) * 0.5
    lz = torch.sqrt(torch.clamp(6.0 * (i0 + i1 - i2) / m, min=1e-12)) * 0.5
    box = torch.stack([lx, ly, lz], dim=-1)            # (nbody, 3)

    w_world = cvel[..., :3]
    v_world = pm.point_velocity(cvel, data.xipos)
    w_l = pm.mat_t_vec(data.ximat, w_world)
    v_l = pm.mat_t_vec(data.ximat, v_world)

    diam = torch.sum(box, dim=-1) * 2.0 / 3.0
    t_visc = -np.pi * diam[:, None] ** 3 * t.viscosity * w_l
    f_visc = -3.0 * np.pi * diam[:, None] * t.viscosity * v_l

    b0, b1, b2 = box[:, 0], box[:, 1], box[:, 2]
    area = torch.stack([b1 * b2, b0 * b2, b0 * b1], dim=-1) * 4.0
    f_dens = -0.5 * t.density * area * torch.abs(v_l) * v_l
    tcoef = torch.stack([b0 * (b1 ** 4 + b2 ** 4),
                         b1 * (b0 ** 4 + b2 ** 4),
                         b2 * (b0 ** 4 + b1 ** 4)], dim=-1)
    t_dens = -0.5 * t.density * tcoef * torch.abs(w_l) * w_l

    has_mass = (t.body_mass > 1e-12).to(cvel.dtype)[:, None]
    t_l = (t_visc + t_dens) * has_mass
    f_l = (f_visc + f_dens) * has_mass

    t_w = pm.mat_vec(data.ximat, t_l)
    f_w = pm.mat_vec(data.ximat, f_l)
    n0 = t_w + pm.cross(data.xipos, f_w)
    return torch.cat([n0, f_w], dim=-1)


def has_fluid(model: Model):
    return float(model.viscosity) != 0.0 or float(model.density) != 0.0


# ---------------------------------------------------------------------------
# Actuation
# ---------------------------------------------------------------------------

def actuator_force(model: Model, ctrl, qpos=None, qvel=None):
    """qfrc_actuator (B, nv) under the affine actuator model f = gain *
    ctrl + b0 + b1 length + b2 velocity, each control clipped to its
    ctrlrange where ctrllimited, applied through its transmission.

    Plain motors on scalar joints take one scatter.  Otherwise the
    transmissions are constant moment rows (a scalar joint: gear at its
    dof; a tendon: gear x its ten_J row; ball and free joints: the vector
    gear at their dofs), so velocities and forces are one product each;
    a ball joint's length is gear . rotvec(quaternion), a free joint has
    none.  ``qpos``/``qvel`` None count as zero length/velocity."""
    t = _tables(model, ctrl)
    qfrc = ctrl.new_zeros((ctrl.shape[0], model.nv))
    if model.nu == 0:
        return qfrc
    c = torch.clamp(ctrl, t.ctrlrange[:, 0], t.ctrlrange[:, 1])
    if not t.all_ctrl_limited:
        c = torch.where(t.ctrl_limited, c, ctrl)
    if model.actuator_simple:
        return qfrc.index_add(1, t.act_dof, t.gear * c)
    f = t.actuator_gain * c + t.actuator_bias[:, 0]
    if qpos is not None:
        length = _dof_q(model, qpos) @ t.act_len_moment.T
        if t.act_balls:
            length = length.clone()
            for i, qa, da in t.act_balls:
                rv = pm.quat_to_rotvec(qpos[:, qa:qa + 4])
                length[:, i] = rv @ t.actuator_gearv[i, :3]
        f = f + t.actuator_bias[:, 1] * length
    if qvel is not None:
        f = f + t.actuator_bias[:, 2] * (qvel @ t.act_moment.T)
    return f @ t.act_moment
