"""Quaternion / rotation / spatial-vector math for the rigid-body engine
(counterpart of ``mjrl_tpu/physics/math.py``).

Conventions (MuJoCo's, as in the JAX package):

- quaternions are (w, x, y, z), unit norm.
- rotation matrices are world-from-local.
- spatial motion vectors are Pluecker coordinates at the *world origin*:
  v = (omega, v0) where v0 is the velocity of the body-fixed point
  instantaneously at the origin.
- spatial force vectors are (torque-about-origin, force).

Every function takes any leading batch shape on the left.  The JAX package
writes its 3x3 products out component by component so that XLA fuses them
into one elementwise kernel; in eager PyTorch every operation is a launch,
so the products here are single batched matmuls instead.
"""

import math

import torch


def quat_to_mat(q):
    """(..., 4) wxyz -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(q.shape[:-1] + (3, 3))


def quat_mul(a, b):
    """Hamilton product, (..., 4) x (..., 4) -> (..., 4)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v (..., 3) by quaternion q (..., 4)."""
    return mat_vec(quat_to_mat(q), v)


def axis_angle_quat(axis, angle):
    """Unit axis (..., 3), angle (...) -> quaternion."""
    half = angle * 0.5
    return torch.cat([torch.cos(half).unsqueeze(-1),
                      axis * torch.sin(half).unsqueeze(-1)], dim=-1)


def quat_inv(q):
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def mat_to_quat(m):
    """(..., 3, 3) rotation matrix -> wxyz unit quaternion (Shepperd's
    method: the division uses the largest of the four candidate
    magnitudes, selected branch-free)."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    t = m00 + m11 + m22
    cand = torch.stack([1.0 + t, 1.0 + m00 - m11 - m22,
                        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
                       dim=-1)
    s = 2.0 * torch.sqrt(torch.clamp(cand, min=1e-12))
    sw, sx, sy, sz = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    d21, d02, d10 = (m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1])
    s01, s02, s12 = (m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0],
                     m[..., 1, 2] + m[..., 2, 1])
    qw = torch.stack([0.25 * sw, d21 / sw, d02 / sw, d10 / sw], dim=-1)
    qx = torch.stack([d21 / sx, 0.25 * sx, s01 / sx, s02 / sx], dim=-1)
    qy = torch.stack([d02 / sy, s01 / sy, 0.25 * sy, s12 / sy], dim=-1)
    qz = torch.stack([d10 / sz, s02 / sz, s12 / sz, 0.25 * sz], dim=-1)
    k = torch.argmax(cand, dim=-1).unsqueeze(-1)
    q = torch.where(k == 0, qw, torch.where(
        k == 1, qx, torch.where(k == 2, qy, qz)))
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-24)


def quat_to_rotvec(q):
    """Rotation vector (axis * angle, angle in [-pi, pi]) of a unit
    quaternion (MuJoCo mju_quat2Vel at unit timestep)."""
    w = q[..., 0]
    v = q[..., 1:]
    sin_half = torch.sqrt(torch.sum(v * v, dim=-1) + 1e-24)
    angle = 2.0 * torch.atan2(sin_half, w)
    angle = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
    return v * (angle / sin_half).unsqueeze(-1)


def skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix: skew(a) @ b = a x b."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# small-matrix products (one batched matmul each)
# ---------------------------------------------------------------------------

def mat_mul(a, b):
    """(..., 3, 3) @ (..., 3, 3)."""
    return torch.matmul(a, b)


def mat_vec(a, v):
    """(..., 3, 3) @ (..., 3)."""
    return torch.matmul(a, v.unsqueeze(-1)).squeeze(-1)


def mat_t_vec(a, v):
    """(..., 3, 3)^T @ (..., 3)."""
    return torch.matmul(v.unsqueeze(-2), a).squeeze(-2)


def rot_diag_rot_t(r, d):
    """R diag(d) R^T for (..., 3, 3) rotations and (..., 3) diagonals."""
    return torch.matmul(r * d.unsqueeze(-2), r.transpose(-1, -2))


def cross(a, b):
    """(..., 3) x (..., 3), broadcasting the leading shapes."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# ---------------------------------------------------------------------------
# Spatial algebra (6-vectors at the world origin)
# ---------------------------------------------------------------------------

def motion_cross(v, m):
    """v x m for motion vectors v, m = (omega, lin)."""
    w, l = v[..., :3], v[..., 3:]
    mw, ml = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, mw), cross(w, ml) + cross(l, mw)], dim=-1)


def force_cross(v, f):
    """v x* f for motion v = (omega, lin), force f = (torque, force)."""
    w, l = v[..., :3], v[..., 3:]
    ft, ff = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, ft) + cross(l, ff), cross(w, ff)], dim=-1)


def spatial_inertia(mass, inertia_world, com):
    """(..., 6, 6) spatial inertia at the world origin from mass (...),
    rotational inertia about the CoM in world axes (..., 3, 3) and CoM
    world position (..., 3)."""
    cx = skew(com)
    m = torch.as_tensor(mass, dtype=cx.dtype, device=cx.device)[..., None,
                                                                  None]
    cxt = cx.transpose(-1, -2)
    eye = torch.eye(3, dtype=cx.dtype, device=cx.device)
    top = torch.cat([inertia_world + m * (cx @ cxt), m * cx], dim=-1)
    bot = torch.cat([m * cxt, m * eye.expand_as(cx)], dim=-1)
    return torch.cat([top, bot], dim=-2)


def point_velocity(v, p):
    """Linear velocity of a body point at world position p given the body's
    spatial motion vector v = (omega, v0)."""
    return v[..., 3:] + cross(v[..., :3], p)
