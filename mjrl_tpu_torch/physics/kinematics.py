"""Forward kinematics: world poses for bodies, joints, geoms, sites
(counterpart of ``mjrl_tpu/physics/kinematics.py``), batch-first.

MuJoCo semantics:

- a body's frame = parent frame o (body_pos, body_quat) o joint transforms
  applied in declaration order;
- each joint's world anchor/axis are computed in the pre-this-joint frame;
  a hinge rotates the body frame about its anchor, a slide translates along
  its axis by (qpos - ref), a ball rotates it about its anchor by the
  joint's quaternion, a free joint sets the world pose outright.

The body loop is a Python loop over the static tree, as in the JAX
package; every index table is a constant built once per model
(``model_tables``).
"""

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any

import numpy as np
import torch

from mjrl_tpu_torch.physics import math as pm
from mjrl_tpu_torch.physics.model import (BALL, FREE, HINGE, JNT_NV, SLIDE,
                                          Model)


@dataclass
class Data:
    """Per-state kinematic quantities, leading dimension B."""
    xpos: Any       # (B, nbody, 3) body frame origin, world
    xmat: Any       # (B, nbody, 3, 3) body orientation, world
    xipos: Any      # (B, nbody, 3) body CoM, world
    ximat: Any      # (B, nbody, 3, 3) principal-inertia frame, world
    xanchor: Any    # (B, njnt, 3) joint anchor, world
    xaxis: Any      # (B, njnt, 3) joint axis, world
    site_xpos: Any = None  # (B, nsite, 3)
    geom_xpos: Any = None  # (B, ngeom, 3)
    geom_xmat: Any = None  # (B, ngeom, 3, 3)


def ancestor_mask(model: Model) -> np.ndarray:
    """(nbody, nv) float mask: mask[b, d] = 1 iff dof d is on the kinematic
    chain from the world to body b (inclusive)."""
    mask = np.zeros((model.nbody, model.nv), np.float32)
    for b in range(1, model.nbody):
        p = model.body_parent[b]
        mask[b] = mask[p]
        for j in model.body_jnts[b]:
            da = model.jnt_dofadr[j]
            mask[b, da:da + JNT_NV[model.jnt_type[j]]] = 1.0
    return mask


def model_tables(model: Model, dtype, device):
    """The model's numeric fields as tensors of ``dtype`` on ``device``,
    with the derived constants of the engine, built once per (model,
    dtype, device) and cached on the model."""
    cache = model.__dict__.setdefault("_tables", {})
    key = (dtype, torch.device(device))
    if key in cache:
        return cache[key]
    t = SimpleNamespace()
    for name, val in vars(model).items():
        if isinstance(val, np.ndarray) and val.dtype.kind == "f":
            setattr(t, name, torch.tensor(val, dtype=dtype, device=device))
    t.dtype, t.device = dtype, torch.device(device)
    t.body_mat = pm.quat_to_mat(t.body_quat)
    t.body_imat = pm.quat_to_mat(t.body_iquat)
    t.geom_mat = pm.quat_to_mat(t.geom_quat) if model.ngeom else None
    mask = ancestor_mask(model).astype(np.float64)
    t.mask = torch.tensor(mask, dtype=dtype, device=device)
    t.mask2 = t.mask[:, :, None] * t.mask[:, None, :]
    t.dof_qpos_idx = torch.tensor(model.dof_qpos_idx, dtype=torch.long,
                                  device=device)
    t.site_body = torch.tensor(model.site_body, dtype=torch.long,
                               device=device)
    t.geom_body = torch.tensor(model.geom_body, dtype=torch.long,
                               device=device)
    cache[key] = t
    return t


def _axis_angle_mat(axis, angle):
    """Rotation matrix about unit ``axis`` (B, 3) by ``angle`` (B,)
    (Rodrigues)."""
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    s = torch.sin(angle)
    c = torch.cos(angle)
    ic = 1.0 - c
    rows = [
        c + x * x * ic, x * y * ic - z * s, x * z * ic + y * s,
        y * x * ic + z * s, c + y * y * ic, y * z * ic - x * s,
        z * x * ic - y * s, z * y * ic + x * s, c + z * z * ic,
    ]
    return torch.stack(rows, dim=-1).reshape(axis.shape[:-1] + (3, 3))


def body_frames(model: Model, qpos, body_pos=None) -> Data:
    """Body and joint frames of a batch of configurations ``qpos``
    (B, nq): the part of forward kinematics that the dynamics read (sites
    and geoms left out).  ``body_pos`` (B, nbody, 3) gives every row its
    own body offsets (scenery such as a fixture moved per episode), else
    the model's."""
    t = model_tables(model, qpos.dtype, qpos.device)
    B = qpos.shape[0]
    if body_pos is None:
        body_pos = t.body_pos.expand(B, -1, -1)
    xpos = [None] * model.nbody      # None: the world (origin, identity)
    xmat = [None] * model.nbody
    xanchor = [None] * model.njnt
    xaxis = [None] * model.njnt

    for b in range(1, model.nbody):
        p = model.body_parent[b]
        if xmat[p] is None:
            mat = t.body_mat[b].expand(B, 3, 3)
            pos = body_pos[:, b]
        else:
            mat = pm.mat_mul(xmat[p], t.body_mat[b])
            pos = xpos[p] + pm.mat_vec(xmat[p], body_pos[:, b])
        for j in model.body_jnts[b]:
            adr = model.jnt_qposadr[j]
            jt = model.jnt_type[j]
            if jt == FREE:
                # floating base: qpos holds the absolute world pose
                pos = qpos[:, adr:adr + 3]
                quat = qpos[:, adr + 3:adr + 7]
                quat = quat / torch.sqrt(
                    torch.sum(quat * quat, dim=-1, keepdim=True) + 1e-12)
                mat = pm.quat_to_mat(quat)
                xanchor[j] = pos
                xaxis[j] = mat[..., :, 2]
                continue
            anchor = pos + pm.mat_vec(mat, t.jnt_pos[j])
            axis_w = pm.mat_vec(mat, t.jnt_axis[j])
            xanchor[j] = anchor
            xaxis[j] = axis_w
            if jt == BALL:
                # rotate about the anchor by the local quaternion (xaxis
                # stays in the pre-rotation frame, as MuJoCo's)
                q4 = qpos[:, adr:adr + 4]
                q4 = q4 / torch.sqrt(
                    torch.sum(q4 * q4, dim=-1, keepdim=True) + 1e-12)
                mat = pm.mat_mul(mat, pm.quat_to_mat(q4))
                pos = anchor - pm.mat_vec(mat, t.jnt_pos[j])
                continue
            q = qpos[:, adr] - t.jnt_ref[j]
            if jt == SLIDE:
                pos = pos + axis_w * q.unsqueeze(-1)
            elif jt == HINGE:
                # local right-multiplication: axis fixed in pre-joint frame
                mat = pm.mat_mul(_axis_angle_mat(axis_w, q), mat)
                pos = anchor - pm.mat_vec(mat, t.jnt_pos[j])
            else:
                raise NotImplementedError(f"joint type {jt} not supported")
        xpos[b] = pos
        xmat[b] = mat

    dtype, dev = qpos.dtype, qpos.device
    xpos[0] = torch.zeros((B, 3), dtype=dtype, device=dev)
    xmat[0] = torch.eye(3, dtype=dtype, device=dev).expand(B, 3, 3)
    xpos = torch.stack(xpos, dim=1)
    xmat = torch.stack(xmat, dim=1)

    # CoM / inertial frames
    xipos = xpos + pm.mat_vec(xmat, t.body_ipos)
    ximat = pm.mat_mul(xmat, t.body_imat)
    xanchor = (torch.stack(xanchor, dim=1) if model.njnt
               else qpos.new_zeros((B, 0, 3)))
    xaxis = (torch.stack(xaxis, dim=1) if model.njnt
             else qpos.new_zeros((B, 0, 3)))
    return Data(xpos=xpos, xmat=xmat, xipos=xipos, ximat=ximat,
                xanchor=xanchor, xaxis=xaxis)


def site_positions(model: Model, data: Data, site_pos=None):
    """(B, nsite, 3) world site positions; ``site_pos`` (B, nsite, 3)
    gives every row its own local site positions (scenery such as a goal
    moved per episode), else the model's."""
    if not model.nsite:
        return data.xpos.new_zeros((data.xpos.shape[0], 0, 3))
    t = model_tables(model, data.xpos.dtype, data.xpos.device)
    sp = t.site_pos if site_pos is None else site_pos
    return data.xpos[:, t.site_body] + pm.mat_vec(data.xmat[:, t.site_body],
                                                  sp)


def geom_frames(model: Model, data: Data, geoms=None):
    """World positions (B, G, 3) and orientations (B, G, 3, 3) of the
    geoms ``geoms`` (a long tensor of ids on the data's device; None =
    all)."""
    t = model_tables(model, data.xpos.dtype, data.xpos.device)
    if geoms is None:
        gb, gp, gm = t.geom_body, t.geom_pos, t.geom_mat
    else:
        gb, gp, gm = t.geom_body[geoms], t.geom_pos[geoms], t.geom_mat[geoms]
    B = data.xpos.shape[0]
    if gb.shape[0] == 0:
        return (data.xpos.new_zeros((B, 0, 3)),
                data.xpos.new_zeros((B, 0, 3, 3)))
    bm = data.xmat[:, gb]
    return data.xpos[:, gb] + pm.mat_vec(bm, gp), pm.mat_mul(bm, gm)


def fwd_kinematics(model: Model, qpos, site_pos=None, body_pos=None) -> Data:
    """Every world pose of a batch of configurations ``qpos`` (B, nq):
    bodies, joints, sites (``site_pos`` (B, nsite, 3): per-row local site
    positions, else the model's) and geoms; ``body_pos`` as in
    ``body_frames``."""
    data = body_frames(model, qpos, body_pos)
    data.site_xpos = site_positions(model, data, site_pos)
    if model.ngeom:
        data.geom_xpos, data.geom_xmat = geom_frames(model, data)
    else:
        B = qpos.shape[0]
        data.geom_xpos = qpos.new_zeros((B, 0, 3))
        data.geom_xmat = qpos.new_zeros((B, 0, 3, 3))
    return data
