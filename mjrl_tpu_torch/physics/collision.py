"""Contact detection and penalty contact forces of the general engine: the
subset of ``mjrl_tpu/physics/collision.py`` that the ported environments
reach.

Only plane-sphere pairs are ported (the 7-DoF reacher's fingertip sphere
against its table plane), for the implicit solver's contact rows and for
the penalty path's ``contact_qfrc``.  Every other pair type and the
active-set cap of contact-rich models belong to ROADMAP.md M9 and raise
``NotImplementedError``.
"""

from types import SimpleNamespace

import numpy as np
import torch

from mjrl_tpu_torch.physics import math as pm
from mjrl_tpu_torch.physics.kinematics import (ancestor_mask, geom_frames,
                                               model_tables)
from mjrl_tpu_torch.physics.model import EULER, PLANE, SPHERE, Model

# penetration width where the penalty normal response saturates (m)
CONTACT_WIDTH = 0.02

# the JAX package caps the contact rows of models with more candidates
# than this (its contact_topk); no ported model comes near it
MAX_UNCAPPED = 64


def plane_sphere_pairs(model: Model):
    """Static (plane geom ids, sphere geom ids, pair indices) of the
    model's contact pairs, in the JAX package's emission order; raises for
    any other pair type."""
    g1, g2, idx = [], [], []
    for pi, (a, b) in enumerate(model.contact_pairs):
        ta, tb = model.geom_type[a], model.geom_type[b]
        if tb == PLANE:
            a, b, ta, tb = b, a, tb, ta
        if not (ta == PLANE and tb == SPHERE):
            raise NotImplementedError(
                f"contact pair of geom types {ta}/{tb}: only plane-sphere "
                "contacts are ported to the general engine (planar contact "
                "models take the planar fast path, under the implicit "
                "solver); the other narrowphase pairs need ROADMAP.md M9")
        g1.append(a)
        g2.append(b)
        idx.append(pi)
    if len(g1) > MAX_UNCAPPED:
        raise NotImplementedError(
            "contact-rich models (the JAX package's contact_topk cap) need "
            "ROADMAP.md M9")
    return g1, g2, idx


def _pair_tables(model: Model, dtype, device):
    """The static contact tables of a model, built once with its other
    tables: geom and body ids of both sides, the (C, nv) chain
    coefficients, radii and summed margins."""
    t = model_tables(model, dtype, device)
    if not hasattr(t, "pairs"):
        g1, g2, _ = plane_sphere_pairs(model)
        gb = np.asarray(model.geom_body)
        mask = ancestor_mask(model).astype(np.float64)
        ids = lambda x: torch.tensor(x, dtype=torch.long, device=device)
        t.pairs = SimpleNamespace(
            g1=g1, g2=g2, g1_t=ids(g1), g2_t=ids(g2),
            b1=ids(gb[g1]), b2=ids(gb[g2]),
            cf=torch.tensor(mask[gb[g2]] - mask[gb[g1]], dtype=dtype,
                            device=device),
            radius=t.geom_size[g2, 0],
            margin=t.geom_margin[g1] + t.geom_margin[g2])
    return t.pairs


def find_contacts(model: Model, data):
    """All plane-sphere pairs of a batch -> (depths (B, C), point
    (B, C, 3), normal (B, C, 3), g1, g2), with g1/g2 static lists of geom
    ids.  depth > 0 means active; depths include the pair's margin (the
    sum of the geoms' margins, MuJoCo's includemargin)."""
    p = _pair_tables(model, data.xpos.dtype, data.xpos.device)
    px, pm_ = geom_frames(model, data, p.g1_t)
    sx, _ = geom_frames(model, data, p.g2_t)
    n = pm_[..., :, 2]                                  # plane normals
    d = torch.sum((sx - px) * n, dim=-1)
    depth = p.radius - d
    # MuJoCo convention: contact point midway between the two surfaces
    point = sx - n * (0.5 * (d + p.radius)).unsqueeze(-1)
    return depth + p.margin, point, n, p.g1, p.g2


def contact_condims(model: Model):
    """Per-contact condim, aligned with ``find_contacts``."""
    _, _, idx = plane_sphere_pairs(model)
    return np.array([model.contact_pair_condim[i] for i in idx], np.int32)


def contact_coeffs(model: Model, dtype, device):
    """(C, nv) chain coefficients mask[body2] - mask[body1] of the
    contacts: a contact force acts on every dof above body2 and against
    every dof above body1."""
    return _pair_tables(model, dtype, device).cf


def contact_qfrc(model: Model, data, cdof, cvel, qvel, m_diag):
    """Generalized penalty contact forces (B, nv).

    The normal force uses unit-impedance acceleration semantics,
    f_n = m_eff (k depth - b v_n), with the per-contact effective mass from
    the diagonal approximation m_eff = 1 / sum_d J_nd^2 / M_dd; friction is
    a damper capped at mu f_n."""
    depths, point, normal, g1, g2 = find_contacts(model, data)
    t = model_tables(model, qvel.dtype, qvel.device)
    p = _pair_tables(model, qvel.dtype, qvel.device)
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
