"""Static model description for the rigid-body engine (host side, numpy).

Counterpart of ``mjrl_tpu/physics/model.py``.  ``ModelBuilder`` turns
body/joint/geom/site/actuator declarations into a ``Model`` — a plain
dataclass of float64 numpy arrays and static topology tuples — computing
per-body mass, CoM and principal inertia from geoms like MuJoCo's
``inertiafromgeom`` compiler path.

Ported so far: slide and hinge joints, plain motors, geoms for inertia.
Ball/free joints, tendons, equalities and explicit contact pairs belong
to the general 3D engine (ROADMAP.md M8/M9) and raise
``NotImplementedError``.
"""

from dataclasses import dataclass, field, replace
from typing import Any, Tuple

import numpy as np

# joint types (MuJoCo enum values)
FREE = 0
BALL = 1
SLIDE = 2
HINGE = 3

# dof/qpos widths per joint type
JNT_NQ = {FREE: 7, BALL: 4, SLIDE: 1, HINGE: 1}
JNT_NV = {FREE: 6, BALL: 3, SLIDE: 1, HINGE: 1}

# geom types (MuJoCo enum values)
PLANE = 0
SPHERE = 2
CAPSULE = 3
CYLINDER = 5
BOX = 6

EULER = 0
RK4 = 1

# constraint solver modes
PENALTY = 0   # explicit penalties
PGS = 1       # implicit dual

# friction-cone types (MuJoCo mjtCone)
PYRAMIDAL = 0
ELLIPTIC = 1

# equality constraint kinds (MuJoCo mjtEq values)
EQ_CONNECT = 0
EQ_WELD = 1
EQ_JOINT = 2


@dataclass(frozen=True)
class Model:
    # ---- static topology ----
    nbody: int
    njnt: int
    nq: int
    nv: int
    nu: int
    ngeom: int
    nsite: int
    body_parent: Tuple[int, ...]
    body_jnts: Tuple[Tuple[int, ...], ...]
    jnt_type: Tuple[int, ...]
    jnt_body: Tuple[int, ...]
    jnt_qposadr: Tuple[int, ...]
    jnt_dofadr: Tuple[int, ...]
    geom_body: Tuple[int, ...]
    geom_type: Tuple[int, ...]
    site_body: Tuple[int, ...]
    actuator_joint: Tuple[int, ...]
    integrator: int
    solver: int = 0
    contact_pairs: Tuple[Tuple[int, int], ...] = ()
    geom_condim: Tuple[int, ...] = ()
    contact_pair_condim: Tuple[int, ...] = ()
    cone: int = 0
    noslip_iters: int = 0
    actuator_simple: bool = True
    ntendon: int = 0
    neq: int = 0
    dof_qpos_idx: Tuple[int, ...] = ()

    # ---- numeric fields (float64 numpy) ----
    body_pos: Any = None          # (nbody, 3) frame offset in parent frame
    body_quat: Any = None         # (nbody, 4)
    body_ipos: Any = None         # (nbody, 3) CoM in body frame
    body_iquat: Any = None        # (nbody, 4) principal-inertia frame
    body_mass: Any = None         # (nbody,)
    body_inertia: Any = None      # (nbody, 3) principal moments
    jnt_axis: Any = None          # (njnt, 3) in body frame
    jnt_pos: Any = None           # (njnt, 3) anchor in body frame
    jnt_range: Any = None         # (njnt, 2)
    jnt_limited: Any = None       # (njnt,)
    jnt_stiffness: Any = None     # (njnt,)
    jnt_ref: Any = None           # (njnt,)
    qpos0: Any = None             # (nq,)
    dof_damping: Any = None       # (nv,)
    dof_armature: Any = None      # (nv,)
    dof_limited: Any = None       # (nv,)
    dof_range: Any = None         # (nv, 2)
    dof_solref: Any = None        # (nv, 2)
    dof_solimp: Any = None        # (nv, 5) (d0, dwidth, width, mid, power)
    dof_stiffness: Any = None     # (nv,)
    dof_ref: Any = None           # (nv,)
    dof_margin: Any = None        # (nv,)
    dof_frictionloss: Any = None  # (nv,)
    dof_invweight0: Any = None    # (nv,) diag(M^-1) at qpos0
    limit_solref: Any = None      # (njnt, 2)
    limit_solimp: Any = None      # (njnt, 5)
    body_invweight0: Any = None   # (nbody, 2) mean CoM inv inertia (trn, rot)
    gear: Any = None              # (nu,)
    ctrlrange: Any = None         # (nu, 2)
    ctrllimited: Any = None       # (nu,)
    geom_pos: Any = None          # (ngeom, 3) in body frame
    geom_quat: Any = None         # (ngeom, 4)
    geom_size: Any = None         # (ngeom, 3)
    geom_friction: Any = None     # (ngeom, 3)
    geom_margin: Any = None       # (ngeom,)
    geom_solref: Any = None       # (ngeom, 2)
    geom_solimp: Any = None       # (ngeom, 5)
    site_pos: Any = None          # (nsite, 3)
    site_quat: Any = None         # (nsite, 4)
    timestep: Any = None          # scalar
    gravity: Any = None           # (3,)
    viscosity: Any = None         # scalar
    density: Any = None           # scalar (fluid medium density)


# ===========================================================================
# Host-side model building (numpy; runs once at env construction)
# ===========================================================================

_GEOM_TYPES = {"plane": PLANE, "sphere": SPHERE, "capsule": CAPSULE,
               "cylinder": CYLINDER, "box": BOX}
_JNT_TYPES = {"free": FREE, "ball": BALL, "slide": SLIDE, "hinge": HINGE}


def _np_quat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _zaxis_quat(z):
    """Quaternion rotating (0,0,1) onto unit vector z (for fromto geoms)."""
    z = np.asarray(z, np.float64)
    z = z / np.linalg.norm(z)
    a = np.cross([0.0, 0.0, 1.0], z)
    na = np.linalg.norm(a)
    w = 1.0 + z[2]
    if na < 1e-12 and w > 1e-8:        # aligned
        return np.array([1.0, 0, 0, 0])
    if na < 1e-12:                      # anti-aligned
        return np.array([0.0, 1.0, 0.0, 0.0])
    q = np.array([w, a[0], a[1], a[2]])
    return q / np.linalg.norm(q)


def _geom_mass_inertia(gtype, size, density, mass):
    """Mass and diagonal inertia (about geom CoM, in geom frame) for one
    geom, matching MuJoCo's inertiafromgeom compiler."""
    pi = np.pi
    if gtype == PLANE:
        return 0.0, np.zeros(3)
    if gtype == SPHERE:
        r = size[0]
        vol = 4.0 / 3.0 * pi * r ** 3
        m = mass if mass is not None else density * vol
        i = 0.4 * m * r * r
        return m, np.array([i, i, i])
    if gtype == CAPSULE:
        r, h = size[0], size[1]
        vc = pi * r * r * (2 * h)
        vs = 4.0 / 3.0 * pi * r ** 3
        if mass is not None:
            density = mass / (vc + vs)
        mc, ms = density * vc, density * vs
        m = mc + ms
        iz = 0.5 * mc * r * r + 0.4 * ms * r * r
        d = h + 0.375 * r  # hemisphere CoM offset from center: h + 3r/8
        ix = (mc * (r * r / 4.0 + h * h / 3.0)
              + ms * (83.0 / 320.0 * r * r + d * d))
        return m, np.array([ix, ix, iz])
    if gtype == CYLINDER:
        r, h = size[0], size[1]
        vol = pi * r * r * (2 * h)
        m = mass if mass is not None else density * vol
        iz = 0.5 * m * r * r
        ix = m * (r * r / 4.0 + h * h / 3.0)
        return m, np.array([ix, ix, iz])
    if gtype == BOX:
        a, b, c = size
        vol = 8.0 * a * b * c
        m = mass if mass is not None else density * vol
        return m, m / 3.0 * np.array([b * b + c * c, a * a + c * c,
                                      a * a + b * b])
    raise ValueError(f"unsupported geom type {gtype}")


def _invweights(model):
    """MuJoCo mj_setConst inverse-weight tables at qpos0:
    ``dof_invweight0 = diag(M0^-1)`` and ``body_invweight0[b] =
    (trace(Jc M0^-1 Jc^T)/3, trace(Jr M0^-1 Jr^T)/3)`` with Jc/Jr the
    CoM translational/rotational Jacobians.

    A small numpy composite-rigid-body evaluation for trees of slide and
    hinge joints: at qpos0 every joint sits at its reference, so body
    frames compose from ``body_pos``/``body_quat`` alone and
    ``M0 = sum_b m_b Jc_b^T Jc_b + Jr_b^T I_b Jr_b + diag(armature)``."""
    nb, nv = model.nbody, model.nv
    if any(t in (FREE, BALL) for t in model.jnt_type):
        raise NotImplementedError(
            "free/ball joints need the general 3D engine (ROADMAP.md M8)")
    xpos = np.zeros((nb, 3))
    xmat = np.tile(np.eye(3), (nb, 1, 1))
    for b in range(1, nb):
        pb = model.body_parent[b]
        xpos[b] = xpos[pb] + xmat[pb] @ model.body_pos[b]
        q = model.body_quat[b] / np.linalg.norm(model.body_quat[b])
        xmat[b] = xmat[pb] @ _np_quat_to_mat(q)
    xipos = np.stack([xpos[b] + xmat[b] @ model.body_ipos[b]
                      for b in range(nb)])
    # per-dof world axis / anchor and the body the dof belongs to
    axis_w = np.zeros((nv, 3))
    anchor_w = np.zeros((nv, 3))
    dof_body = [0] * nv
    hinge = np.zeros(nv)
    for j in range(model.njnt):
        d, b = model.jnt_dofadr[j], model.jnt_body[j]
        axis_w[d] = xmat[b] @ model.jnt_axis[j]
        anchor_w[d] = xpos[b] + xmat[b] @ model.jnt_pos[j]
        dof_body[d] = b
        hinge[d] = 1.0 if model.jnt_type[j] == HINGE else 0.0

    def ancestors(b):
        out = set()
        while b > 0:
            out.add(b)
            b = model.body_parent[b]
        return out

    m0 = np.diag(np.asarray(model.dof_armature, np.float64))
    jts, jrs = [None] * nb, [None] * nb
    for b in range(1, nb):
        anc = ancestors(b)
        jt = np.zeros((nv, 3))
        jr = np.zeros((nv, 3))
        for d in range(nv):
            if dof_body[d] not in anc:
                continue
            if hinge[d]:
                jr[d] = axis_w[d]
                jt[d] = np.cross(axis_w[d], xipos[b] - anchor_w[d])
            else:
                jt[d] = axis_w[d]
        ri = xmat[b] @ _np_quat_to_mat(
            model.body_iquat[b] / np.linalg.norm(model.body_iquat[b]))
        iw = ri @ np.diag(model.body_inertia[b]) @ ri.T
        m0 += model.body_mass[b] * (jt @ jt.T) + jr @ iw @ jr.T
        jts[b], jrs[b] = jt, jr
    minv = np.linalg.inv(m0)
    dof_iw = np.diag(minv).copy()
    body_iw = np.zeros((nb, 2))
    for b in range(1, nb):
        body_iw[b, 0] = np.trace(jts[b].T @ minv @ jts[b]) / 3.0
        body_iw[b, 1] = np.trace(jrs[b].T @ minv @ jrs[b]) / 3.0
    return dof_iw, body_iw


def _actuators_simple(actuators, joints):
    """True when every actuator is a plain motor on a scalar joint."""
    return all(joints[a["joint"]]["type"] not in (FREE, BALL)
               for a in actuators)


def _solver_id(solver):
    try:
        return {"penalty": PENALTY, "pgs": PGS, "newton": PGS,
                "implicit": PGS}[solver]
    except KeyError:
        raise ValueError(
            f"unknown solver {solver!r}: choose 'penalty' (explicit, fast,"
            " approximate) or 'newton' (implicit, MuJoCo-grade limits/"
            "contacts; aliases 'pgs', 'implicit')") from None


@dataclass
class _Body:
    parent: int
    pos: np.ndarray
    quat: np.ndarray
    joints: list = field(default_factory=list)
    geoms: list = field(default_factory=list)
    inertial: dict = None   # explicit <inertial> override (see add_body)


class ModelBuilder:
    def __init__(self, timestep=0.002, gravity=(0, 0, -9.81),
                 integrator="euler", viscosity=0.0, density=0.0,
                 settotalmass=None, cone="pyramidal", noslip_iterations=0):
        self.opt = dict(
            timestep=timestep, gravity=np.asarray(gravity, np.float64),
            integrator=EULER if integrator.lower() == "euler" else RK4,
            viscosity=viscosity, density=density,
            cone=ELLIPTIC if str(cone).lower() == "elliptic" else PYRAMIDAL,
            noslip_iters=int(noslip_iterations))
        # <compiler settotalmass="m"/>: rescale all body masses+inertias
        # after compilation so they sum to m (mujoco mj_setTotalmass)
        self.settotalmass = settotalmass
        # body 0 = world
        self.bodies = [_Body(parent=-1, pos=np.zeros(3),
                             quat=np.array([1.0, 0, 0, 0]))]
        self.joints = []
        self.geoms = []
        self.sites = []
        self.actuators = []
        self.names = {"body": {"world": 0}, "site": {}, "geom": {},
                      "joint": {}}

    # ---- declaration API -------------------------------------------------
    def add_body(self, parent, pos=(0, 0, 0), quat=(1, 0, 0, 0), name=None,
                 inertial=None):
        """``inertial``: optional explicit <inertial> spec overriding the
        inertiafromgeom computation — dict with mass, pos (CoM in body
        frame), diaginertia (3 principal moments) and optional quat
        (principal frame), exactly MuJoCo's explicit-inertial path."""
        self.bodies.append(_Body(parent=parent,
                                 pos=np.asarray(pos, np.float64),
                                 quat=np.asarray(quat, np.float64),
                                 inertial=inertial))
        bid = len(self.bodies) - 1
        if name:
            self.names["body"][name] = bid
        return bid

    def add_joint(self, body, jnt_type, axis=(0, 0, 1), pos=(0, 0, 0),
                  jnt_range=None, damping=0.0, armature=0.0, stiffness=0.0,
                  ref=0.0, limited=None, solref=(0.02, 1.0),
                  solimp=(0.9, 0.95, 0.001, 0.5, 2.0), margin=0.0,
                  frictionloss=0.0, name=None):
        if _JNT_TYPES[jnt_type] in (FREE, BALL):
            raise NotImplementedError(
                "free/ball joints need the general 3D engine "
                "(ROADMAP.md M8)")
        if limited is None:
            limited = jnt_range is not None
        jid = len(self.joints)
        axis = np.asarray(axis, np.float64)
        axis = axis / np.linalg.norm(axis)
        self.joints.append(dict(
            body=body, type=_JNT_TYPES[jnt_type], axis=axis,
            pos=np.asarray(pos, np.float64),
            range=np.asarray(jnt_range if jnt_range is not None
                             else (0.0, 0.0), np.float64),
            limited=float(bool(limited)), damping=damping, armature=armature,
            stiffness=stiffness, ref=ref,
            solref=np.asarray(solref, np.float64),
            solimp=np.asarray(solimp, np.float64), margin=float(margin),
            frictionloss=float(frictionloss)))
        self.bodies[body].joints.append(jid)
        if name:
            self.names["joint"][name] = jid
        return jid

    def add_geom(self, body, gtype, size=(0, 0, 0), pos=(0, 0, 0),
                 quat=(1, 0, 0, 0), fromto=None, density=1000.0, mass=None,
                 contype=1, conaffinity=1, friction=(1.0, 0.005, 0.0001),
                 margin=0.0, solref=(0.02, 1.0),
                 solimp=(0.9, 0.95, 0.001, 0.5, 2.0), condim=3, name=None):
        if condim not in (1, 3, 4, 6):
            raise NotImplementedError(
                f"condim {condim} not supported (1 = frictionless, 3 = "
                "tangential, 4 = +torsional, 6 = +rolling friction)")
        size = np.array(list(size) + [0.0] * (3 - len(size)), np.float64)
        pos = np.asarray(pos, np.float64)
        quat = np.asarray(quat, np.float64)
        if fromto is not None:
            f = np.asarray(fromto, np.float64)
            a, b = f[:3], f[3:]
            pos = 0.5 * (a + b)
            quat = _zaxis_quat(b - a)
            size = np.array([size[0], 0.5 * np.linalg.norm(b - a), 0.0])
        gid = len(self.geoms)
        self.geoms.append(dict(
            body=body, type=_GEOM_TYPES[gtype], size=size, pos=pos, quat=quat,
            density=density, mass=mass, contype=int(contype),
            conaffinity=int(conaffinity),
            friction=np.asarray(friction, np.float64), margin=margin,
            solref=np.asarray(solref, np.float64),
            solimp=np.asarray(solimp, np.float64), condim=int(condim)))
        self.bodies[body].geoms.append(gid)
        if name:
            self.names["geom"][name] = gid
        return gid

    def add_site(self, body, pos=(0, 0, 0), quat=(1, 0, 0, 0), name=None):
        sid = len(self.sites)
        self.sites.append(dict(body=body, pos=np.asarray(pos, np.float64),
                               quat=np.asarray(quat, np.float64)))
        if name:
            self.names["site"][name] = sid
        return sid

    def add_actuator(self, joint, gear=1.0, ctrlrange=(-1.0, 1.0),
                     ctrllimited=True):
        """Plain motor on a slide/hinge joint.  Servo gains/biases, vector
        gears and tendon transmissions belong to the general engine
        (ROADMAP.md M8)."""
        self.actuators.append(dict(
            joint=joint, gear=float(gear),
            ctrlrange=np.asarray(ctrlrange, np.float64),
            ctrllimited=float(bool(ctrllimited))))
        return len(self.actuators) - 1

    def _general_engine_only(self, *args, **kwargs):
        raise NotImplementedError(
            "tendons, equalities and explicit contact pairs need the "
            "general 3D engine and solver (ROADMAP.md M8/M9)")

    add_contact_pair = add_contact_exclude = add_tendon = \
        add_equality_joint = add_equality_connect = add_equality_weld = \
        _general_engine_only

    # ---- compilation ------------------------------------------------------
    def _body_inertial(self, body):
        """Combine geom inertias -> (mass, ipos, iquat, principal inertia).
        An explicit <inertial> spec (add_body inertial=...) wins outright,
        matching MuJoCo's inertiafromgeom="auto" default."""
        if body.inertial is not None:
            inr = body.inertial
            q = np.asarray(inr.get("quat", (1.0, 0, 0, 0)), np.float64)
            return (float(inr["mass"]),
                    np.asarray(inr.get("pos", (0.0, 0, 0)), np.float64),
                    q / np.linalg.norm(q),
                    np.asarray(inr["diaginertia"], np.float64))
        total_m = 0.0
        com = np.zeros(3)
        for gid in body.geoms:
            g = self.geoms[gid]
            m, _ = _geom_mass_inertia(g["type"], g["size"], g["density"],
                                      g["mass"])
            total_m += m
            com += m * g["pos"]
        if total_m < 1e-12:
            return 0.0, np.zeros(3), np.array([1.0, 0, 0, 0]), np.zeros(3)
        com = com / total_m
        if len(body.geoms) == 1:
            # single geom: inertia is diagonal in the geom frame — use it
            # directly (matches MuJoCo; with anisotropic fluid drag the
            # *choice* of principal axes in a degenerate subspace is
            # physically meaningful, so eigh's arbitrary basis won't do).
            g = self.geoms[body.geoms[0]]
            m, idiag = _geom_mass_inertia(g["type"], g["size"], g["density"],
                                          g["mass"])
            return m, g["pos"].copy(), \
                g["quat"] / np.linalg.norm(g["quat"]), idiag
        itot = np.zeros((3, 3))
        for gid in body.geoms:
            g = self.geoms[gid]
            m, idiag = _geom_mass_inertia(g["type"], g["size"], g["density"],
                                          g["mass"])
            r = _np_quat_to_mat(g["quat"])
            i_body = r @ np.diag(idiag) @ r.T
            d = g["pos"] - com
            i_body += m * (np.dot(d, d) * np.eye(3) - np.outer(d, d))
            itot += i_body
        evals, evecs = np.linalg.eigh(itot)
        # descending order like MuJoCo
        order = np.argsort(evals)[::-1]
        evals = evals[order]
        evecs = evecs[:, order]
        if np.linalg.det(evecs) < 0:
            evecs[:, 2] *= -1
        # rotation matrix -> quaternion
        t = np.trace(evecs)
        if t > 0:
            s = np.sqrt(t + 1.0) * 2
            q = np.array([0.25 * s, (evecs[2, 1] - evecs[1, 2]) / s,
                          (evecs[0, 2] - evecs[2, 0]) / s,
                          (evecs[1, 0] - evecs[0, 1]) / s])
        else:
            i = np.argmax(np.diag(evecs))
            j, k = (i + 1) % 3, (i + 2) % 3
            s = np.sqrt(1.0 + evecs[i, i] - evecs[j, j] - evecs[k, k]) * 2
            q = np.zeros(4)
            q[0] = (evecs[k, j] - evecs[j, k]) / s
            q[1 + i] = 0.25 * s
            q[1 + j] = (evecs[j, i] + evecs[i, j]) / s
            q[1 + k] = (evecs[k, i] + evecs[i, k]) / s
        q = q / np.linalg.norm(q)
        return total_m, com, q, np.maximum(evals, 0.0)

    def _contact_pairs(self):
        """MuJoCo dynamic pair filtering -> (pairs, pair_condims):
        different bodies, not parent-child, (contype1 & conaffinity2) or
        (contype2 & conaffinity1); condim = max of geom condims."""
        pairs, condims = [], []
        for i, g1 in enumerate(self.geoms):
            for j in range(i + 1, len(self.geoms)):
                g2 = self.geoms[j]
                b1, b2 = g1["body"], g2["body"]
                if b1 == b2:
                    continue
                p1, p2 = self.bodies[b1].parent, self.bodies[b2].parent
                # exclude parent-child (world-body geoms like floors are
                # exempt from the parent-child exclusion)
                if (p1 == b2 and b2 != 0) or (p2 == b1 and b1 != 0):
                    continue
                if (g1["contype"] & g2["conaffinity"]) or \
                   (g2["contype"] & g1["conaffinity"]):
                    pairs.append((i, j))
                    condims.append(max(g1["condim"], g2["condim"]))
        return tuple(pairs), tuple(condims)

    def _sort_by_body(self):
        """MuJoCo orders geoms/sites grouped by body in tree order."""
        for kind, items in (("geom", self.geoms), ("site", self.sites)):
            order = sorted(range(len(items)), key=lambda i: items[i]["body"])
            remap = {old: new for new, old in enumerate(order)}
            items[:] = [items[i] for i in order]
            self.names[kind] = {k: remap[v]
                                for k, v in self.names[kind].items()}
            if kind == "geom":
                for b in self.bodies:
                    b.geoms = [remap[g] for g in b.geoms]

    def finalize(self, solver="penalty"):
        """Compile the declarations into a (float64, numpy) ``Model``."""
        self._sort_by_body()
        nbody = len(self.bodies)
        njnt = len(self.joints)
        nu = len(self.actuators)
        ngeom = len(self.geoms)
        nsite = len(self.sites)

        mass = np.zeros(nbody)
        ipos = np.zeros((nbody, 3))
        iquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
        inertia = np.zeros((nbody, 3))
        # body 0 is the static world: zero mass regardless of its geoms
        for b in range(1, nbody):
            m, c, q, i = self._body_inertial(self.bodies[b])
            mass[b], ipos[b], iquat[b], inertia[b] = m, c, q, i
        if self.settotalmass is not None and self.settotalmass > 0 \
                and mass.sum() > 0:
            scale = float(self.settotalmass) / mass.sum()
            mass *= scale
            inertia *= scale

        def arr(x, *shape):
            a = np.asarray(x, np.float64)
            return a.reshape(shape) if shape else a

        j = self.joints
        jnt_qposadr, jnt_dofadr = [], []
        nq = nv = 0
        for x in j:
            jnt_qposadr.append(nq)
            jnt_dofadr.append(nv)
            nq += JNT_NQ[x["type"]]
            nv += JNT_NV[x["type"]]

        # per-dof tables
        dof_damping = np.zeros(nv)
        dof_armature = np.zeros(nv)
        dof_limited = np.zeros(nv)
        dof_range = np.zeros((nv, 2))
        dof_solref = np.tile([0.02, 1.0], (nv, 1))
        dof_solimp = np.tile([0.9, 0.95, 0.001, 0.5, 2.0], (nv, 1))
        dof_stiffness = np.zeros(nv)
        dof_ref = np.zeros(nv)
        dof_margin = np.zeros(nv)
        dof_frictionloss = np.zeros(nv)
        dof_qpos_idx = np.zeros(nv, np.int64)
        qpos0 = np.zeros(nq)
        for ji, x in enumerate(j):
            qa, da = jnt_qposadr[ji], jnt_dofadr[ji]
            dof_damping[da] = x["damping"]
            dof_armature[da] = x["armature"]
            qpos0[qa] = x["ref"]
            dof_limited[da] = x["limited"]
            dof_range[da] = x["range"]
            dof_solref[da] = x["solref"]
            dof_solimp[da] = x["solimp"]
            dof_stiffness[da] = x["stiffness"]
            dof_ref[da] = x["ref"]
            dof_margin[da] = x["margin"]
            dof_qpos_idx[da] = qa
            dof_frictionloss[da] = x["frictionloss"]

        pairs_, pair_condim_ = self._contact_pairs()

        model = Model(
            nbody=nbody, njnt=njnt, nq=nq, nv=nv, nu=nu, ngeom=ngeom,
            nsite=nsite,
            body_parent=tuple(b.parent for b in self.bodies),
            body_jnts=tuple(tuple(b.joints) for b in self.bodies),
            jnt_type=tuple(x["type"] for x in j),
            jnt_body=tuple(x["body"] for x in j),
            jnt_qposadr=tuple(jnt_qposadr),
            jnt_dofadr=tuple(jnt_dofadr),
            geom_body=tuple(g["body"] for g in self.geoms),
            geom_type=tuple(g["type"] for g in self.geoms),
            geom_condim=tuple(g["condim"] for g in self.geoms),
            site_body=tuple(s["body"] for s in self.sites),
            actuator_joint=tuple(a["joint"] for a in self.actuators),
            integrator=self.opt["integrator"],
            solver=_solver_id(solver),
            cone=self.opt["cone"],
            noslip_iters=self.opt["noslip_iters"],
            contact_pairs=pairs_,
            contact_pair_condim=pair_condim_,
            actuator_simple=_actuators_simple(self.actuators, j),
            dof_qpos_idx=tuple(int(i) for i in dof_qpos_idx),
            body_pos=arr([b.pos for b in self.bodies]),
            body_quat=arr([b.quat for b in self.bodies]),
            body_ipos=ipos, body_iquat=iquat,
            body_mass=mass, body_inertia=inertia,
            jnt_axis=arr([x["axis"] for x in j], njnt, 3),
            jnt_pos=arr([x["pos"] for x in j], njnt, 3),
            jnt_range=arr([x["range"] for x in j], njnt, 2),
            jnt_limited=arr([x["limited"] for x in j], njnt),
            jnt_stiffness=arr([x["stiffness"] for x in j], njnt),
            jnt_ref=arr([x["ref"] for x in j], njnt),
            qpos0=qpos0,
            dof_damping=dof_damping,
            dof_armature=dof_armature,
            dof_limited=dof_limited,
            dof_range=dof_range,
            dof_margin=dof_margin,
            dof_frictionloss=dof_frictionloss,
            dof_solref=dof_solref,
            dof_solimp=dof_solimp,
            dof_stiffness=dof_stiffness,
            dof_ref=dof_ref,
            limit_solref=arr([x["solref"] for x in j], njnt, 2),
            limit_solimp=arr([x["solimp"] for x in j], njnt, 5),
            gear=arr([a["gear"] for a in self.actuators], nu),
            ctrlrange=arr([a["ctrlrange"] for a in self.actuators], nu, 2),
            ctrllimited=arr([a["ctrllimited"] for a in self.actuators], nu),
            geom_pos=arr([g["pos"] for g in self.geoms], ngeom, 3),
            geom_quat=arr([g["quat"] for g in self.geoms], ngeom, 4),
            geom_size=arr([g["size"] for g in self.geoms], ngeom, 3),
            geom_friction=arr([g["friction"] for g in self.geoms], ngeom, 3),
            geom_margin=arr([g["margin"] for g in self.geoms], ngeom),
            geom_solref=arr([g["solref"] for g in self.geoms], ngeom, 2),
            geom_solimp=arr([g["solimp"] for g in self.geoms], ngeom, 5),
            site_pos=arr([s["pos"] for s in self.sites], nsite, 3),
            site_quat=arr([s["quat"] for s in self.sites], nsite, 4),
            timestep=arr(self.opt["timestep"]),
            gravity=arr(self.opt["gravity"]),
            viscosity=arr(self.opt["viscosity"]),
            density=arr(self.opt["density"]),
        )
        dof_iw, body_iw = _invweights(model)
        return replace(model, dof_invweight0=dof_iw, body_invweight0=body_iw)


@dataclass
class State:
    """Dynamic physics state of a batch of environments: ``qpos`` and
    ``qvel`` are ``(B, nq)`` / ``(B, nv)`` tensors."""
    qpos: Any
    qvel: Any
