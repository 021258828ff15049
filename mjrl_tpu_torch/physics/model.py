"""Static model description for the rigid-body engine (host side, numpy).

Counterpart of ``mjrl_tpu/physics/model.py``.  ``ModelBuilder`` turns
body/joint/geom/site/actuator declarations into a ``Model`` — a plain
dataclass of float64 numpy arrays and static topology tuples — computing
per-body mass, CoM and principal inertia from geoms like MuJoCo's
``inertiafromgeom`` compiler path.

Ported: slide, hinge, ball (3 dofs / 4 qpos: a local wxyz quaternion,
angular velocity in the post-joint body frame) and free joints (6 dofs /
7 qpos: world position + wxyz quaternion, on a direct child of the world),
ball rotation limits, quaternion springs, the affine actuator family
(motors, position/velocity servos, general gain/bias) on joint
transmissions with scalar or vector gears (ball: 3, free: 6) and on
fixed-tendon transmissions, fixed tendons (passive spring/damper and
length limits), equality constraints (joint coupling, connect, weld),
geoms (inertia and the contact pairs with their condim, friction,
solref/solimp: the dynamic contype/conaffinity pairs minus excluded body
pairs, plus explicit ``<contact><pair>``s with their own condim), the
implicit solver's ``contact_topk`` active-set cap, its
``row_freeze_step`` option and its primal Newton iterations, Euler and
RK4, both friction cones and the noslip post-pass.
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
    # implicit-solver active-set cap: a condim class with more emitted
    # contact slots than this gives rows to its contact_topk deepest only
    # (0 = no cap)
    contact_topk: int = 0
    # RK4 under the implicit solver: freeze the substep-0 constraint rows
    # across the stages and the whole control step (quasi-static contact
    # models); False rebuilds them at every stage, as MuJoCo does
    row_freeze_step: bool = False
    # primal-Newton constraint solver iterations (0 = the dual APGD);
    # pyramidal cones only
    newton_iters: int = 0
    # per-actuator tendon transmission id (-1 = joint transmission)
    actuator_tendon: Tuple[int, ...] = ()
    # equality constraints: kind (EQ_*), obj1/obj2 (joint or body ids,
    # obj2 -1 = none / 0 = the world for body kinds)
    eq_kind: Tuple[int, ...] = ()
    eq_obj1: Tuple[int, ...] = ()
    eq_obj2: Tuple[int, ...] = ()
    dof_qpos_idx: Tuple[int, ...] = ()
    # ball/free joints with nonzero stiffness (quaternion springs)
    jnt_spring_quat: Tuple[int, ...] = ()

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
    # affine actuators: f = gain * ctrl + b0 + b1 length + b2 velocity
    actuator_gain: Any = None     # (nu,)
    actuator_bias: Any = None     # (nu, 3)
    actuator_gearv: Any = None    # (nu, 6) vector gear (ball: :3, free: :6)
    # equality data in MuJoCo's layout per kind: joint [0:5] quartic
    # polycoef; connect [0:3] anchor on body1, [3:6] anchor on body2; weld
    # [0:3] anchor on body2, [3:6] anchor on body1, [6:10] relpose quat,
    # [10] torquescale
    eq_data: Any = None           # (neq, 11)
    eq_solref: Any = None         # (neq, 2)
    eq_solimp: Any = None         # (neq, 5)
    eq_active: Any = None         # (neq,)
    geom_pos: Any = None          # (ngeom, 3) in body frame
    geom_quat: Any = None         # (ngeom, 4)
    geom_size: Any = None         # (ngeom, 3)
    geom_friction: Any = None     # (ngeom, 3)
    geom_margin: Any = None       # (ngeom,)
    geom_solref: Any = None       # (ngeom, 2)
    geom_solimp: Any = None       # (ngeom, 5)
    site_pos: Any = None          # (nsite, 3)
    site_quat: Any = None         # (nsite, 4)
    # fixed tendons: length = ten_J @ (scalar-dof qpos), a constant Jacobian
    ten_J: Any = None             # (ntendon, nv)
    ten_range: Any = None         # (ntendon, 2)
    ten_limited: Any = None       # (ntendon,)
    ten_solref: Any = None        # (ntendon, 2) limit solref
    ten_solimp: Any = None        # (ntendon, 5) limit solimp
    ten_stiffness: Any = None     # (ntendon,)
    ten_damping: Any = None       # (ntendon,)
    ten_springlength: Any = None  # (ntendon, 2) deadband [lo, hi]
    ten_invweight0: Any = None    # (ntendon,) diag(J M0^-1 J^T)
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


def _frames0(model):
    """World body frames at qpos0 (xpos (nbody, 3), xmat (nbody, 3, 3)):
    every joint sits at its reference there, so the frames compose from
    ``body_pos``/``body_quat`` alone."""
    xpos = np.zeros((model.nbody, 3))
    xmat = np.tile(np.eye(3), (model.nbody, 1, 1))
    for b in range(1, model.nbody):
        pb = model.body_parent[b]
        xpos[b] = xpos[pb] + xmat[pb] @ model.body_pos[b]
        q = model.body_quat[b] / np.linalg.norm(model.body_quat[b])
        xmat[b] = xmat[pb] @ _np_quat_to_mat(q)
    return xpos, xmat


def _np_quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _np_mat_to_quat(m):
    """Rotation matrix -> wxyz quaternion (largest-component branch)."""
    t = np.trace(m)
    cand = np.array([1.0 + t,
                     1.0 + m[0, 0] - m[1, 1] - m[2, 2],
                     1.0 - m[0, 0] + m[1, 1] - m[2, 2],
                     1.0 - m[0, 0] - m[1, 1] + m[2, 2]])
    k = int(np.argmax(cand))
    s = 2.0 * np.sqrt(max(cand[k], 1e-12))
    if k == 0:
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s,
             (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    elif k == 1:
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s,
             (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
    elif k == 2:
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s,
             0.25 * s, (m[1, 2] + m[2, 1]) / s]
    else:
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s,
             (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def _invweights(model):
    """MuJoCo mj_setConst inverse-weight tables at qpos0:
    ``dof_invweight0 = diag(M0^-1)``, ``body_invweight0[b] =
    (trace(Jc M0^-1 Jc^T)/3, trace(Jr M0^-1 Jr^T)/3)`` with Jc/Jr the
    CoM translational/rotational Jacobians, and ``ten_invweight0 =
    diag(ten_J M0^-1 ten_J^T)``.

    A small numpy composite-rigid-body evaluation in float64: at qpos0
    every joint sits at its reference (hinge/slide at ``ref``, ball at the
    identity, free at the body's own pose), so body frames compose from
    ``body_pos``/``body_quat`` alone and ``M0 = sum_b m_b Jc_b^T Jc_b +
    Jr_b^T I_b Jr_b + diag(armature)``.  Each dof is a rotation about a
    world axis through an anchor (hinge; ball and the free joint's last
    three: the body frame's axes) or a translation along a world axis
    (slide; the free joint's first three), as in
    ``dynamics.compute_cdof``."""
    nb, nv = model.nbody, model.nv
    xpos, xmat = _frames0(model)
    xipos = np.stack([xpos[b] + xmat[b] @ model.body_ipos[b]
                      for b in range(nb)])
    # per-dof world axis / anchor, whether it rotates, and its body
    axis_w = np.zeros((nv, 3))
    anchor_w = np.zeros((nv, 3))
    dof_body = [0] * nv
    rot = np.zeros(nv)
    for j in range(model.njnt):
        d, b, jt = model.jnt_dofadr[j], model.jnt_body[j], model.jnt_type[j]
        anchor = xpos[b] + xmat[b] @ model.jnt_pos[j]
        if jt == FREE:
            axis_w[d:d + 3] = np.eye(3)
            axis_w[d + 3:d + 6] = xmat[b].T
            anchor_w[d + 3:d + 6] = xpos[b]
            rot[d + 3:d + 6] = 1.0
        elif jt == BALL:
            axis_w[d:d + 3] = xmat[b].T
            anchor_w[d:d + 3] = anchor
            rot[d:d + 3] = 1.0
        else:
            axis_w[d] = xmat[b] @ model.jnt_axis[j]
            anchor_w[d] = anchor
            rot[d] = 1.0 if jt == HINGE else 0.0
        dof_body[d:d + JNT_NV[jt]] = [b] * JNT_NV[jt]

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
            if rot[d]:
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
    tj = np.asarray(model.ten_J, np.float64)
    return dof_iw, body_iw, np.einsum("ti,ij,tj->t", tj, minv, tj)


def _actuators_simple(actuators, joints):
    """True when every actuator is a plain motor on a scalar joint (the
    one-scatter path of ``dynamics.actuator_force``)."""
    return all(a["tendon"] < 0
               and joints[a["joint"]]["type"] not in (FREE, BALL)
               and not np.any(a["bias"]) and a["gain"] == 1.0
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
        self.tendons = []
        self.equalities = []
        # explicit <contact><pair> declarations (g1, g2, condim or None)
        # and <exclude> body pairs (b1, b2)
        self.explicit_pairs = []
        self.excluded_body_pairs = []
        self.names = {"body": {"world": 0}, "site": {}, "geom": {},
                      "joint": {}, "tendon": {}}

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
        if limited is None:
            limited = jnt_range is not None
        if _JNT_TYPES[jnt_type] == FREE:
            limited = False
            if self.bodies[body].parent != 0:
                raise ValueError(
                    "free joints require a direct child of the world")
        if _JNT_TYPES[jnt_type] == BALL and limited:
            # MuJoCo ball limits constrain the total rotation angle to
            # range[1] (range[0] must be 0)
            if jnt_range is None or float(jnt_range[0]) != 0.0:
                raise ValueError("ball joint range must be (0, max_angle)")
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

    def add_tendon(self, joints, ten_range=None, limited=None,
                   stiffness=0.0, damping=0.0, springlength=None,
                   solref=(0.02, 1.0), solimp=(0.9, 0.95, 0.001, 0.5, 2.0),
                   name=None):
        """Fixed tendon (MuJoCo <tendon><fixed>): length = sum coef *
        qpos over the listed scalar joints.  ``joints`` is a list of
        (joint_id, coef).  ``springlength`` is the deadband pair [lo, hi]
        (a scalar = both); None or (-1, -1) = (0, 0), the MuJoCo
        compiler's sentinel resolution."""
        for jid, _ in joints:
            if self.joints[jid]["type"] not in (SLIDE, HINGE):
                raise ValueError(
                    "fixed tendons couple scalar (slide/hinge) joints only")
        if limited is None:
            limited = ten_range is not None
        if springlength is not None:
            springlength = np.atleast_1d(
                np.asarray(springlength, np.float64))
            if len(springlength) == 1:
                springlength = np.repeat(springlength, 2)
        self.tendons.append(dict(
            joints=[(int(j), float(c)) for j, c in joints],
            range=np.asarray(ten_range if ten_range is not None
                             else (0.0, 0.0), np.float64),
            limited=float(bool(limited)), stiffness=float(stiffness),
            damping=float(damping), springlength=springlength,
            solref=np.asarray(solref, np.float64),
            solimp=np.asarray(solimp, np.float64)))
        tid = len(self.tendons) - 1
        if name:
            self.names["tendon"][name] = tid
        return tid

    def add_contact_pair(self, geom1, geom2, condim=None):
        """Explicit <contact><pair>: always a collision candidate,
        whatever the geoms' contype/conaffinity; ``condim`` overrides the
        geom-max rule (None keeps it)."""
        if condim is not None and int(condim) not in (1, 3, 4, 6):
            raise NotImplementedError(
                f"pair condim {condim} not supported (1 = frictionless, "
                "3 = tangential, 4 = +torsional, 6 = +rolling friction)")
        self.explicit_pairs.append((int(geom1), int(geom2),
                                    None if condim is None else int(condim)))

    def add_contact_exclude(self, body1, body2):
        """<contact><exclude>: drop every dynamic geom pair between the two
        bodies (explicit pairs are not excluded, as in MuJoCo)."""
        self.excluded_body_pairs.append((int(body1), int(body2)))

    def _add_equality(self, kind, obj1, obj2, data, solref, solimp, active):
        self.equalities.append(dict(
            kind=kind, obj1=int(obj1), obj2=int(obj2), data=data,
            solref=np.asarray(solref, np.float64),
            solimp=np.asarray(solimp, np.float64),
            active=float(bool(active))))
        return len(self.equalities) - 1

    def add_equality_joint(self, joint1, joint2=None,
                           polycoef=(0.0, 1.0, 0.0, 0.0, 0.0),
                           solref=(0.02, 1.0),
                           solimp=(0.9, 0.95, 0.001, 0.5, 2.0),
                           active=True):
        """Quartic joint coupling (MuJoCo <equality><joint>): (q1 - q1_0)
        = poly(q2 - q2_0); joint2 None pins joint1 at q1_0 +
        polycoef[0]."""
        for jid in (joint1,) + (() if joint2 is None else (joint2,)):
            if self.joints[jid]["type"] not in (SLIDE, HINGE):
                raise ValueError("joint equality couples scalar "
                                 "(slide/hinge) joints only")
        data = np.zeros(11)
        data[:5] = np.asarray(polycoef, np.float64)[:5]
        data[10] = 1.0      # MuJoCo stores the default torquescale
        return self._add_equality(EQ_JOINT, joint1,
                                  -1 if joint2 is None else joint2, data,
                                  solref, solimp, active)

    def add_equality_connect(self, body1, body2, anchor,
                             solref=(0.02, 1.0),
                             solimp=(0.9, 0.95, 0.001, 0.5, 2.0),
                             active=True):
        """3-dof connect (MuJoCo <equality><connect>): ``anchor`` in
        body1's frame; the coincident body2-local point is taken at qpos0
        by ``finalize`` (the compiler's rule).  body2 = 0: the world."""
        data = np.zeros(11)
        data[:3] = np.asarray(anchor, np.float64)
        data[3:6] = np.nan                # resolved at finalize
        data[10] = 1.0
        return self._add_equality(EQ_CONNECT, body1, body2, data, solref,
                                  solimp, active)

    def add_equality_weld(self, body1, body2, anchor=(0, 0, 0),
                          relpose=None, torquescale=1.0,
                          solref=(0.02, 1.0),
                          solimp=(0.9, 0.95, 0.001, 0.5, 2.0),
                          active=True):
        """6-dof weld (MuJoCo <equality><weld>): body1's pose locked to
        body2's.  ``anchor`` in body2's frame; ``relpose`` = (pos 3, quat
        4) of body1 relative to body2, or None / an all-zero quat to take
        the relative pose at qpos0 in ``finalize``; ``torquescale`` scales
        the 3 orientation rows against the 3 position rows."""
        data = np.zeros(11)
        data[:3] = np.asarray(anchor, np.float64)
        if relpose is None:
            data[3:10] = np.nan           # resolved at finalize
        else:
            rp = np.asarray(relpose, np.float64)
            if rp.shape != (7,):
                raise ValueError("relpose = (pos 3, quat 4)")
            data[3:10] = rp
            if not np.any(rp[3:]):        # the all-zero quat sentinel
                data[6:10] = np.nan
        data[10] = float(torquescale)
        return self._add_equality(EQ_WELD, body1, body2, data, solref,
                                  solimp, active)

    def add_actuator(self, joint=None, gear=1.0, ctrlrange=(-1.0, 1.0),
                     ctrllimited=True, gain=1.0, bias=(0.0, 0.0, 0.0),
                     tendon=None):
        """Affine actuator (MuJoCo gaintype fixed, biastype affine) on a
        joint or fixed-tendon transmission: f = gain * ctrl + b0 + b1
        length + b2 velocity.  ``gear`` is a scalar for slide, hinge and
        tendon, a vector of 3 for ball and 6 for free joints.  Motor: the
        defaults; position servo: gain kp, bias (0, -kp, -kv); velocity
        servo: gain kv, bias (0, 0, -kv)."""
        if (joint is None) == (tendon is None):
            raise ValueError("actuator needs exactly one of joint= or "
                             "tendon=")
        gear = np.atleast_1d(np.asarray(gear, np.float64))
        need = 1 if tendon is not None else \
            {FREE: 6, BALL: 3}.get(self.joints[joint]["type"], 1)
        if len(gear) == 1 and need > 1:
            gear = np.concatenate([gear, np.zeros(need - 1)])
        if len(gear) < need:
            raise ValueError(f"gear needs {need} elements for this joint "
                             "type")
        gearv = np.zeros(6)
        gearv[:len(gear[:6])] = gear[:6]
        self.actuators.append(dict(
            joint=-1 if joint is None else joint,
            tendon=-1 if tendon is None else tendon,
            gear=float(gearv[0]), gearv=gearv,
            gain=float(gain), bias=np.asarray(bias, np.float64),
            ctrlrange=np.asarray(ctrlrange, np.float64),
            ctrllimited=float(bool(ctrllimited))))
        return len(self.actuators) - 1

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
        """MuJoCo pair filtering -> (pairs, pair_condims).

        Dynamic pairs: different bodies, not parent-child, (contype1 &
        conaffinity2) or (contype2 & conaffinity1), minus excluded body
        pairs; condim = max of the geom condims.  Explicit pairs follow,
        deduplicated against the dynamic set and each other (the last
        declaration's condim wins; a pair declared twice is kept once, as
        the JAX package keeps it).  Excludes do not touch them."""
        excl = {tuple(sorted(p)) for p in self.excluded_body_pairs}
        pairs, condims = [], []
        for i, g1 in enumerate(self.geoms):
            for j in range(i + 1, len(self.geoms)):
                g2 = self.geoms[j]
                b1, b2 = g1["body"], g2["body"]
                if b1 == b2 or tuple(sorted((b1, b2))) in excl:
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
        index = {p: k for k, p in enumerate(pairs)}
        for i, j, cd in self.explicit_pairs:
            key = (i, j) if i < j else (j, i)
            cd = (max(self.geoms[i]["condim"], self.geoms[j]["condim"])
                  if cd is None else cd)
            if key in index:
                condims[index[key]] = cd
            else:
                index[key] = len(pairs)
                pairs.append(key)
                condims.append(cd)
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
                self.explicit_pairs = [(remap[i], remap[j], cd)
                                       for i, j, cd in self.explicit_pairs]

    def finalize(self, solver="penalty", dtype=np.float64, newton_iters=0,
                 contact_topk=None, row_freeze_step=False):
        """Compile the declarations into a numpy ``Model``.

        ``dtype``: every numeric field is rounded to this precision (and
        then held as float64), as the JAX package stores a float32 model
        when an env is built in float32 — its ``timestep`` 0.002 then reads
        0.0020000000949949026, and the constants baked into the kernels
        follow.  ``contact_topk``: the implicit solver's active-set cap
        (see Model); None = 64 when the model emits more than 64 contact
        slots, else no cap.  ``row_freeze_step``: freeze the RK4
        constraint rows for the whole control step (see Model).
        ``newton_iters > 0`` switches the implicit solver to the primal
        Newton solver with that many iterations (pyramidal cones)."""
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
            a = np.asarray(x, np.float64).astype(dtype).astype(np.float64)
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
            ndof = JNT_NV[x["type"]]
            dof_damping[da:da + ndof] = x["damping"]
            dof_armature[da:da + ndof] = x["armature"]
            if x["type"] == FREE:
                body = self.bodies[x["body"]]
                qpos0[qa:qa + 3] = body.pos
                qpos0[qa + 3:qa + 7] = body.quat / np.linalg.norm(body.quat)
                dof_qpos_idx[da:da + ndof] = qa    # unused (unlimited)
            elif x["type"] == BALL:
                qpos0[qa] = 1.0                    # identity quaternion
                dof_qpos_idx[da:da + ndof] = qa    # unused (unlimited)
            else:
                qpos0[qa] = x["ref"]
                dof_limited[da] = x["limited"]
                dof_range[da] = x["range"]
                dof_solref[da] = x["solref"]
                dof_solimp[da] = x["solimp"]
                dof_stiffness[da] = x["stiffness"]
                dof_ref[da] = x["ref"]
                dof_margin[da] = x["margin"]
                dof_qpos_idx[da] = qa
            # dry friction applies to every dof but the free joint's
            if x["type"] != FREE:
                dof_frictionloss[da:da + ndof] = x["frictionloss"]

        # fixed-tendon tables: a constant Jacobian over scalar dofs; the
        # exact (-1, -1) springlength sentinel resolves to (0, 0), any other
        # value is literal
        ntendon = len(self.tendons)
        ten_J = np.zeros((ntendon, nv))
        ten_spring = np.zeros((ntendon, 2))
        for ti, x in enumerate(self.tendons):
            for jid, coef in x["joints"]:
                ten_J[ti, jnt_dofadr[jid]] += coef
            sl = x["springlength"]
            if sl is None or (sl[0] == -1 and sl[1] == -1):
                sl = np.zeros(2)
            ten_spring[ti] = sl
        tn = self.tendons

        pairs_, pair_condim_ = self._contact_pairs()
        eqs = self.equalities
        neq = len(eqs)

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
            jnt_spring_quat=tuple(
                ji for ji, x in enumerate(j)
                if x["type"] in (BALL, FREE) and x["stiffness"]),
            body_pos=arr([b.pos for b in self.bodies]),
            body_quat=arr([b.quat for b in self.bodies]),
            body_ipos=arr(ipos), body_iquat=arr(iquat),
            body_mass=arr(mass), body_inertia=arr(inertia),
            jnt_axis=arr([x["axis"] for x in j], njnt, 3),
            jnt_pos=arr([x["pos"] for x in j], njnt, 3),
            jnt_range=arr([x["range"] for x in j], njnt, 2),
            jnt_limited=arr([x["limited"] for x in j], njnt),
            jnt_stiffness=arr([x["stiffness"] for x in j], njnt),
            jnt_ref=arr([x["ref"] for x in j], njnt),
            qpos0=arr(qpos0),
            dof_damping=arr(dof_damping),
            dof_armature=arr(dof_armature),
            dof_limited=arr(dof_limited),
            dof_range=arr(dof_range),
            dof_margin=arr(dof_margin),
            dof_frictionloss=arr(dof_frictionloss),
            dof_solref=arr(dof_solref),
            dof_solimp=arr(dof_solimp),
            dof_stiffness=arr(dof_stiffness),
            dof_ref=arr(dof_ref),
            limit_solref=arr([x["solref"] for x in j], njnt, 2),
            limit_solimp=arr([x["solimp"] for x in j], njnt, 5),
            gear=arr([a["gear"] for a in self.actuators], nu),
            ctrlrange=arr([a["ctrlrange"] for a in self.actuators], nu, 2),
            ctrllimited=arr([a["ctrllimited"] for a in self.actuators], nu),
            actuator_gain=arr([a["gain"] for a in self.actuators], nu),
            actuator_bias=arr([a["bias"] for a in self.actuators], nu, 3),
            actuator_gearv=arr([a["gearv"] for a in self.actuators], nu, 6),
            actuator_tendon=tuple(a["tendon"] for a in self.actuators),
            neq=neq,
            eq_kind=tuple(e["kind"] for e in eqs),
            eq_obj1=tuple(e["obj1"] for e in eqs),
            eq_obj2=tuple(e["obj2"] for e in eqs),
            eq_data=arr([e["data"] for e in eqs], neq, 11),
            eq_solref=arr([e["solref"] for e in eqs], neq, 2),
            eq_solimp=arr([e["solimp"] for e in eqs], neq, 5),
            eq_active=arr([e["active"] for e in eqs], neq),
            geom_pos=arr([g["pos"] for g in self.geoms], ngeom, 3),
            geom_quat=arr([g["quat"] for g in self.geoms], ngeom, 4),
            geom_size=arr([g["size"] for g in self.geoms], ngeom, 3),
            geom_friction=arr([g["friction"] for g in self.geoms], ngeom, 3),
            geom_margin=arr([g["margin"] for g in self.geoms], ngeom),
            geom_solref=arr([g["solref"] for g in self.geoms], ngeom, 2),
            geom_solimp=arr([g["solimp"] for g in self.geoms], ngeom, 5),
            site_pos=arr([s["pos"] for s in self.sites], nsite, 3),
            site_quat=arr([s["quat"] for s in self.sites], nsite, 4),
            ntendon=ntendon,
            ten_J=arr(ten_J, ntendon, nv),
            ten_range=arr([x["range"] for x in tn], ntendon, 2),
            ten_limited=arr([x["limited"] for x in tn], ntendon),
            ten_solref=arr([x["solref"] for x in tn], ntendon, 2),
            ten_solimp=arr([x["solimp"] for x in tn], ntendon, 5),
            ten_stiffness=arr([x["stiffness"] for x in tn], ntendon),
            ten_damping=arr([x["damping"] for x in tn], ntendon),
            ten_springlength=arr(ten_spring, ntendon, 2),
            timestep=arr(self.opt["timestep"]),
            gravity=arr(self.opt["gravity"]),
            viscosity=arr(self.opt["viscosity"]),
            density=arr(self.opt["density"]),
        )
        dof_iw, body_iw, ten_iw = _invweights(model)
        if contact_topk is None:
            from mjrl_tpu_torch.physics.collision import contact_geom_ids
            contact_topk = 64 if len(contact_geom_ids(model)[0]) > 64 else 0
        return replace(model, dof_invweight0=arr(dof_iw),
                       body_invweight0=arr(body_iw),
                       ten_invweight0=arr(ten_iw, ntendon),
                       eq_data=arr(_resolve_eq_data(model), neq, 11),
                       contact_topk=int(contact_topk),
                       row_freeze_step=bool(row_freeze_step),
                       newton_iters=int(newton_iters))


def _resolve_eq_data(model):
    """eq_data with the compiler's qpos0 rules applied where ``finalize``
    left NaN: a connect's body2-local anchor is the point coincident with
    body1's anchor; a weld's body1-local anchor is body2's anchor, and its
    relative quaternion makes vec(q2^-1 q1 relq) vanish."""
    eq_data = np.array(model.eq_data, np.float64)
    if not np.isnan(eq_data).any():
        return eq_data
    xpos, xmat = _frames0(model)
    for i, kind in enumerate(model.eq_kind):
        b1, b2 = model.eq_obj1[i], model.eq_obj2[i]
        if kind == EQ_CONNECT:
            p1 = xpos[b1] + xmat[b1] @ eq_data[i, :3]
            eq_data[i, 3:6] = xmat[b2].T @ (p1 - xpos[b2])
        elif kind == EQ_WELD:
            if np.isnan(eq_data[i, 3:6]).any():
                p2 = xpos[b2] + xmat[b2] @ eq_data[i, :3]
                eq_data[i, 3:6] = xmat[b1].T @ (p2 - xpos[b1])
            if np.isnan(eq_data[i, 6:10]).any():
                q1 = _np_mat_to_quat(xmat[b1])
                q2 = _np_mat_to_quat(xmat[b2])
                relq = _np_quat_mul(q1 * np.array([1, -1, -1, -1]), q2)
                eq_data[i, 6:10] = relq / np.linalg.norm(relq)
    return eq_data


@dataclass
class State:
    """Dynamic physics state of a batch of environments: ``qpos`` and
    ``qvel`` are ``(B, nq)`` / ``(B, nv)`` tensors."""
    qpos: Any
    qvel: Any
