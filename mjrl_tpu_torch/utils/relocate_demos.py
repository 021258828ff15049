"""Relocate demonstrations on the PyTorch port (counterpart of
``tools/make_relocate_demos.py`` and ``tools/relocate_expert.py``, which
the port copies rather than imports).

The demo source of the DAPG relocate pipeline: a scripted IK-waypoint claw
expert (``RelocateExpert``, numpy) drives lockstep batched episodes of the
port's ``AdroitRelocateEnv``.  The env steps run batched on the env's
device; the expert's oracles (palm pose and Jacobian, gravity load) are
numpy chain kinematics over the model tables (``NumpyAdroitBackend``), so
the per-step host control loop stays off the device.

    python -m mjrl_tpu_torch.utils.relocate_demos --episodes 32 \
        --out relocate_demos.pkl                   # on the GPU
    python -m mjrl_tpu_torch.utils.relocate_demos --device cpu \
        --episodes 2 --horizon 5                   # a small CPU run

The expert (measured geometry of the relocate model):

- The palm site rests at z = 0.15 and the vertical slide ARTy only goes
  up: lowering the hand onto the ball needs the forearm pitch (ARRx, +-0.75
  rad about the mount at (0, -0.7, 0.2)) plus wrist flexion (WRJ1).
- Palm-frame axes: local +x = finger direction, local z spans the finger
  spread (thumb at z ~ +0.076), local -y = the palm normal.  At mid-closure
  (flex 0.8) the fingertip centroid, the grasp cage, sits at local (0.045,
  0.0, 0.015); the cage mouth between extended fingertips and thumb is ~9
  cm, enough for the 7 cm ball.
- Strategy: keep the hand in a claw pose (fingers pitched down at the
  table), servo the cage over the ball with damped-least-squares IK on the
  8 pose dofs (6 arm + 2 wrist), descend so the ball enters the cage,
  close, and carry the cage to the target.
- The backend supplies ``pose_and_jac(qpos) -> (palm_pos, palm_R, Jp (3,
  8), Jr (3, 8))`` for the palm site over the first 8 dofs; the expert
  returns absolute ctrl targets (30,).
- Actuators: the arm's are affine servos, force = 500 ctrl - 200 q, so the
  equilibrium is q = 2.5 ctrl and ctrl = 0.4 q_target; the wrist and finger
  actuators are unit position servos.
"""

import argparse
import json
import pickle

import numpy as np
import torch

from mjrl_tpu_torch.physics.kinematics import ancestor_mask
from mjrl_tpu_torch.physics.model import HINGE, SLIDE


ARM = slice(0, 6)
WRIST = [6, 7]
FINGER_FLEX = [9, 10, 11, 13, 14, 15, 17, 18, 19, 22, 23, 24]
FINGER_SPREAD = [8, 12, 16, 21]
LFJ4 = 20
THUMB = [25, 26, 27, 28, 29]

PRE_FLEX = 0.45                       # claw pre-curl during approach
PRE_THUMB = [0.35, 0.3, 0.0, 0.0, -0.2]
GRIP_FLEX = 1.4                       # closed grip
CARRY_FLEX = 1.45                     # wrap (teleport hold-test tuned)
CARRY_THUMB = [0.8, 1.3, 0.25, 0.5, -0.8]
GRIP_THUMB = [0.55, 1.25, 0.25, 0.4, -0.9]

# grasp cage center in the PALM SITE frame (fingertip centroid at
# mid-closure, measured)
CAGE_LOCAL = np.array([0.035, -0.018, 0.015])

# joint limits of the 8 pose dofs (arm + wrist)
Q_LO = np.array([-0.25, 0.0, -0.3, -0.75, -0.75, -0.75, -0.524, -0.785])
Q_HI = np.array([0.25, 0.2, 0.5, 0.75, 0.75, 0.75, 0.175, 0.611])

PITCH = 1.0                           # claw pitch (rad, fingers down)


# palm-site rotation at qpos0 (measured in real MuJoCo): the hand rests
# with a ~17 deg yaw from the forearm mount.  Goal orientations compose
# a pure pitch with THIS frame — demanding zero yaw makes the IK fight
# the mount geometry and collapse the workspace (observed: the hand
# dragged at z~0.03 with the wrist pinned at its extension limit).
R_REST = np.array([[0.291, -0.016, -0.956],
                   [0.957, -0.004, 0.291],
                   [-0.009, -1.000, 0.014]])


def _axis_angle(a, t):
    a = np.asarray(a, float) / np.linalg.norm(a)
    K = _skew(a)
    return np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * (K @ K)


def desired_rotation(pitch=PITCH):
    """Claw-pose palm rotation: the REST orientation pitched ``pitch``
    rad downward about the horizontal axis perpendicular to the resting
    finger direction."""
    x_rest = R_REST[:, 0]
    axis = np.cross([0.0, 0.0, 1.0], x_rest)   # pitch-down axis
    return _axis_angle(axis, pitch) @ R_REST


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0.0]])


def ik_step(q8, pos, R, jp, jr, goal_pos, goal_R, cage_local=CAGE_LOCAL,
            w_rot=0.12, null_bias=False):  # noqa: D401
    """One damped-least-squares IK update of the 8 pose dofs driving the
    CAGE point toward goal_pos and the palm rotation toward goal_R."""
    r = R @ cage_local
    cage = pos + r
    jp_cage = jp - _skew(r) @ jr
    e_pos = goal_pos - cage
    # orientation error as a rotation vector (sum-of-cross-products)
    e_rot = 0.5 * (np.cross(R[:, 0], goal_R[:, 0])
                   + np.cross(R[:, 1], goal_R[:, 1])
                   + np.cross(R[:, 2], goal_R[:, 2]))
    J = np.concatenate([jp_cage, w_rot * jr], axis=0)       # (6, 8)
    e = np.concatenate([e_pos, w_rot * e_rot])
    # weighted DLS: make the forearm rotations expensive and the wrist
    # cheap, so pitch routes through WRJ1 (zero height loss) instead of
    # ARRx (which swings the palm down 0.55 m/rad about the mount)
    W = np.array([1.0, 1.2, 1.0, 0.25, 0.25, 0.25, 2.5, 2.5])
    Jw = J * W[None, :]
    JJT = Jw @ Jw.T + 2e-4 * np.eye(6)
    dq = W * (Jw.T @ np.linalg.solve(JJT, e))
    # null-space bias: pull the forearm rotations toward zero without
    # disturbing the task — a greedy DLS parks ARRx at 0.2+ after the
    # grasp maneuvers, wasting ~0.1 m of the vertical workspace the
    # high carry targets need (observed)
    if null_bias:
        dq0 = np.zeros(8)
        dq0[3:6] = -0.08 * q8[3:6]
        dq = dq + dq0 - W * (Jw.T @ np.linalg.solve(JJT, J @ dq0))
    dq = np.clip(dq, -0.3, 0.3)
    return np.clip(q8 + dq, Q_LO, Q_HI), e_pos


def ik_solve(fk_shadow, q8, goal_pos, goal_R, cage_local=CAGE_LOCAL,
             iters=15, null_bias=False, w_rot=0.12):
    """Full IK on a SHADOW model: iterate DLS steps with fresh FK at
    each candidate (no sim stepping) -> joint-space waypoint.  The
    executed motion is then a simple rate-limited joint interpolation,
    immune to the plant-lag feedback instability a per-step Cartesian
    servo exhibits (observed: meter-scale orbit loops)."""
    q = np.asarray(q8, float).copy()
    for _ in range(iters):
        pos, R, jp, jr = fk_shadow(q)
        q, e = ik_step(q, pos, R, jp, jr, goal_pos, goal_R, cage_local,
                       w_rot=w_rot, null_bias=null_bias)
        if np.linalg.norm(e) < 1e-3:
            break
    return q


class RelocateExpert:
    """Phase machine: standoff near the ball -> insert (cage onto the
    ball) -> close -> lift to target.  Per-episode state is keyed by
    batch index ``b`` so lockstep batched rollouts work.

    ``standoff``: 'axis' approaches along the claw's finger axis,
    'above' descends vertically.  ``pitch``/``cage_local`` override the
    measured defaults (exposed for the grasp parameter search)."""

    CLOSE_T = 14

    def __init__(self, noise=0.0, seed=0, pitch=PITCH,
                 cage_local=None, standoff="above", standoff_dist=0.12,
                 pre_flex=PRE_FLEX, grip_flex=GRIP_FLEX,
                 travel_pitch=0.45, pounce_rate=0.045):
        self.noise = noise
        self.rng = np.random.default_rng(seed)
        self.pitch = pitch
        self.cage_local = (np.asarray(cage_local, float)
                           if cage_local is not None else CAGE_LOCAL)
        self.standoff = standoff
        self.standoff_dist = standoff_dist
        self.pre_flex = pre_flex
        self.grip_flex = grip_flex
        self.travel_pitch = travel_pitch
        self.pounce_rate = pounce_rate
        self.pounce_steps = 40
        self.carry_pitch = 0.68
        # scripted path speeds (m per control step) — grasp-search tuned
        self.travel_rise = 0.011
        self.travel_slide = 0.0085
        self.pounce_v = 0.0045
        self.carry_v = 0.0095
        self.reset()

    def reset(self):
        self._phase = {}     # batch index -> phase name
        self._count = {}     # steps in current phase
        self._anchor = {}    # phase-entry anchor point (ball, etc.)
        self._q_cmd = {}     # internal feedforward joint target (8,)
        self._integ = {}     # anti-gravity integrator (8,)
        self._grasp_pt = {}  # ball position at grasp time
        self._tgt = {}       # current Cartesian target (smoothed)
        self._pitch_cmd = {}  # current commanded pitch
        self._last_ball = {}  # ball position last step (stillness check)
        self._droop = {}     # EMA of measured-vs-shadow cage offset
        self._tstage = {}    # travel substage
        self._ierr = {}      # carry-phase ball-error integral

    def _enter(self, b, phase, anchor=None):
        self._phase[b] = phase
        self._anchor[b] = anchor
        self._count[b] = 0
        self._tstage[b] = 0

    def action(self, qpos, pose_and_jac, ball, target, b=0,
               fk_shadow=None, qfrc_bias=None):
        """-> absolute ctrl targets (30,).  ``fk_shadow(q8)`` evaluates
        the palm pose/Jacobian at an arbitrary candidate q8 without
        stepping the sim (IK oracle).

        Control architecture: OPEN-LOOP CARTESIAN PATH SCRIPTING.  Each
        phase scripts a straight cage path (a target point + pitch per
        step, consecutive targets millimetres apart) and warm-started
        IK turns each target into the joint command.  No measured-state
        feedback in the loop (every feedback variant limit-cycled
        against the 0.1 s servo lag and batted the ball around), and no
        joint-space waypoint interpolation (the straight JOINT path
        between the hover and grasp configurations bows the cage ~10 cm
        sideways through the ball — observed).  The anti-gravity
        integrator on the tracking error is the one feedback term."""
        q8 = np.asarray(qpos[:8], float)
        ball = np.asarray(ball, float)
        target = np.asarray(target, float)
        pos, R, jp, jr = pose_and_jac(qpos)
        cage = pos + R @ self.cage_local
        if b not in self._q_cmd:
            self._q_cmd[b] = q8.copy()
            self._integ[b] = np.zeros(8)
            pos_s, R_s, _, _ = fk_shadow(q8)
            self._tgt[b] = pos_s + R_s @ self.cage_local
            self._pitch_cmd[b] = float(np.arcsin(np.clip(
                -R_s[2, 0], -1.0, 1.0)))
            self._enter(b, "travel")

        phase = self._phase[b]
        self._count[b] += 1
        n = self._count[b]
        flex, thumb = self.pre_flex, PRE_THUMB
        tgt = self._tgt[b]
        pitch_cmd = self._pitch_cmd[b]

        def move_toward(point, pitch_goal, rate, pitch_rate=0.02):
            """Advance the scripted target/pitch by one bounded step."""
            d = point - tgt
            nn = np.linalg.norm(d)
            step = d if nn <= rate else d * (rate / nn)
            return tgt + step, pitch_cmd + np.clip(
                pitch_goal - pitch_cmd, -pitch_rate, pitch_rate)

        ball_prev = self._last_ball.get(b, ball)
        self._last_ball[b] = ball.copy()
        ball_still = np.linalg.norm(ball - ball_prev) < 0.0012

        if phase == "travel":
            # staged path: rise STRAIGHT UP (pitching or sliding at low
            # altitude sweeps the fingers through near-start balls —
            # observed), then pitch at height, then slide high, then
            # descend to the hover point.  Monotonic substages — two
            # move_toward calls sharing a step alternated and dithered
            # the target at ~1 Hz, resonating the arm (observed).
            hover = ball + np.array([0.0, -0.01, self.standoff_dist])
            rise_z = max(hover[2], 0.175)
            st = self._tstage.get(b, 0)
            if st == 0:       # rise in place while pitching to claw
                over = np.array([tgt[0], tgt[1], rise_z])
                tgt, pitch_cmd = move_toward(over, self.travel_pitch,
                                             self.travel_rise,
                                             pitch_rate=0.02)
                if abs(tgt[2] - rise_z) < 0.003 and \
                        abs(pitch_cmd - self.travel_pitch) < 0.02:
                    st = 2
            elif st == 2:     # slide high over the ball
                high = np.array([hover[0], hover[1], rise_z])
                tgt, pitch_cmd = move_toward(high, self.travel_pitch,
                                             self.travel_slide)
                if np.linalg.norm(tgt - high) < 0.004:
                    st = 3
            else:             # descend to the hover point
                tgt, pitch_cmd = move_toward(hover, self.travel_pitch,
                                             self.travel_slide)
                if np.linalg.norm(tgt - hover) < 0.003 and \
                        np.hypot(cage[0] - hover[0],
                                 cage[1] - hover[1]) < 0.03 and \
                        ball_still:
                    self._enter(b, "pounce", ball.copy())
            self._tstage[b] = st
        elif phase == "pounce":
            # straight descent onto the (entry-frozen) ball while the
            # claw pitches travel_pitch -> pitch
            ball_e = self._anchor[b]
            drift = np.hypot(ball[0] - ball_e[0], ball[1] - ball_e[1])
            if drift > 0.03 and tgt[2] - ball[2] > 0.035:
                self._enter(b, "travel")       # anchor stale — re-aim
            grasp = ball_e + np.array([0.0, getattr(self, '_grasp_yoff', 0.002), 0.004])
            # two-speed: drop fast while the claw is still clear above
            # the ball, creep the final 5 cm
            high_clear = (tgt[2] - ball_e[2]) > 0.075
            pv = 0.0085 if high_clear else self.pounce_v
            pr = 0.03 if high_clear else 0.012
            tgt, pitch_cmd = move_toward(grasp, self.pitch, pv,
                                         pitch_rate=pr)
            if np.linalg.norm(tgt - grasp) < 0.003 and \
                    abs(pitch_cmd - self.pitch) < 0.03:
                d_ball = np.linalg.norm(ball - cage)
                if d_ball < 0.032:
                    self._grasp_pt[b] = ball.copy()
                    self._enter(b, "close")
                elif n > 110:
                    self._enter(b, "travel")   # ball escaped — retry
        elif phase == "close":
            flex, thumb = self.grip_flex, GRIP_THUMB
            # rise gently WHILE closing: with the ball pressed against
            # the table, the squeeze has nowhere to push it but
            # sideways — it squirts out backward at ~1 m/s (observed).
            # Removing the table support mid-close lets the fingers
            # wrap it in the air instead.
            if n > 4:
                tgt, pitch_cmd = move_toward(
                    tgt + np.array([0.0, 0.0, 0.01]), self.pitch,
                    0.0035, pitch_rate=0.004)
            if n > self.CLOSE_T:
                self._enter(b, "lift")
        elif phase == "lift":
            flex, thumb = (CARRY_FLEX if n > 12 else self.grip_flex), \
                (CARRY_THUMB if n > 12 else GRIP_THUMB)
            if np.linalg.norm(ball - cage) > 0.12:
                self._enter(b, "travel")       # ball lost — re-grasp
            up = self._grasp_pt[b] + np.array([0.0, 0.0, 0.13])
            tgt, pitch_cmd = move_toward(up, self.pitch - 0.3, 0.0055,
                                         pitch_rate=0.01)
            if np.linalg.norm(tgt - up) < 0.003 or n > 32:
                self._enter(b, "carry")
        elif phase == "hold":
            # latched target + ACTIVE pitch drift: a frozen grip leaks —
            # the smooth ball rolls out along the palm normal at
            # ~7 mm/step (rolling friction 1e-4; static retention tops
            # out at ~0.4 s in teleport hold tests).  Slowly pitching
            # the claw down rolls the ball back toward the palm pocket
            # and stretches retention past the 25-step success bar
            # (measured: drift 0.008 -> 28 goal steps vs 22 frozen)
            flex, thumb = CARRY_FLEX, CARRY_THUMB
            pitch_cmd = min(1.2, pitch_cmd + 0.008)
        else:                              # carry
            flex, thumb = CARRY_FLEX, CARRY_THUMB
            if np.linalg.norm(ball - target) < 0.095:
                self._enter(b, "hold")
            if np.linalg.norm(ball - cage) > 0.14 and ball[2] < 0.06:
                self._enter(b, "travel")       # ball dropped — re-grasp
            # steer by the measured BALL: the ball rides offset from the
            # cage, so aim the cage at target + (cage - ball), plus a
            # SLOW integral of the true ball error — the quasi-static
            # droop at stretched poses leaves a ~0.09 m constant offset
            # the proportional aim cannot remove (observed)
            corr = np.clip(cage - ball, -0.13, 0.13)
            tgt, pitch_cmd = move_toward(target + corr,
                                         self.carry_pitch,
                                         self.carry_v,
                                         pitch_rate=0.005)

        self._tgt[b] = tgt
        self._pitch_cmd[b] = pitch_cmd
        # (gravity droop is handled by the joint-space integrator below:
        # a Cartesian measured-vs-shadow correction, even heavily
        # low-passed, oscillated — the measurement mixes transient
        # tracking lag with true droop)
        q_cmd = ik_solve(fk_shadow, self._q_cmd[b], tgt,
                         desired_rotation(pitch_cmd), self.cage_local,
                         iters=5,
                         null_bias=phase in ("lift", "carry"),
                         # carry: soften the orientation constraint so
                         # yaw/roll serve POSITION — corner targets sit
                         # at the fixed-yaw reach boundary (observed:
                         # WRJ0+ARTy pinned at limits, ball stalled at
                         # the 0.1 ring)
                         w_rot=0.04 if phase == "carry" else 0.12)
        q_cmd = np.clip(q_cmd, Q_LO, Q_HI)
        self._q_cmd[b] = q_cmd
        integ = np.clip(self._integ[b] + 0.04 * np.clip(q_cmd - q8,
                                                        -0.1, 0.1),
                        -0.35, 0.35)
        self._integ[b] = integ

        ctrl = np.zeros(30)
        # gravity feedforward: actuator force = 500c - 200q (arm) /
        # 10c - 10q (wrist); holding q_cmd against the gravity load G
        # needs c = 0.4 q + G/500 (resp. q + G/10).  Without it the arm
        # droops ~4 cm — enough to drag the fingertips at ball height
        # and bulldoze every approach (observed; the error integrator
        # alone converges far too slowly).
        gff = np.zeros(8) if qfrc_bias is None else np.asarray(
            qfrc_bias[:8], float)
        ctrl[ARM] = 0.4 * (q_cmd[:6] + integ[:6]) + gff[:6] / 500.0
        ctrl[WRIST] = q_cmd[6:8] + integ[6:8] + gff[6:8] / 10.0
        ctrl[FINGER_FLEX] = flex
        ctrl[FINGER_SPREAD] = 0.0
        ctrl[LFJ4] = 0.0
        ctrl[THUMB] = thumb
        if self.noise > 0:
            ctrl = ctrl + self.noise * self.rng.standard_normal(30)
        return ctrl


# ---------------------------------------------------------------------------
# numpy oracles of the expert and the batched demo runner
# ---------------------------------------------------------------------------

def _quat_mat(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _axis_mat(a, t):
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0.0]])
    return np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * (K @ K)


class NumpyAdroitBackend:
    """The expert's oracles (palm pose with its analytic Jacobians, the
    gravity load) as numpy chain kinematics over the model tables.  Adroit
    has slide and hinge joints only, so the revolute/prismatic Jacobian
    columns are exact."""

    def __init__(self, env):
        m = env.model
        self.m = m
        self.sid = env._palm_sid
        self.sb = m.site_body[self.sid]
        self.body_pos = np.asarray(m.body_pos, float)
        self.body_quat_mat = [_quat_mat(np.asarray(m.body_quat[b], float))
                              for b in range(m.nbody)]
        self.site_pos = np.asarray(m.site_pos[self.sid], float)
        self.site_mat = _quat_mat(np.asarray(m.site_quat[self.sid], float))
        self.jnt_pos = np.asarray(m.jnt_pos, float)
        self.jnt_axis = np.asarray(m.jnt_axis, float)
        self.jnt_ref = np.asarray(m.jnt_ref, float)
        self.masses = np.asarray(m.body_mass, float)
        self.ipos = np.asarray(m.body_ipos, float)
        self.amask = ancestor_mask(m)          # (nbody, nv)
        self._qrest = None

    def _fk(self, qpos):
        """Full-body FK -> (xpos, xmat, joint anchors and axes, world)."""
        m = self.m
        xpos, xmat = [np.zeros(3)], [np.eye(3)]
        anchor, axis_w = [None] * m.njnt, [None] * m.njnt
        for b in range(1, m.nbody):
            p = m.body_parent[b]
            mat = xmat[p] @ self.body_quat_mat[b]
            pos = xpos[p] + xmat[p] @ self.body_pos[b]
            for j in m.body_jnts[b]:
                anc = pos + mat @ self.jnt_pos[j]
                ax = mat @ self.jnt_axis[j]
                anchor[j], axis_w[j] = anc, ax
                q = qpos[m.jnt_qposadr[j]] - self.jnt_ref[j]
                if m.jnt_type[j] == SLIDE:
                    pos = pos + ax * q
                else:                          # HINGE
                    mat = _axis_mat(ax, q) @ mat
                    pos = anc - mat @ self.jnt_pos[j]
            xpos.append(pos)
            xmat.append(mat)
        return xpos, xmat, anchor, axis_w

    def set_state(self, qpos):
        self._qrest = np.asarray(qpos, float)[8:]

    def _oracle(self, q8):
        qpos = np.concatenate([np.asarray(q8, float), self._qrest])
        xpos, xmat, anchor, axis_w = self._fk(qpos)
        p = xpos[self.sb] + xmat[self.sb] @ self.site_pos
        R = xmat[self.sb] @ self.site_mat
        jp, jr = np.zeros((3, 8)), np.zeros((3, 8))
        m = self.m
        for j in range(m.njnt):
            d = m.jnt_dofadr[j]
            if d >= 8:
                break
            if not self.amask[self.sb, d]:
                continue
            if m.jnt_type[j] == SLIDE:
                jp[:, d] = axis_w[j]
            else:
                jp[:, d] = np.cross(axis_w[j], p - anchor[j])
                jr[:, d] = axis_w[j]
        return p, R, jp, jr, xpos, xmat, anchor, axis_w

    def pose_and_jac(self, qpos):
        self.set_state(qpos)
        p, R, jp, jr, *_ = self._oracle(np.asarray(qpos, float)[:8])
        return p, R, jp, jr

    def fk_shadow(self, q8):
        p, R, jp, jr, *_ = self._oracle(q8)
        return p, R, jp, jr

    def qfrc_bias(self, qpos):
        """Gravity's generalized force on the 8 pose dofs: G_d = sum_i m_i
        (-g) . dcom_i/dq_d (the droop load the servo feedforward cancels;
        Coriolis terms are negligible here)."""
        q = np.asarray(qpos, float)
        self.set_state(q)
        _, _, _, _, xpos, xmat, anchor, axis_w = self._oracle(q[:8])
        m = self.m
        coms = np.stack([xpos[b] + xmat[b] @ self.ipos[b]
                         for b in range(m.nbody)])
        g = np.array([0.0, 0.0, -9.81])
        out = np.zeros(8)
        for j in range(m.njnt):
            d = m.jnt_dofadr[j]
            if d >= 8:
                break
            ax, anc = axis_w[j], anchor[j]
            tot = np.zeros(3)
            for b in range(1, m.nbody):
                if not self.amask[b, d] or self.masses[b] == 0:
                    continue
                dcom = ax if m.jnt_type[j] == SLIDE \
                    else np.cross(ax, coms[b] - anc)
                tot += self.masses[b] * dcom
            out[d] = -np.dot(tot, g)
        return out


def run_batch(env, num_episodes, horizon=200, noise=0.0, seed=0,
              generator=None):
    """Lockstep batched expert episodes: one env step of all
    ``num_episodes`` per control step, the expert per episode on the host
    -> a list of path dicts (observations, actions in [-1, 1], rewards,
    env_infos {goal_achieved}, init_state, terminated)."""
    B = num_episodes
    state = env.reset(B, generator)
    expert = RelocateExpert(noise=noise, seed=seed)
    backend = NumpyAdroitBackend(env)
    cr = np.asarray(env.model.ctrlrange)
    mid = 0.5 * (cr[:, 0] + cr[:, 1])
    half = 0.5 * (cr[:, 1] - cr[:, 0])
    es0 = {k: v.cpu().numpy() for k, v in env.get_env_state(state).items()}
    obs_l, act_l, rew_l, goal_l = [], [], [], []
    for _ in range(horizon):
        obs = state.obs.cpu().numpy().astype(np.float64)
        qpos = state.physics.qpos.cpu().numpy().astype(np.float64)
        acts = np.zeros((B, env.action_dim))
        for b in range(B):
            backend.set_state(qpos[b])
            palm, _, _, _ = backend.pose_and_jac(qpos[b])
            # obs = [qpos[:30], palm - obj, palm - target, obj - target]
            ball = palm - obs[b, 30:33]
            target = palm - obs[b, 33:36]
            ctrl = expert.action(qpos[b], backend.pose_and_jac, ball,
                                 target, b=b, fk_shadow=backend.fk_shadow,
                                 qfrc_bias=backend.qfrc_bias(qpos[b]))
            acts[b] = np.clip((ctrl - mid) / np.maximum(half, 1e-8), -1, 1)
        obs_l.append(obs)
        act_l.append(acts)
        state = env.step(state, torch.tensor(acts, dtype=env.dtype,
                                             device=env.device))
        rew_l.append(state.reward.cpu().numpy())
        goal_l.append(state.info["goal_achieved"].cpu().numpy())
    obs_a, act_a = np.stack(obs_l, 1), np.stack(act_l, 1)
    rew_a, goal_a = np.stack(rew_l, 1), np.stack(goal_l, 1)
    return [dict(observations=obs_a[b], actions=act_a[b], rewards=rew_a[b],
                 env_infos={"goal_achieved": goal_a[b]},
                 init_state={k: v[b] for k, v in es0.items()},
                 terminated=False)
            for b in range(B)]


def make_demos(env, episodes, horizon=200, batch=16, noise=0.0, seed=0,
               successful_only=True, generator=None, log=None):
    """``episodes`` expert episodes in batches of ``batch`` -> (demos,
    successes): the successful paths (the goal held on more than 25 steps),
    or every path with ``successful_only=False`` (a horizon too short to
    succeed)."""
    if generator is None:
        generator = torch.Generator(device=env.device).manual_seed(seed)
    demos, succ, done = [], 0, 0
    while done < episodes:
        n = min(batch, episodes - done)
        for path in run_batch(env, n, horizon, noise, seed, generator):
            goal_steps = int(np.sum(path["env_infos"]["goal_achieved"]))
            ok = goal_steps > 25
            succ += ok
            if log is not None:
                log({"ep": done, "return": float(path["rewards"].sum()),
                     "goal_steps": goal_steps, "success": bool(ok)})
            if ok or not successful_only:
                demos.append(path)
            done += 1
    return demos, succ


def main(argv=None):
    ap = argparse.ArgumentParser(description="relocate expert demos")
    ap.add_argument("--episodes", type=int, default=32)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--horizon", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda / cpu (default: cuda; without a GPU pass cpu)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from mjrl_tpu_torch.envs.adroit import AdroitRelocateEnv
    env = AdroitRelocateEnv(device=args.device)
    log = lambda rec: print(json.dumps(rec), flush=True)
    demos, succ = make_demos(env, args.episodes, args.horizon, args.batch,
                             args.noise, args.seed, log=log)
    log({"episodes": args.episodes, "successes": succ,
         "rate": 100.0 * succ / max(args.episodes, 1)})
    if args.out and demos:
        with open(args.out, "wb") as f:
            pickle.dump(demos, f)
        log({"saved": args.out, "demos": len(demos)})


if __name__ == "__main__":
    main()
