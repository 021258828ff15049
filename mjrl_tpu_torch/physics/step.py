"""Forward dynamics and integrators of the general engine (counterpart of
``mjrl_tpu/physics/step.py``), batch-first.

``step_n(model, state, ctrl, n)`` advances a batch of states by ``n``
physics timesteps at constant ctrl (mujoco_env's do_simulation).

Integrators (matching MuJoCo):
- Euler: semi-implicit with implicit joint damping, the velocity update
  solving (M + h diag(damping)) qacc = qfrc_total;
- RK4: classic 4-stage Runge-Kutta on (qpos, qvel), its stage sums in the
  JAX package's left-associated order and (h/6) * sum.

Joint limits, tendon limits, equalities and contacts go through the
penalty path (the reference accelerations ``dynamics.limit_qacc`` /
``tendon_limit_qacc`` / ``equality_qacc``, the forces
``collision.contact_qfrc``) or, with ``solver="pgs"``, through the implicit
solver (``physics/solver.py``): the dual cold at the first substep of a
control step (``SWEEPS``) and warm-started at the others and at RK4 stages
2-4 (``SWEEPS_WARM``), or the primal Newton solver where the model sets
``newton_iters`` (its warm format threads through unchanged).  RK4 rebuilds the constraint rows at every stage,
as MuJoCo does, unless the model sets ``row_freeze_step``: then the rows
of the first stage of the first substep hold for the whole control step
and only their J v is recomputed.

Every operation here is an eager PyTorch operation: no kernel of the
port's ``csrc/`` is launched on this path.
"""

import torch

from mjrl_tpu_torch.ops.linalg import spd_solve
from mjrl_tpu_torch.physics import dynamics as dyn
from mjrl_tpu_torch.physics import math as pm
from mjrl_tpu_torch.physics.collision import contact_qfrc
from mjrl_tpu_torch.physics.kinematics import body_frames, model_tables
from mjrl_tpu_torch.physics.model import (BALL, FREE, PGS, RK4, HINGE,
                                          SLIDE, Model, State)
from mjrl_tpu_torch.physics.solver import (SWEEPS, SWEEPS_WARM,
                                           constrained_qacc)


def _quat_step(quat, w, h):
    wnorm = torch.sqrt(torch.sum(w * w, dim=-1) + 1e-18)
    axis = w / wnorm.unsqueeze(-1)
    dq = pm.axis_angle_quat(axis, wnorm * h)
    new = pm.quat_mul(quat, dq)
    return new / torch.sqrt(torch.sum(new * new, dim=-1, keepdim=True)
                            + 1e-18)


def integrate_pos(model: Model, qpos, qvel, h):
    """qpos' = qpos advanced by qvel for time h, per joint type: slide and
    hinge linearly; ball and free quaternions right-multiplied by
    exp(h w_local / 2) and renormalized (MuJoCo mju_integratePos), the
    free position by the world-frame linear velocity."""
    if all(x in (HINGE, SLIDE) for x in model.jnt_type):
        return qpos + h * qvel
    segments = []
    for j in range(model.njnt):
        qa, da = model.jnt_qposadr[j], model.jnt_dofadr[j]
        if model.jnt_type[j] == BALL:
            segments.append(_quat_step(qpos[:, qa:qa + 4],
                                       qvel[:, da:da + 3], h))
        elif model.jnt_type[j] == FREE:
            segments.append(qpos[:, qa:qa + 3] + h * qvel[:, da:da + 3])
            segments.append(_quat_step(qpos[:, qa + 3:qa + 7],
                                       qvel[:, da + 3:da + 6], h))
        else:
            segments.append(qpos[:, qa:qa + 1] + h * qvel[:, da:da + 1])
    return torch.cat(segments, dim=-1) if segments else qpos


def _forces_and_mass(model: Model, state: State, ctrl, body_pos=None):
    """Everything qacc needs -> (M, qfrc_total, bias, qacc_ref, ctx):
    qacc_ref the penalty limits' reference acceleration (None under the
    implicit solver), ctx (data, cdof) for the implicit solver's rows.
    ``body_pos`` (B, nbody, 3): per-row body offsets (moved scenery)."""
    data = body_frames(model, state.qpos, body_pos)
    cdof = dyn.compute_cdof(model, data)
    cvel, cdofdot = dyn.compute_velocities(model, data, cdof, state.qvel)
    m, bias = dyn.mass_and_bias(model, data, cdof, cvel, cdofdot,
                                state.qvel)
    qfrc = dyn.actuator_force(model, ctrl, state.qpos, state.qvel)
    # the model's all-zero coefficient sets add exact zeros: left out
    if model.jnt_spring_quat or (model.dof_stiffness != 0).any():
        qfrc = qfrc + dyn.spring_force(model, state.qpos)
    if (model.dof_damping != 0).any():
        qfrc = qfrc + dyn.damping_force(model, state.qvel)
    if (model.ten_stiffness != 0).any() or (model.ten_damping != 0).any():
        qfrc = qfrc + dyn.tendon_passive_force(model, state.qpos,
                                               state.qvel)
    if dyn.has_fluid(model):
        qfrc = qfrc + dyn.project_body_forces(
            model, cdof, dyn.fluid_force(model, data, cvel))
    if model.solver == PGS:
        return m, qfrc, bias, None, (data, cdof)
    if model.contact_pairs:
        qfrc = qfrc + contact_qfrc(model, data, cdof, cvel, state.qvel,
                                   torch.diagonal(m, dim1=-2, dim2=-1))
    qacc_ref = dyn.limit_qacc(model, state.qpos, state.qvel)
    if BALL in model.jnt_type:
        qacc_ref = qacc_ref + dyn.ball_limit_qacc(model, state.qpos,
                                                  state.qvel)
    if model.ntendon:
        qacc_ref = qacc_ref + dyn.tendon_limit_qacc(model, state.qpos,
                                                    state.qvel)
    if model.neq:
        qacc_ref = qacc_ref + dyn.equality_qacc(model, data, cdof,
                                                state.qpos, state.qvel)
    return m, qfrc, bias, qacc_ref, None


def _qacc(model: Model, state: State, ctrl, warm=None, sweeps=None,
          rows=None, body_pos=None):
    """Forward-dynamics acceleration -> (qacc, warm', rows'): warm seeds
    the implicit solver's impulses, warm' re-seeds the next substep or RK4
    stage; ``rows`` reuses frozen constraint rows, rows' are the rows
    built or reused (both None on the penalty path)."""
    m, qfrc, bias, qacc_ref, ctx = _forces_and_mass(model, state, ctrl,
                                                    body_pos)
    if model.solver == PGS:
        data, cdof = ctx
        qacc, _, lam, rows = constrained_qacc(
            model, data, cdof, state.qpos, state.qvel, m, qfrc - bias, warm,
            sweeps=sweeps, ctx=rows)
        return qacc, lam, rows
    return spd_solve(m, qfrc - bias) + qacc_ref, None, None


def qacc_smooth(model: Model, state: State, ctrl, body_pos=None):
    """qacc = M^-1 (qfrc_total - bias) + the penalty limits' reference
    acceleration, or the implicit solver's constrained acceleration
    (MuJoCo's mj_forward qacc)."""
    return _qacc(model, state, ctrl, body_pos=body_pos)[0]


def _euler_step(model: Model, state: State, ctrl, warm=None, sweeps=None,
                body_pos=None):
    t = model_tables(model, state.qpos.dtype, state.qpos.device)
    h = t.timestep
    m, qfrc, bias, qacc_ref, ctx = _forces_and_mass(model, state, ctrl,
                                                    body_pos)
    # implicit joint damping: M + h diag(B)
    mh = m + h * torch.diag(t.dof_damping)
    if model.solver == PGS:
        data, cdof = ctx
        # constraint QP against M (as mj_forward), then mj_Euler's implicit
        # damping integrates smooth + constraint force with M + hB
        qacc_c, a0, warm_out, _ = constrained_qacc(
            model, data, cdof, state.qpos, state.qvel, m, qfrc - bias,
            warm, sweeps=sweeps)
        qfrc_con = torch.matmul(m, (qacc_c - a0).unsqueeze(-1))[..., 0]
        qacc = spd_solve(mh, qfrc - bias + qfrc_con)
    else:
        qacc = spd_solve(mh, qfrc - bias) + qacc_ref
        warm_out = None
    qvel = state.qvel + h * qacc
    qpos = integrate_pos(model, state.qpos, qvel, h)
    return State(qpos=qpos, qvel=qvel), warm_out


def _rk4_step(model: Model, state: State, ctrl, warm=None, sweeps=None,
              rows=None, body_pos=None):
    h = model_tables(model, state.qpos.dtype, state.qpos.device).timestep
    k1_v, w, rows = _qacc(model, state, ctrl, warm, sweeps, rows, body_pos)
    kp, kv = state.qvel, k1_v
    acc_p, acc_v = kp, kv
    # stages 2-4, warm-started from the previous stage; the constraint
    # rows rebuilt at every stage (MuJoCo's mj_RungeKutta) unless the model
    # freezes them
    stage_rows = rows if model.row_freeze_step else None
    for c_i, w_i in ((0.5, 2.0), (0.5, 2.0), (1.0, 1.0)):
        ch = c_i * h
        s = State(qpos=integrate_pos(model, state.qpos, kp, ch),
                  qvel=state.qvel + ch * kv)
        kv, w, _ = _qacc(model, s, ctrl, w, SWEEPS_WARM, stage_rows,
                         body_pos)
        kp = s.qvel
        acc_p = acc_p + w_i * kp
        acc_v = acc_v + w_i * kv
    qpos = integrate_pos(model, state.qpos, acc_p / 6.0, h)
    qvel = state.qvel + (h / 6.0) * acc_v
    return State(qpos=qpos, qvel=qvel), w, rows


def step_warm(model: Model, state: State, ctrl, warm=None, sweeps=None,
              rows=None, body_pos=None):
    """One physics timestep -> (state', warm', rows'): warm/warm' carry
    the implicit solver's impulses across consecutive substeps, rows/rows'
    an RK4 model's frozen constraint rows (all None on the penalty path);
    ``sweeps`` overrides the dual's iteration count (None = the cold
    default); ``body_pos`` as in ``kinematics.body_frames``."""
    if model.integrator == RK4:
        return _rk4_step(model, state, ctrl, warm, sweeps, rows, body_pos)
    s2, w2 = _euler_step(model, state, ctrl, warm, sweeps, body_pos)
    return s2, w2, None


def step(model: Model, state: State, ctrl, body_pos=None):
    """One physics timestep with the model's integrator."""
    return step_warm(model, state, ctrl, body_pos=body_pos)[0]


def step_n(model: Model, state: State, ctrl, n: int, body_pos=None):
    """``n`` substeps with constant ctrl.  Under the implicit solver the
    first substep solves cold with ``SWEEPS`` iterations and the others
    warm-start from the previous substep's impulses with ``SWEEPS_WARM``;
    with ``row_freeze_step`` the first substep's rows hold for all ``n``."""
    if model.solver != PGS:
        for _ in range(n):
            state = step(model, state, ctrl, body_pos)
        return state
    state, warm, rows = step_warm(model, state, ctrl, None, SWEEPS,
                                  body_pos=body_pos)
    frozen = rows if model.row_freeze_step else None
    for _ in range(n - 1):
        state, warm, _ = step_warm(model, state, ctrl, warm, SWEEPS_WARM,
                                   frozen, body_pos)
    return state
