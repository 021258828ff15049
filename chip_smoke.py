#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py          # needs one NVIDIA GPU (built for sm_90a)

Phases, each a JSON object on a line of its own; the first failure exits
non-zero with the phase's name:

1. device   refuses to run without CUDA; prints the card's name and power
            limit as nvidia-smi gives them.
2. build    builds every kernel from mjrl_tpu_torch/csrc with nvcc, one
            process per library, all started together, at every lane-group
            size L (lanes per environment): the smooth kernel for the
            swimmer at L = 1, 2, 4, 8, the contact / RK4 kernel for Hopper,
            Walker2d and HalfCheetah at L = 1, 8, 16, 32; prints seconds,
            registers, stack frame and spills.
3. kernels  each kernel at every L against its plain PyTorch version ON THE
            CARD, same numpy-seeded inputs, at the shapes the main path gives
            it, with its time, the plain version's time and its roofline
            bound; the L of a kernel timed in turns (L = 1, the others, the
            others again, L = 1) on one card.  A kernel's time is the
            device's time per launch: the calls are replayed as a CUDA graph,
            so the wrapper's host cost (tens of microseconds, more than the
            smooth kernel takes) stays out; each kernel's host-paced time
            (a loop of calls from Python) is printed beside it.
3b. fvp_kernel  K3, the NPG update's Fisher-vector product
            (ops/cuda_fvp.py), built for the Swimmer's and Hopper's 32-32
            policies and a 64-64 one in float32 and float64, ON THE CARD at
            16 384 x 1000 rows against the float64 plain version (float32
            within 1e-4 of the largest entry, float64 1e-10 at 10^6 rows),
            with the plain version's and the double backward's gaps beside
            it; its time (graph_ms), its bound and their times.
4. rollout  SwimmerEnv, 4096 environments x 500 steps, 64-64 policy,
            stochastic: every leaf finite, one kernel launch per step.
5. train    the Swimmer main path through the entry points a user calls:
            GymEnv -> MLP -> LinearBaseline -> NPG -> train_agent, 3
            iterations of 4096 trajectories; finite statistics, KL within
            the guard, one launch per control step of every rollout.
6. rollout_hopper  HopperEnv, 4096 x 1000, stochastic: finite leaves, one
            contact-kernel launch per step, episodes that end early behind a
            non-increasing mask.
7. train_hopper    the Hopper-v3 main path, same entry points, 3 iterations
            of 4096 trajectories x 1000 steps; 3000 launches of the contact
            kernel and none of the smooth one.
8. train_job_hopper_npg   the repo's examples/example_configs/hopper_npg.json
            through examples/torch_policy_opt_job_script.py (MLP 32-32
            policy, MLPBaseline 128-128, 10 000 samples per iteration) with
            autoreset set in memory, 3 iterations: num_samples equal to the
            10 x 1000 grid, KL within the guard, 3000 contact launches and
            11 K3 launches an iteration (CG's 10 iterations + 1).
9. train_job_swimmer_ppo  swimmer_ppo.json the same way (PPO, MLPBaseline,
            10 x 500), 3 iterations: 1500 smooth launches.
10. train_hopper_trpo     TRPO (kl_dist 0.01) with a QuadraticBaseline on
            Hopper-v3 at 4096 x 1000 with autoreset, 3 iterations: KL under
            kl_dist, every grid cell a sample, 3000 contact launches.
11. bc_swimmer  demos from the PPO phase's policy (10 x 500), BC with the MSE
            loss and the data's transforms, 5 epochs, then an evaluation
            rollout: 1000 smooth launches, the loss falls.
12. autoreset_card  an autoreset Hopper rollout (64 x 20, float64, injected
            noise and fresh states) on the card against the same rollout on
            the CPU (the contact kernel's plain version).

The general engine (physics/step.py, eager PyTorch: no kernel of csrc/)
carries the last four phases; each asserts finite leaves and no launch of
either planar kernel, and prints its launches per control step and the
device's busy share over a profiled window (torch.profiler):

13. rollout_point_mass  PointMassEnv (penalty, RK4), 4096 x 25, 32-32
            policy, stochastic, float32.
14. rollout_reacher     Reacher7DOFEnv at its default implicit solver
            (limits and the fingertip-table contact through the dual),
            4096 x 50, 64-64 policy, float32; then a 64 x 5 float64 rollout
            with injected noise and resets on the card against the CPU
            (1e-10): this engine has no kernel to hold against a plain
            version, so this is its check that the card computes the same.
15. rollout_inverted_pendulum  InvertedPendulumEnv (penalty, RK4),
            4096 x 100: episodes end behind a non-increasing mask.
16. train_job_point_mass_npg  examples/example_configs/point_mass_npg.json
            through examples/torch_policy_opt_job_script.py, 3 iterations
            (40 paths x 25, 10 evaluation rollouts): KL within the guard,
            success_rate and eval_success logged and finite.

The model-based branch, DAPG and MPC (M10), each at the full width of its
shipped configuration with only its counts cut; each prints its seconds,
peak device memory and kernel launches:

17. train_model_accel_point_mass  mjrl_tpu_torch/.../configs/point_mass.json
            through run_model_accel_npg (4-member 256-256 ensemble, 32-32
            policy, 100 imagined paths x 25 per update, 4 updates an
            iteration), 2 iterations and 2 evaluation episodes: every
            member's losses logged, finite, num_samples 500 then 250; the
            ms per Adam step of the stacked 4-member fit with its launches.
18. train_model_accel_reacher  reacher.json the same way, 1 iteration
            (2500 samples, 5 updates of 250 x 4 imagined paths x 50 steps),
            1 evaluation episode.
19. dapg_point_mass  examples/torch_dapg_point_mass.py: 3 NPG iterations of
            the expert, 10 demos, BC, 3 DAPG iterations (40 paths each), 2
            evaluation episodes.
20. mbac_point_mass  one MBAC train_step (one 25-step path labelled by
            MBAC's default MPCActor: H 10, 25 candidates in the real
            engine); seconds per MPCActor action.
21. mpc_actor_swimmer  3 MPCActor actions on the Swimmer: H = 10 launches
            of K1 per action (all candidates in one launch per step), each
            launch held against the plain step on its own inputs (float32
            at K1's tolerances, and the same inputs in float64).
22. learned_mpc_point_mass  run_model_learning_mpc with 4 models, 2
            iterations of 2 MPC episodes; seconds per MPCPolicy action.
23. m10_card_vs_cpu  float64, card against CPU: a 4-member 256-256 stacked
            fit (injected permutations, 11 Adam steps), one MPCPolicy action
            (injected candidates), one DAPG update.

The contact half of the general engine (M9a: every narrowphase pair,
pyramidal friction, the contact_topk cap, frozen rows, fixed tendons),
each phase asserting finite statistics and no launch of either planar
kernel, with its launches per control step and the device's busy share:

24. rollout_peg  PegEnv (implicit solver, 282 contact slots capped at 64
            rows, rows frozen for the control step), 4096 x 50 (the full
            horizon), 64-64 policy, random, float32: the moved hole's y
            spans its reset range.
25. train_peg_npg  NPG on mjrl_peg_insertion-v0 through GymEnv -> MLP ->
            MLPBaseline -> NPG -> train_agent with tools/train_gym.py's
            hyperparameters (64-64, init_log_std -0.5, step 0.05, gamma
            0.995, GAE 0.97, MLPBaseline reg 1e-3, batch 64, 2 epochs),
            4096 x 50, 1 iteration (cut from 2).
26. train_ant_npg  the same on Ant-v3 (rows rebuilt at every RK4 stage),
            4096 environments, 2 iterations, the horizon cut from 1000 to
            the largest that keeps a rollout within 0.55 of 30 s (cut from
            40 s) by the measured seconds of a 2-step rollout; the cut is
            printed.
27. rollout_humanoid  HumanoidEnv (140 slots, the condim-1 class capped at
            64, 2 fixed tendons), 4096 x 10 (cut from 1000).
28. contact_card_vs_cpu  float64, B 8: 2 control steps of peg and Ant from
            tests/golden's contact states on the card and on the CPU: obs,
            state and reward within 1e-9, equal slot_ids.

The rest of the general engine (M9b: condim 4 and 6, the elliptic cone,
the primal Newton solver, noslip, equalities, servos and transmissions)
and the Adroit hand, each phase asserting no launch of either planar kernel:

29. m9b_card_vs_cpu  float64, B 8, 2 control steps on the card and on the
            CPU within 1e-9: a sphere on a plane at condim 4 and 6 (dual
            and Newton), the elliptic cone on Hopper-v3's contact states
            through the general engine, a weld, a connect and a joint
            equality, an affine servo, a vector-gear motor on a ball joint
            and a tendon-transmission motor.
30. relocate_card_vs_cpu  float64: the 20 first grasp states of
            tests/golden/contact_adroit.npz through qacc_smooth on the card
            and on the CPU (1e-9 relative), the card against MuJoCo's golden
            qacc (median relative error < 0.05); one control step from 8
            golden states, card against CPU.
31. rollout_relocate  AdroitRelocateEnv (36 dof, 30 servos, 709 rows,
            Newton 25 iterations, noslip), 4096 x 20 (the horizon cut from
            200), random 64-64 policy, float32.
32. dapg_relocate  examples/torch_dapg_relocate.py at the example's widths
            (64-64 policy, MLPBaseline, 50 paths): 2 expert demos made on
            the card at horizon 25, 2 BC epochs, 1 DAPG iteration at horizon
            25; finite statistics, the KL within the guard; the success rate
            printed, not checked.

The host utilities (M12) around the training loop, each phase printing its
seconds and its launches of K1 and K2:

33. native_paths_hopper  a Hopper-v3 rollout (64 x 1000, K2) as ragged
            paths: returns and GAE through the native path ops (host C++,
            built with g++) against the plain numpy loops (1e-12), pack_paths
            exactly; the seconds of each, and of the returns of 1024 host
            paths of up to 1000 steps.
34. checkpoint_resume_hopper  Hopper-v3 NPG (64-64, LinearBaseline) at
            4096 x 1000: agent A takes 2 iterations; B takes 1 and saves
            (utils/checkpoint.py); C, built with another seed, restores it
            and takes 1; C's policy equals A's within 1e-5 (the largest
            difference printed); 4000 K2 launches.
35. sweep_swimmer_ppo  utils/sweep.py over swimmer_ppo.json, grid seed=1,2
            rl_num_iter=1, through the job script: two job directories with
            finite logs, 1000 K1 launches.
36. visualize_swimmer, visualize_hopper  GymEnv.visualize_policy, horizon
            100, the mean action: one launch at B = 1 per control step (the
            step count read from the episode's qpos file); then
            render_trajectory's geometry for the point mass and the reacher,
            card against CPU (1e-5, float32).  The frames are drawn where
            matplotlib is present, else "drawn": false with the reason.
37. mjcf_env_card  MJCFEnv on envs/mjcf/inverted_pendulum.xml with a torch
            reward: 4096 x 100 float32 (finite), and 8 x 5 float64 card
            against CPU (1e-10).
38. external_env_card  a host env behind GymEnv with the policy on the card
            (evaluate_policy), then 1 iteration of run_model_accel_npg on
            configs/point_mass.json with env_factory pointing at it.
39. profile_swimmer  one Swimmer NPG train_step (4096 x 500) inside
            utils/profiling.trace: the Chrome trace names K1's kernel (the
            count of its events printed beside the 500 launches);
            time_jitted of one control step.
40. fit_data_card  utils/optimize_model.fit_data at float64, card against
            CPU with the same permutations (1e-10).
41. examples_m12  examples/torch_{point_mass_smoke,linear_nn_comparison,
            visualizer_smoke}.py with their counts cut (each cut printed).

Data parallelism over ranks (M11: mjrl_tpu_torch/parallel/), each phase
printing its seconds and its launches of K1 and K2 (per rank):

42. m11_world1_hopper  an NCCL group of world size 1 in this process:
            Hopper-v3 NPG (64-64, LinearBaseline) at 4096 x 1000, one
            iteration through NPG(..., mesh=make_mesh()): 1000 K2 launches,
            none of K1; its statistics and parameters against the unsharded
            agent's iteration from the same seed (1e-6 relative, float32).
43. m11_two_ranks_hopper  two fresh processes of this script
            (``--m11-rank``), a gloo group over CUDA tensors on the one
            card (NCCL refuses two ranks on one card), each loading the
            build phase's kernels and building none: the same iteration,
            2048 rows and 1000 K2 launches per rank, one K2 launch on each
            rank's rows held against the plain version; statistics and
            parameters against the one-rank run at the JAX package's bounds
            (rtol 1e-3 / atol 1e-3; rtol 1e-2 / atol 1e-3), and what the
            update moves (alpha, kl_dist, the norm of the parameters'
            change) at rtol 1e-2, the step's size printed beside it.
44. m11_two_ranks_swimmer_ppo  swimmer_ppo.json (PPO + MLPBaseline, the
            minibatch gradients all-reduced) on the two ranks, one
            iteration: 500 K1 launches per rank, the same bounds (kl_dist
            and the step's norm; PPO's alpha is its learning rate).
45. m11_ensemble  a 4-member WorldModelEnsemble (float64) fitted and
            queried on the two ranks, two members each, against one rank
            (1e-10); then the seconds per iteration at one rank, at world
            size 1 and on two ranks, with the collectives' count.
            Two ranks on one card measure correctness and overhead, not
            scaling.  The pair has 300 s; a failing rank stops the other.

M11 on every card of one host, as a user runs it (``m11_cards``): R fresh
processes of this script started by ``torchrun --standalone
--nproc-per-node R`` (``--cards-rank``), each joining through
parallel.distributed.initialize() and global_mesh() and loading the build
phase's kernels: R = 4 over NCCL, one rank per card, on a host of four
cards or more; else R = 2 over gloo (asked for) sharing the one card.  The
line ``m11_cards`` says which ran; torchrun stops the other ranks when one
fails, and this process stops torchrun after 420 s.

46. m11_cards  Hopper-v3 NPG at 4096 x 1000 (m11_hopper_iteration's agent)
            through train_agent on the R ranks: 2 iterations with save_freq
            1, a resume for 1 more, 3 uninterrupted; against train_agent's
            first 2 iterations on one rank in this process: the first
            iteration's statistics equal, parameters, alpha, kl_dist and the
            step's norm within PR 11's bounds, the job directory's files
            equal; the resumed run equal to the uninterrupted one bit for
            bit on every rank, each resumed policy on its rank's card; 1000
            K2 launches per rank and iteration.  swimmer_ppo.json (10
            swimmers, 12 at R = 4) and a 4-member float64 ensemble against
            one rank (1e-12); one K2 and one K1 launch on each rank's 4096 /
            R rows against the plain version.  Printed per rank, not held:
            seconds per iteration, launches, collectives, the device's
            busy share over a 20-step rollout window.
            On four cards, Hopper NPG seconds per iteration at R = 1, 2 and
            4: strong (4096 rows split R ways) and weak (R x 4096 rows).

The learning path (``learning``): a policy the JAX package trained, and
the port's learning CLI, each printing its seconds and its launches of K1
and K2:

47. hopper_jax_policy_card  the JAX package's trained Hopper-v3 policy
            (tests/golden/torch_hopper_npg_jax_policy.npz, loaded through
            convert) rolled 100 x 1000 stochastically and 100 x 1000 in
            eval_mode on the card (tools/torch_hopper_transplant.py): 2000
            K2 launches; the port's mean return, standard error and mean
            length beside the JAX package's float32 CPU evaluation stored
            in the golden; fails when the stochastic means lie more than 4
            combined standard errors apart.  Every 100th K2 launch of the
            path (20, B 100) keeps its inputs and outputs and is held
            against the plain step on them (float32: 3e-4 in q, 3e-3 in v
            relative to the largest velocity).
48. train_gym_hopper  tools/torch_train_gym.py's main in this process:
            Hopper-v3, 100 trajectories x 1000, 3 iterations, step 0.1 (the
            agent of tools/bench_hopper.py): every key of the JAX tool's row
            present and finite in each row, 3000 K2 launches.

Each phase's launches are counted from just before it to just after.  The
last line is {"ok": true, "device": {...}}.
"""

import contextlib
import importlib.util
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from mjrl_tpu_torch import convert, native
from mjrl_tpu_torch.algos import BC, NPG, TRPO
from mjrl_tpu_torch.algos import functional as algos_functional
from mjrl_tpu_torch.baselines import (LinearBaseline, MLPBaseline,
                                     QuadraticBaseline)
from mjrl_tpu_torch.device import make_generator
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.envs.adroit import AdroitRelocateEnv
from mjrl_tpu_torch.envs.mjcf_env import MJCFEnv
from mjrl_tpu_torch.envs.gym_suite import (AntEnv, HalfCheetahEnv,
                                           HopperEnv, HumanoidEnv,
                                           InvertedPendulumEnv, Walker2dEnv)
from mjrl_tpu_torch.envs.peg_insertion import PegEnv
from mjrl_tpu_torch.envs.point_mass import PointMassEnv
from mjrl_tpu_torch.envs.reacher import Reacher7DOFEnv
from mjrl_tpu_torch.envs.swimmer import SwimmerEnv
from mjrl_tpu_torch.models.fc_network import make_transforms
from mjrl_tpu_torch.models.policies import MLP, GaussianMLP
from mjrl_tpu_torch.ops import cuda_fvp, cuda_planar
from mjrl_tpu_torch.physics import dynamics, planar, solver
from mjrl_tpu_torch.physics.collision import contact_pair_condims
from mjrl_tpu_torch.physics.kinematics import body_frames
from mjrl_tpu_torch.physics.mjcf import load_mjcf
from mjrl_tpu_torch.physics.model import ELLIPTIC, State
from mjrl_tpu_torch.physics.planar import step_n_arrays
from mjrl_tpu_torch.physics.step import qacc_smooth, step_n
from mjrl_tpu_torch.samplers.rollout import (paths_to_list, rollout_batch,
                                             sample_paths)
from mjrl_tpu_torch.utils import (checkpoint, optimize_model,
                                  process_samples, profiling, render, sweep)
from mjrl_tpu_torch.utils.config import load_config
from mjrl_tpu_torch.utils.train_agent import train_agent

# published peaks of one H100 SXM (NVIDIA data sheet): the roofline bound
# is stated against them, with the card's power limit printed beside it
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

NUM_ENVS = 4096
HORIZON = 500
FRAME_SKIP = 5
NITER = 3
HOPPER_HORIZON = 1000
HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, "examples")
TOOLS = os.path.join(HERE, "tools")
SMOOTH, CONTACT = "planar_step_smooth", "planar_step_contact"
# contact kernel vs plain version, float32: the bounds of the JAX package's
# own float32 check of this branch (positions 3e-4; velocities 3e-3, here
# relative to the state set's largest velocity).  Up to 20 chained dual
# solves amplify rounding, and a flipped restart test of the accelerated
# descent is a legitimate difference in float32.  float64: 1e-9.
CONTACT_TOL = {torch.float64: (1e-9, 1e-9), torch.float32: (3e-4, 3e-3)}


def emit(obj):
    print(json.dumps(obj, default=float), flush=True)


def time_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` calls made from Python, by
    CUDA events: the device's time only while the host enqueues faster
    than the device runs."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps, replays=5):
    """Mean device milliseconds per call of ``fn``: ``reps`` calls captured
    into one CUDA graph, the graph replayed ``replays`` times between two
    CUDA events, so the host's cost of a call stays out."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (reps * replays)


class _OpCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the elementwise tensor operations the plain version issues:
    on (1,)-shaped components each is one scalar operation per
    environment."""
    SKIP = ("zeros_like", "ones_like", "select", "stack", "cat", "_to_copy",
            "unsqueeze", "view", "detach", "alias", "empty", "lift_fresh")

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if not any(s in name for s in self.SKIP):
            self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def count_plain_ops(p, n):
    """Scalar operations per environment of one control step (n substeps),
    counted by running the plain version on one environment."""
    nu = len(p.actuators)
    q = torch.full((1, p.nv), 0.1, dtype=torch.float64)
    u = torch.full((1, nu), 0.1, dtype=torch.float64)
    with _OpCounter() as c:
        step_n_arrays(p, q, q.clone(), u, n)
    return sum(c.counts.values()), c.counts


def count_component_ops(fn):
    """Scalar operations of ``fn`` run in component form on one
    environment."""
    with _OpCounter() as c:
        fn()
    return sum(c.counts.values())


def solve_ops(nv, first=0, last=0):
    """Scalar operations of one solve with a Cholesky factor, in component
    form, whose right-hand side is an exact zero above row ``first`` and of
    whose result only rows >= ``last`` are read: the forward pass starts at
    ``first`` and the back-substitution stops at ``last``, as in K1's
    chol_solve (first = last = 0: the plain version's solve)."""
    one = torch.ones(1, dtype=torch.float64)

    def solve():
        y, out = {}, {}
        for i in range(first, nv):
            s = one
            for k in range(first, i):
                s = s - one * y[k]
            y[i] = s / one
        for i in reversed(range(last, nv)):
            s = y.get(i, one)
            for k in range(i + 1, nv):
                s = s - one * out[k]
            out[i] = s / one
    return count_component_ops(solve)


def count_kernel_ops(p, n):
    """Scalar operations per environment of one control step (n substeps)
    of K1's algorithm at L = 1: the plain version's count less the work the
    kernel leaves out, plus the reciprocals it takes.  Per substep it leaves
    out the products with exact zeros (the rows of each unit column of M^-1
    before its unit entry; the back-substitution rows below the smallest
    limited dof in the limit dual's solves, a0 and the columns; avp's
    rotation sums, 2 per chain entry), the impedance ramp's other branch
    (counted as the longer one, 1 - x, / (1 - mid), ** power, (1 - mid) *,
    1 -: 5 operations, so the count errs low) and the Gauss-Seidel divisor's
    sum in every sweep after the first; it takes one reciprocal per Cholesky
    pivot and per Gauss-Seidel divisor.  -> (kernel count, plain count)."""
    plain, _ = count_plain_ops(p, n)
    nv = p.nv
    lim = [d for d in range(nv) if p.limited[d]]
    factorizations = 2 if any(p.damping) else 1
    per_substep = 2 * int(sum(map(sum, planar.chain_mask(p)))) \
        - factorizations * nv
    if lim:
        full = solve_ops(nv)
        per_substep += (full - solve_ops(nv, 0, lim[0])
                        + sum(full - solve_ops(nv, d, lim[0]) for d in lim)
                        + 5 * len(lim) + (planar.PGS_SWEEPS - 1) * len(lim)
                        - len(lim))
    return plain - n * per_substep, plain


def count_contact_ops(p, n):
    """Scalar operations per environment of one control step of the contact
    kernel.  Smooth dynamics and row assembly are counted from the component
    form on one environment; the rest is fixed work, from the formula
    (C rows, nv dofs, s sweeps, P power iterations, per acceleration
    evaluation):

      Cholesky nv^3/3 + nv^2, a0 and M^-1 J^T: (C + 1) (2 nv^2 + 2 nv),
      scales, right-hand sides, impulses: C (8 nv + 7),
      dual operator (P + s) times: 4 C nv + 3 C each,
      power normalisation 3 C P, sweep bookkeeping 12 C s
      (gradient step 3, projection 2, restart test 4, momentum 3);

    evaluations: 4 n for RK4 (1 cold of 50 sweeps, the rest warm of 15), n
    for Euler, which adds a second Cholesky, a solve and M (qacc - a0)."""
    nv, nu, C = p.nv, len(p.actuators), planar.n_planar_rows(p)
    q = [torch.full((1,), 0.1, dtype=torch.float64) for _ in range(nv)]
    u = [torch.full((1,), 0.1, dtype=torch.float64) for _ in range(nu)]
    ctx = planar._planar_ctx(p, q)
    smooth = count_component_ops(lambda: planar._planar_smooth(p, q, q, u))
    rows = count_component_ops(
        lambda: planar._constraint_rows_comp(p, ctx, q, q))
    chol = nv ** 3 // 3 + nv ** 2
    solve = 2 * nv ** 2 + 2 * nv

    def evaluation(sweeps):
        return (smooth + rows + chol + (C + 1) * solve + C * (8 * nv + 7)
                + (planar.POWER_ITERS + sweeps) * (4 * C * nv + 3 * C)
                + 3 * C * planar.POWER_ITERS + 12 * C * sweeps)
    evals = n if p.integrator == 0 else 4 * n
    total = evaluation(planar.SWEEPS) + (evals - 1) * evaluation(
        planar.SWEEPS_WARM)
    if p.integrator == 0:
        total += n * (chol + solve + 2 * nv * nv + 6 * nv)
    else:
        total += evals * 6 * nv
    return total, {"rows": C, "smooth": smooth, "row_assembly": rows,
                   "evaluations": evals}


def swimmer_test_states(B, seed):
    """Half random states (q in U(-.5,.5), v, u in U(-1,1)), half
    limit-active (hinges pushed 0.1..0.5 rad past the +-1.5 stops, moving
    into the stop).  All states lie off the limit boundary, where kernel
    and plain version could legitimately take different branches."""
    rng = np.random.RandomState(seed)
    q = rng.uniform(-0.5, 0.5, (B, 7))
    v = rng.uniform(-1.0, 1.0, (B, 7))
    u = rng.uniform(-1.0, 1.0, (B, 4))
    h = B // 2
    q[:h, 3:] = rng.uniform(1.6, 2.0, (h, 4)) * rng.choice([-1, 1], (h, 4))
    v[:h, 3:] = np.sign(q[:h, 3:]) * np.abs(v[:h, 3:])
    return q, v, u


def contact_test_states(p, qpos0, B, seed):
    """Half near-rest standing states; the others dropped up to 0.4 into the floor with the joints scattered, a
    third of the limited joints pushed 0.05 to 0.3 rad past a stop and moving
    into it, velocities up to 5.  All lie off the contact and limit
    boundaries, where kernel and plain version could legitimately take
    different branches; poses in which two capsule axes come within 1 cm of
    crossing are left out, because there the contact normal is 0 / 0 and
    rounding alone turns it."""
    rng = np.random.RandomState(seed)
    n, nv, nu = 2 * B, p.nv, len(p.actuators)
    drop = np.arange(n) % 2 == 1
    col = drop[:, None]
    q = np.tile(np.asarray(qpos0, np.float64), (n, 1)) + np.where(
        col, rng.uniform(-0.15, 0.15, (n, nv)),
        rng.uniform(-0.02, 0.02, (n, nv)))
    q[:, 1] -= np.where(drop, rng.uniform(0.05, 0.4, n), 0.0)
    v = np.where(col, rng.uniform(-5.0, 5.0, (n, nv)),
                 rng.uniform(-0.1, 0.1, (n, nv)))
    u = rng.uniform(-1.0, 1.0, (n, nu))
    for d in range(nv):
        if p.limited[d]:
            hit = drop & (rng.uniform(size=n) < 1.0 / 3.0)
            side = rng.choice([-1.0, 1.0], n)
            over = rng.uniform(0.05, 0.3, n)
            q[:, d] = np.where(hit, np.where(side > 0, p.hi[d] + over,
                                             p.lo[d] - over), q[:, d])
            v[:, d] = np.where(hit, side * np.abs(v[:, d]), v[:, d])
    keep = np.flatnonzero(planar.capsule_axis_distance(
        p, torch.tensor(q)).numpy() > 0.01)[:B]
    if len(keep) != B:
        raise AssertionError("too few well-conditioned test states")
    return q[keep], v[keep], u[keep]


def dropped_states(p, qpos0, B, seed):
    """Every environment 0.4 into the floor, joints scattered by 0.15,
    velocities up to 1: the states of the JAX package's own float32 check of
    the contact branch (tests/test_pallas_planar.py)."""
    rng = np.random.RandomState(seed)
    q = np.tile(np.asarray(qpos0, np.float64), (B, 1)) \
        + rng.uniform(-0.15, 0.15, (B, p.nv))
    q[:, 1] -= 0.4
    return (q, rng.uniform(-1.0, 1.0, (B, p.nv)),
            rng.uniform(-1.0, 1.0, (B, len(p.actuators))))


def cheetah_explosion_states():
    """The captured high-velocity half-cheetah states of tests/golden (the
    one that had already exploded when it was captured is left out)."""
    d = np.load(os.path.join(HERE, "tests", "golden",
                             "cheetah_explosion_states.npz"))
    ts = [t for t in sorted(int(k[2:]) for k in d.files
                            if k.startswith("t_"))
          if np.abs(d[f"qvel_{t}"]).max() < 1e4]
    return tuple(np.stack([d[f"{k}_{t}"] for t in ts]).astype(np.float64)
                 for k in ("qpos", "qvel", "action"))


# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build(models):
    """models: name -> PlanarParams.  One nvcc per library (per model and
    lane-group size), started together -> {model: {lanes: ptxas figures}}."""
    items = [(name, p, L) for name, p in models.items()
             for L in cuda_planar.kernel_lanes(p)]
    t0 = time.time()
    infos = cuda_planar.build_kernels([(p, L) for _, p, L in items])
    built = {}
    for (name, p, L), (_, info) in zip(items, infos):
        built.setdefault(name, {
            "kernel": cuda_planar.kernel_name(p),
            "source": cuda_planar.kernel_source(cuda_planar.kernel_name(p)),
            "builds": {}})["builds"][str(L)] = {
                "nvcc_seconds": info["build_seconds"], "ptxas": info["ptxas"]}
    emit({"phase": "build", "seconds": time.time() - t0, "models": built,
          "headers": ["mjrl_tpu_torch/csrc/planar_body.cuh",
                      "mjrl_tpu_torch/csrc/planar_contact.cuh"]})
    return {name: {L: b["ptxas"] for L, b in m["builds"].items()}
            for name, m in built.items()}


def phase_kernels(p, smi, ptxas):
    """The smooth kernel (K1) for the swimmer at every L against the plain
    version, then timed; ptxas: its figures by L from the build phase."""
    dev = torch.device("cuda")
    lanes_all = cuda_planar.kernel_lanes(p)
    lanes = cuda_planar.default_lanes(p)
    checks = []
    worst = 0.0
    for B in (NUM_ENVS, 1000):
        q, v, u = swimmer_test_states(B, seed=B)
        for dtype, tol_q, tol_v in ((torch.float64, 1e-9, 1e-9),
                                    (torch.float32, 2e-5, 2e-4)):
            tq, tv, tu = (torch.tensor(a, dtype=dtype, device=dev)
                          for a in (q, v, u))
            rq, rv = step_n_arrays(p, tq, tv, tu, FRAME_SKIP)
            for L in lanes_all:
                gq, gv = cuda_planar.cuda_step_n_batched(
                    p, tq, tv, tu, FRAME_SKIP, lanes=L)
                torch.cuda.synchronize()
                if not (torch.isfinite(gq).all() and torch.isfinite(gv).all()):
                    raise AssertionError(f"kernel, {L} lanes: output not "
                                         "finite")
                torch.testing.assert_close(gq, rq, rtol=tol_q, atol=tol_q,
                                           msg=lambda m: f"{L} lanes, q: {m}")
                torch.testing.assert_close(gv, rv, rtol=tol_v, atol=tol_v,
                                           msg=lambda m: f"{L} lanes, v: {m}")
                eq = (gq - rq).abs().max().item()
                ev = (gv - rv).abs().max().item()
                checks.append({"B": B, "lanes": L,
                               "dtype": str(dtype).split(".")[-1],
                               "max_abs_err_q": eq, "max_abs_err_v": ev,
                               "rtol_atol_q": tol_q, "rtol_atol_v": tol_v})
                if dtype == torch.float32 and L == lanes:
                    worst = max(worst, eq, ev)

    # the kernel computes the impedance's pow(t, 2) as t * t; the plain
    # version's t ** 2.0 must be the same on the card
    pow2 = {}
    for dtype in (torch.float32, torch.float64):
        t = torch.tensor(swimmer_test_states(NUM_ENVS, seed=3)[0],
                         dtype=dtype, device=dev)
        pow2[str(dtype).split(".")[-1]] = bool(torch.equal(t ** 2.0, t * t))
    if not all(pow2.values()):
        raise AssertionError(f"t ** 2.0 differs from t * t: {pow2}")

    # times at the main path's shape: 4096 environments, n = 5, every L in
    # turns, float32 (the main path's type) and float64
    q, v, u = swimmer_test_states(NUM_ENVS, seed=1)
    by_lanes = {}
    for dtype in (torch.float32, torch.float64):
        tq, tv, tu = (torch.tensor(a, dtype=dtype, device=dev)
                      for a in (q, v, u))
        by_lanes[str(dtype).split(".")[-1]] = time_lanes(
            p, tq, tv, tu, FRAME_SKIP, 200)
    tq, tv, tu = (torch.tensor(a, dtype=torch.float32, device=dev)
                  for a in (q, v, u))
    ms, ms_lanes1 = by_lanes["float32"][lanes], by_lanes["float32"][1]
    # what a caller that launches one kernel at a time from Python sees:
    # the wrapper's host cost per call is larger than this kernel's time
    host_loop = time_lanes(p, tq, tv, tu, FRAME_SKIP, 200, timer=time_ms)
    plain_ms = time_ms(lambda: step_n_arrays(p, tq, tv, tu, FRAME_SKIP), 3)

    ops_per_env, ops_plain = count_kernel_ops(p, FRAME_SKIP)
    nbytes = NUM_ENVS * (4 * p.nv + len(p.actuators)) * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = NUM_ENVS * ops_per_env / PEAK_FP32_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return {
        "name": SMOOTH, "route": "cuda",
        "source": cuda_planar.kernel_source(SMOOTH),
        "replaces": "mjrl_tpu/ops/pallas_planar.py:85",
        "launches": None,                    # filled in from the train phase
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,   # no single PyTorch call computes this function
        "lanes": lanes, "ms_lanes1": ms_lanes1,
        "speedup_vs_lanes1": ms_lanes1 / ms,
        "roofline_share": bound_ms / ms,
        "roofline_share_lanes1": bound_ms / ms_lanes1,
        "ms_by_lanes": by_lanes, "ms_host_loop": host_loop[lanes],
        "ms_host_loop_by_lanes": host_loop,
        "pow2_is_square": pow2,
        "ptxas": ptxas,
        "ms_float64": by_lanes["float64"][lanes],
        # the kernel's algorithm (count_kernel_ops), and the plain version's
        # count, which includes the products with exact zeros it skips
        "ops_per_env_step": ops_per_env, "ops_plain": ops_plain,
        "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "shape": {"B": NUM_ENVS, "nv": p.nv, "nu": len(p.actuators),
                  "n": FRAME_SKIP, "dtype": "float32"},
        "card": smi, "checks": checks,
    }


def check_contact_kernel(p, q, v, u, n, dtype):
    """Every lane-group size of the contact kernel against one run of the
    plain version on the card -> {lanes: (max abs error q, v)}."""
    dev = torch.device("cuda")
    tq, tv, tu = (torch.tensor(a, dtype=dtype, device=dev)
                  for a in (q, v, u))
    rq, rv = step_n_arrays(p, tq, tv, tu, n)
    tol_q, tol_v = CONTACT_TOL[dtype]
    errs = {}
    for L in cuda_planar.LANES:
        gq, gv = cuda_planar.cuda_step_n_batched(p, tq, tv, tu, n, lanes=L)
        torch.cuda.synchronize()
        if not (torch.isfinite(gq).all() and torch.isfinite(gv).all()):
            raise AssertionError(f"contact kernel, {L} lanes: output not "
                                 "finite")
        torch.testing.assert_close(gq, rq, rtol=tol_q, atol=tol_q,
                                   msg=lambda m: f"{L} lanes, q: {m}")
        torch.testing.assert_close(
            gv, rv, rtol=tol_v, atol=tol_v * max(1.0, rv.abs().max().item()),
            msg=lambda m: f"{L} lanes, v: {m}")
        errs[L] = ((gq - rq).abs().max().item(),
                   (gv - rv).abs().max().item())
    return errs


def time_lanes(p, tq, tv, tu, n, reps, timer=graph_ms):
    """Milliseconds per launch of every lane-group size of ``p``'s kernel on
    the same inputs, in turns (L = 1, the others, the others again, L = 1)
    -> {lanes: mean of its two readings}.  By default the device's time per
    launch (``graph_ms``: the calls replayed as a CUDA graph, the wrapper's
    host cost left out)."""
    rest = list(cuda_planar.kernel_lanes(p)[1:])
    readings = {L: [] for L in cuda_planar.kernel_lanes(p)}
    for L in [1] + rest + rest[::-1] + [1]:
        readings[L].append(timer(lambda: cuda_planar.cuda_step_n_batched(
            p, tq, tv, tu, n, lanes=L), reps))
    return {L: sum(r) / len(r) for L, r in readings.items()}


def phase_kernels_contact(envs, smi, ptxas):
    """envs: name -> env (Hopper, Walker2d, HalfCheetah); ptxas: the build
    phase's figures by model and lanes."""
    dev = torch.device("cuda")
    checks, worst, times, times64 = [], 0.0, {}, {}
    for name, env in envs.items():
        p, n = env._planar, env.frame_skip
        sets = [(f"B{B}", contact_test_states(p, env.model.qpos0, B, seed=B))
                for B in (NUM_ENVS, 1000)]
        if name == "half_cheetah":
            sets.append(("explosion", cheetah_explosion_states()))
        for label, (q, v, u) in sets:
            for dtype in (torch.float64, torch.float32):
                errs = check_contact_kernel(p, q, v, u, n, dtype)
                for L, (eq, ev) in errs.items():
                    checks.append({"model": name, "states": label,
                                   "B": len(q), "lanes": L,
                                   "dtype": str(dtype).split(".")[-1],
                                   "max_abs_err_q": eq, "max_abs_err_v": ev,
                                   "max_abs_v": float(np.abs(v).max()),
                                   "tol_q": CONTACT_TOL[dtype][0],
                                   "tol_v_rel": CONTACT_TOL[dtype][1]})
                    if dtype == torch.float32 and name == "hopper" \
                            and L == cuda_planar.default_lanes(p):
                        worst = max(worst, eq, ev)
        q, v, u = sets[0][1]
        for dtype, out in ((torch.float32, times), (torch.float64, times64)):
            tq, tv, tu = (torch.tensor(a, dtype=dtype, device=dev)
                          for a in (q, v, u))
            out[name] = time_lanes(p, tq, tv, tu, n, 10)

    # the main path's shape: Hopper, float32, 4096 environments, n = 4, at
    # the model's lane-group size, and at L = 1 (one thread per environment)
    env = envs["hopper"]
    p, n = env._planar, env.frame_skip
    lanes = cuda_planar.default_lanes(p)
    q, v, u = contact_test_states(p, env.model.qpos0, NUM_ENVS, seed=1)
    tq, tv, tu = (torch.tensor(a, dtype=torch.float32, device=dev)
                  for a in (q, v, u))
    by_lanes = time_lanes(p, tq, tv, tu, n, 20)
    ms, ms_lanes1 = by_lanes[lanes], by_lanes[1]
    host_loop = time_lanes(p, tq, tv, tu, n, 20, timer=time_ms)
    plain_ms = time_ms(lambda: step_n_arrays(p, tq, tv, tu, n), 2)
    tq64, tv64, tu64 = tq.double(), tv.double(), tu.double()
    ms_f64 = graph_ms(lambda: cuda_planar.cuda_step_n_batched(
        p, tq64, tv64, tu64, n), 10)
    # the work is fixed; is the time?  the same launch on states that are
    # all in contact at moderate velocity
    dq, dv, du = (torch.tensor(a, dtype=torch.float32, device=dev)
                  for a in dropped_states(p, env.model.qpos0, NUM_ENVS, 2))
    ms_dropped = graph_ms(lambda: cuda_planar.cuda_step_n_batched(
        p, dq, dv, du, n), 10)
    ops_per_env, parts = count_contact_ops(p, n)
    nbytes = NUM_ENVS * (4 * p.nv + len(p.actuators)) * 4
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = NUM_ENVS * ops_per_env / PEAK_FP32_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return {
        "name": CONTACT, "route": "cuda",
        "source": cuda_planar.kernel_source(CONTACT),
        "replaces": "mjrl_tpu/ops/pallas_planar.py:47",
        "launches": None,             # filled in from the train_hopper phase
        "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,   # no single PyTorch call computes this function
        "lanes": lanes, "ms_lanes1": ms_lanes1,
        "speedup_vs_lanes1": ms_lanes1 / ms,
        "roofline_share": bound_ms / ms,
        "roofline_share_lanes1": bound_ms / ms_lanes1,
        "ms_host_loop": host_loop[lanes],
        "ms_host_loop_by_lanes": host_loop,
        "ms_by_lanes": {"hopper_main_path_float32": by_lanes,
                        "float32_B4096": times, "float64_B4096": times64},
        "default_lanes": {k: cuda_planar.default_lanes(e._planar)
                          for k, e in envs.items()},
        "ptxas": ptxas,
        "ms_float64": ms_f64, "ms_dropped_states": ms_dropped,
        "ops_per_env_step": ops_per_env, "ops_parts": parts, "bytes": nbytes,
        "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "shape": {"B": NUM_ENVS, "nv": p.nv, "nu": len(p.actuators),
                  "n": n, "dtype": "float32"},
        "card": smi, "checks": checks,
    }


# ---- K3, the Fisher-vector product -------------------------------------------

FVP_ROWS = 16384 * 1000          # both cells' rows an iteration
FVP_CASES = (("swimmer", (12, 32, 32, 4)), ("hopper", (11, 32, 32, 3)),
             ("swimmer_64_64", (12, 64, 64, 4)))
# kernel against the float64 plain version, worst leaf's largest gap over
# its largest entry: float32 sums of 16.4 M rows in another order (the
# kernel's per-block sums of ~62 000 rows, cuBLAS's split-K in the plain
# version); the double backward's own gap is printed beside it
FVP_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


def fvp_problem(sizes, n, dtype, seed):
    """A policy of ``sizes`` (tanh) at random parameters, non-identity
    transforms, ``n`` observations, a mask with ~10 % zeros and a direction
    v, all drawn on the card from ``seed`` -> (policy, params, transforms,
    obs, mask, v)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device="cuda",
                                    dtype=dtype)
    pol = GaussianMLP(sizes[0], sizes[-1], sizes[1:-1], dtype=dtype,
                      device="cuda")
    params = {k: rn(*v.shape) / math.sqrt(v.shape[-1])
              for k, v in pol.param_dict().items()}
    params["log_std"] = -0.5 + 0.2 * rn(sizes[-1])
    tr = make_transforms(sizes[0], sizes[-1], rn(sizes[0]),
                         1.0 + rn(sizes[0]).abs(), rn(sizes[-1]),
                         0.5 + rn(sizes[-1]).abs(), dtype=dtype,
                         device="cuda")
    obs = 2.0 * rn(n, sizes[0])
    mask = (torch.rand(n, generator=g, device="cuda") > 0.1).to(dtype)
    v = {k: rn(*x.shape) for k, x in params.items()}
    return pol, params, tr, obs, mask, v


def fvp_double_backward(pol, params, tr, obs, mask):
    """The port's former product, the yardstick: the KL's first-order graph
    over every row kept, each product a double backward -> v -> F v."""
    F = algos_functional
    p = F._leaf_params(params)
    with torch.enable_grad():
        kl = F._local_share(F._kl_terms(pol, p, F._detach(params), tr, obs),
                            mask, None)
        grad_kl = torch.autograd.grad(kl, list(p.values()), create_graph=True)

    def hvp(v):
        with torch.enable_grad():
            gv = sum(torch.sum(gk * v[k]) for gk, k in zip(grad_kl, p))
            return dict(zip(p, torch.autograd.grad(gv, list(p.values()),
                                                   retain_graph=True)))
    return hvp


def fvp_gap(got, ref, keys):
    """Worst leaf's largest gap over its largest entry (flat vectors in
    ``keys``' order, split by the reference's leaves)."""
    worst, i = 0.0, 0
    for k, n in keys:
        a, b = got[i:i + n].double(), ref[i:i + n].double()
        worst = max(worst, float((a - b).abs().max() / b.abs().max()))
        i += n
    return worst


def phase_fvp_kernel(smi):
    """K3 against its plain version and the double backward ON THE CARD at
    16 384 x 1000 rows, for the cells' 32-32 policies and a 64-64 one, with
    its time (graph_ms), its bound and the others' times; float64 at 1e6
    rows; one launch counted per product."""
    t0 = time.time()
    shapes = [cuda_fvp.FvpShape(sz, False) for _, sz in FVP_CASES]
    from concurrent.futures import ThreadPoolExecutor
    builds = [(sh, dt) for sh in shapes for dt in (torch.float32,
                                                    torch.float64)]
    with ThreadPoolExecutor(len(builds)) as pool:
        infos = list(pool.map(lambda b: cuda_fvp.build_kernel(*b)[1],
                              builds))
    out = {"phase": "fvp_kernel", "rows": FVP_ROWS, "nvidia_smi": smi,
           "build_seconds": time.time() - t0,
           "ptxas": {f"{b[0].sizes}/{str(b[1])[6:]}":
                     {**i["ptxas"], "rows": i["rows"],
                      "smem_bytes": i["smem_bytes"]}
                     for b, i in zip(builds, infos)}, "cases": {}}
    for (name, sizes), shape in zip(FVP_CASES, shapes):
        for dtype, n in ((torch.float32, FVP_ROWS), (torch.float64, 10 ** 6)):
            pol, params, tr, obs, mask, v = fvp_problem(sizes, n, dtype, 17)
            rows = mask.sum()
            fv = cuda_fvp.FisherVectorProduct(params, "tanh", tr, obs, mask,
                                              rows, rows)
            if not fv.use_kernel:
                raise AssertionError(f"fvp_kernel: {name} takes the plain "
                                     "form on the card")
            flat = torch.cat([v[k].reshape(-1) for k in fv.keys])
            keys = [(k, params[k].numel()) for k in fv.keys]
            before = cuda_fvp.launch_counts[cuda_fvp.KERNEL]
            got = fv(flat)
            torch.cuda.synchronize()
            if cuda_fvp.launch_counts[cuda_fvp.KERNEL] != before + 1:
                raise AssertionError("fvp_kernel: one launch a product")
            args = (shape, fv.theta, flat, fv.in_shift, fv.in_scale, fv.coef,
                    fv.cls, fv.obs, fv.mask)
            plain = cuda_fvp.fvp_plain(*args)
            ref = cuda_fvp.fvp_plain(*(a.double() if torch.is_tensor(a)
                                       else a for a in args))
            dbl = fvp_double_backward(pol, params, tr, obs, mask)
            got_d = dbl(v)
            got_d = torch.cat([got_d[k].reshape(-1) for k in fv.keys])
            case = {"kernel_gap": fvp_gap(got, ref, keys),
                    "plain_gap": fvp_gap(plain, ref, keys),
                    "double_backward_gap": fvp_gap(got_d, ref, keys),
                    "kernel_vs_plain": fvp_gap(got, plain, keys),
                    "tol": FVP_TOL[dtype]}
            if not case["kernel_gap"] <= FVP_TOL[dtype]:
                raise AssertionError(f"fvp_kernel {name} {dtype}: {case}")
            if not torch.isfinite(got).all():
                raise AssertionError(f"fvp_kernel {name}: not finite")
            del ref
            if dtype == torch.float32:
                mac = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
                flops = 3 * 2 * mac * n       # portbench/counts.py's count
                nbytes = n * (sizes[0] + 1) * 4
                case.update(
                    kernel_graph_ms=graph_ms(lambda: fv(flat), 5),
                    kernel_ms=time_ms(lambda: fv(flat), 5),
                    plain_ms=time_ms(lambda: cuda_fvp.fvp_plain(*args), 3),
                    double_backward_ms=time_ms(lambda: dbl(v), 3),
                    bound_ms=max(flops / 67e12, nbytes / 3.35e12) * 1e3,
                    bound_by="operations" if flops / 67e12 > nbytes / 3.35e12
                    else "bytes")
                case["roofline_pct"] = (100 * case["bound_ms"]
                                        / case["kernel_graph_ms"])
            out["cases"][f"{name}/{str(dtype)[6:]}"] = case
            del pol, params, tr, obs, mask, v, fv, dbl, plain, got, got_d
            torch.cuda.empty_cache()
    out["seconds"] = time.time() - t0
    emit(out)
    return out


def phase_rollout(kernel_ms):
    env = SwimmerEnv()
    assert env.device.type == "cuda"
    policy = MLP(env.spec, hidden_sizes=(64, 64), seed=1)
    gen = make_generator(7, env.device)
    times = []
    for _ in range(2):          # first pass warms up
        cuda_planar.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        batch = rollout_batch(env, policy.config, policy.params,
                              policy.transforms, gen, NUM_ENVS,
                              horizon=HORIZON)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        launches = cuda_planar.launch_counts[SMOOTH]
        if launches != HORIZON:
            raise AssertionError(
                f"rollout launched the kernel {launches} times, expected "
                f"{HORIZON}")
    for k, leaf in batch.items():
        if torch.is_tensor(leaf) and leaf.is_floating_point() \
                and not torch.isfinite(leaf).all():
            raise AssertionError(f"rollout leaf {k} not finite")
    if tuple(batch["observations"].shape) != (NUM_ENVS, HORIZON, 12) \
            or tuple(batch["actions"].shape) != (NUM_ENVS, HORIZON, 4):
        raise AssertionError("rollout shapes wrong")
    emit({"phase": "rollout", "num_envs": NUM_ENVS, "horizon": HORIZON,
          "seconds_first": times[0], "seconds": times[1],
          "control_steps_per_s": NUM_ENVS * HORIZON / times[1],
          "kernel_launches": launches,
          "kernel_share_of_rollout": launches * kernel_ms * 1e-3 / times[1],
          "mean_return": batch["rewards"].sum(1).mean().item()})


def phase_rollout_hopper(kernel_ms):
    env = HopperEnv()
    assert env.device.type == "cuda"
    policy = MLP(env.spec, hidden_sizes=(64, 64), seed=1)
    gen = make_generator(7, env.device)
    roll = lambda T: rollout_batch(env, policy.config, policy.params,
                                   policy.transforms, gen, NUM_ENVS,
                                   horizon=T)
    roll(20)                                        # warms up
    cuda_planar.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    batch = roll(HOPPER_HORIZON)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(cuda_planar.launch_counts)
    if launches != {SMOOTH: 0, CONTACT: HOPPER_HORIZON}:
        raise AssertionError(
            f"hopper rollout launched {launches}, expected "
            f"{HOPPER_HORIZON} of {CONTACT} only")
    for k, leaf in batch.items():
        if torch.is_tensor(leaf) and leaf.is_floating_point() \
                and not torch.isfinite(leaf).all():
            raise AssertionError(f"hopper rollout leaf {k} not finite")
    if tuple(batch["observations"].shape) \
            != (NUM_ENVS, HOPPER_HORIZON, 11) \
            or tuple(batch["actions"].shape) != (NUM_ENVS, HOPPER_HORIZON, 3):
        raise AssertionError("hopper rollout shapes wrong")
    mask = batch["mask"]
    if not bool((mask[:, :-1] >= mask[:, 1:]).all()) \
            or not bool(((mask == 0) | (mask == 1)).all()):
        raise AssertionError("mask is not a prefix of ones")
    lengths = mask.sum(1)
    n_term = int(batch["terminated"].sum())
    if n_term == 0 or not bool((lengths < HOPPER_HORIZON).any()):
        raise AssertionError("no episode terminated early")
    if not bool((batch["terminated"] == (lengths < HOPPER_HORIZON)).all()):
        raise AssertionError("terminated disagrees with the mask")
    if float((batch["rewards"] * (1 - mask)).abs().sum()) != 0.0:
        raise AssertionError("rewards after the end of an episode")
    valid_per_s = float(mask.sum()) / seconds
    emit({"phase": "rollout_hopper", "num_envs": NUM_ENVS,
          "horizon": HOPPER_HORIZON, "seconds": seconds,
          "control_steps_per_s": NUM_ENVS * HOPPER_HORIZON / seconds,
          "valid_steps": int(mask.sum()), "valid_samples_per_s": valid_per_s,
          "kernel_launches": launches[CONTACT],
          "kernel_share_of_rollout": launches[CONTACT] * kernel_ms * 1e-3
          / seconds,
          "terminated": n_term,
          "mean_episode_length": lengths.mean().item(),
          "mean_return": (batch["rewards"] * mask).sum(1).mean().item()})
    return valid_per_s


def phase_train(env_id, step_size, horizon, kernel, phase):
    """The main path of ``env_id`` through the entry points a user calls;
    -> launches of ``kernel``, counted from just before to just after."""
    e = GymEnv(env_id)
    policy = MLP(e.spec, hidden_sizes=(64, 64))
    baseline = LinearBaseline(e.spec)
    agent = NPG(e, policy, baseline, normalized_step_size=step_size,
                save_logs=True)
    assert agent.device.type == "cuda" and policy.device.type == "cuda"
    other = SMOOTH if kernel == CONTACT else CONTACT
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, phase)
        cuda_planar.reset_launch_counts()     # just before the main path
        with contextlib.redirect_stdout(sys.stderr):
            train_agent(job, agent, seed=0, niter=NITER, num_traj=NUM_ENVS,
                        gamma=0.995, gae_lambda=0.97, save_freq=10)
        torch.cuda.synchronize()
        counts = dict(cuda_planar.launch_counts)    # just after
        for f in ("results.txt",
                  os.path.join("iterations", "policy_final.pickle"),
                  os.path.join("iterations", "checkpoint_final.pickle"),
                  os.path.join("logs", "log.csv")):
            if not os.path.exists(os.path.join(job, f)):
                raise AssertionError(f"train_agent did not write {f}")
    if counts != {kernel: NITER * horizon, other: 0}:
        raise AssertionError(
            f"training launched {counts}, expected {NITER * horizon} of "
            f"{kernel} only")
    log = agent.logger.log
    check_log(log, phase)
    if not np.all(np.isfinite(policy.get_param_values())):
        raise AssertionError("policy parameters not finite")
    kl_cap = agent.kl_guard * agent.n_step_size / 2
    if not all(kl <= kl_cap * (1 + 1e-6) for kl in log["kl_dist"]):
        raise AssertionError(f"kl_dist {log['kl_dist']} above {kl_cap}")
    if not all(s > 0 for s in log["surr_improvement"]):
        raise AssertionError(
            f"surr_improvement not positive: {log['surr_improvement']}")
    emit({"phase": phase, "env": env_id, "iterations": NITER,
          "num_traj": NUM_ENVS, "kernel_launches": counts,
          "num_samples": log["num_samples"],
          "time_sampling": log["time_sampling"],
          "time_npg": log["time_npg"], "time_VF": log["time_VF"],
          "kl_dist": log["kl_dist"],
          "surr_improvement": log["surr_improvement"],
          "stoc_pol_mean": log["stoc_pol_mean"]})
    return counts[kernel]


def example_module(name, folder=EXAMPLES):
    """The module of examples/<name>.py (or of <folder>/<name>.py)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(folder, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def job_script():
    """The port's job script, examples/torch_policy_opt_job_script.py."""
    return example_module("torch_policy_opt_job_script")


def check_log(log, phase, n=NITER):
    for k, vals in log.items():
        if len(vals) != n or not np.all(np.isfinite(vals)):
            raise AssertionError(f"{phase}: logged {k} missing or not "
                                 f"finite: {vals}")


def run_counted(fn):
    """fn() with every launch count set to 0 just before and read just
    after -> (fn's result, counts, seconds)."""
    torch.cuda.synchronize()
    cuda_planar.reset_launch_counts()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(cuda_planar.launch_counts), time.time() - t0


def phase_train_job(config, kernel, horizon, phase, overrides):
    """A config of examples/example_configs through the port's job script,
    as a user runs it (``main``), 3 iterations -> (agent, launches);
    ``kernel`` None: neither planar kernel may launch."""
    script = job_script()
    cfg_path = os.path.join(EXAMPLES, "example_configs", config)
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, phase)
        argv = ["--output", job, "--config", cfg_path, "--set",
                f"rl_num_iter={NITER}", *overrides]
        with contextlib.redirect_stdout(sys.stderr):
            agent, counts, seconds = run_counted(lambda: script.main(argv))
        for f in ("job_config.json", "results.txt",
                  os.path.join("iterations", "checkpoint_final.pickle"),
                  os.path.join("iterations", "baseline_final.pickle")):
            if not os.path.exists(os.path.join(job, f)):
                raise AssertionError(f"{phase}: the job script did not "
                                     f"write {f}")
    if kernel is None:
        want = NO_LAUNCHES
    else:
        other = SMOOTH if kernel == CONTACT else CONTACT
        want = {kernel: NITER * horizon, other: 0}
    if counts != want:
        raise AssertionError(f"{phase}: launched {counts}, expected {want}")
    if agent.device.type != "cuda" or agent.baseline.device.type != "cuda":
        raise AssertionError(f"{phase}: the agent is not on the card")
    log = agent.logger.log
    check_log(log, phase)
    if not np.all(np.isfinite(agent.policy.get_param_values())):
        raise AssertionError(f"{phase}: policy parameters not finite")
    bl = agent.baseline.cfg
    return agent, counts, seconds, \
        bl.epochs * (log["num_samples"][0] // bl.batch_size)


def phase_train_job_hopper_npg():
    cuda_fvp.reset_launch_counts()
    agent, counts, seconds, vf_steps = phase_train_job(
        "hopper_npg.json", CONTACT, HOPPER_HORIZON, "train_job_hopper_npg",
        ['alg_hyper_params={"autoreset": True}'])
    fvp_launches = cuda_fvp.launch_counts[cuda_fvp.KERNEL]
    want = NITER * (agent.FIM_invert_args.get("iters", 10) + 1)
    if fvp_launches != want:
        raise AssertionError(f"train_job_hopper_npg: {fvp_launches} "
                             f"Fisher-vector launches, expected {want} (CG "
                             "iterations + 1 an iteration)")
    log = agent.logger.log
    grid = math.ceil(10000 / HOPPER_HORIZON) * HOPPER_HORIZON
    if not agent.autoreset or log["num_samples"] != [grid] * NITER:
        raise AssertionError(f"num_samples {log['num_samples']}, expected "
                             f"the grid, {grid}, in every iteration")
    kl_cap = agent.kl_guard * agent.n_step_size / 2
    if not all(kl <= kl_cap * (1 + 1e-6) for kl in log["kl_dist"]):
        raise AssertionError(f"kl_dist {log['kl_dist']} above {kl_cap}")
    emit({"phase": "train_job_hopper_npg", "config": "hopper_npg.json",
          "autoreset": True, "iterations": NITER, "seconds": seconds,
          "kernel_launches": counts, "num_samples": log["num_samples"],
          "num_episodes": log["num_episodes"],
          "fvp_launches": fvp_launches,
          "time_sampling": log["time_sampling"], "time_npg": log["time_npg"],
          "time_VF": log["time_VF"], "vf_adam_steps": vf_steps,
          "vf_us_per_adam_step": [t / vf_steps * 1e6
                                  for t in log["time_VF"]],
          "kl_dist": log["kl_dist"], "VF_error_after": log["VF_error_after"],
          "stoc_pol_mean": log["stoc_pol_mean"]})
    return counts[CONTACT]


def phase_train_job_swimmer_ppo():
    agent, counts, seconds, vf_steps = phase_train_job(
        "swimmer_ppo.json", SMOOTH, HORIZON, "train_job_swimmer_ppo", [])
    log = agent.logger.log
    if type(agent).__name__ != "PPO" or agent.clip_coef != 0.2 \
            or agent.epochs != 10 or agent.mb_size != 64 \
            or agent.learn_rate != 5e-4:
        raise AssertionError("swimmer_ppo.json did not build its PPO")
    if log["num_samples"] != [10 * HORIZON] * NITER:
        raise AssertionError(f"num_samples {log['num_samples']}")
    adam = agent.opt_state["count"]
    if adam != NITER * 10 * (10 * HORIZON // 64):
        raise AssertionError(f"{adam} PPO Adam steps")
    emit({"phase": "train_job_swimmer_ppo", "config": "swimmer_ppo.json",
          "iterations": NITER, "seconds": seconds, "kernel_launches": counts,
          "num_samples": log["num_samples"],
          "time_sampling": log["time_sampling"], "t_opt": log["t_opt"],
          "ppo_adam_steps_per_iteration": adam // NITER,
          "ppo_us_per_adam_step": [t / (adam // NITER) * 1e6
                                   for t in log["t_opt"]],
          "time_VF": log["time_VF"], "vf_adam_steps": vf_steps,
          "vf_us_per_adam_step": [t / vf_steps * 1e6
                                  for t in log["time_VF"]],
          "kl_dist": log["kl_dist"], "stoc_pol_mean": log["stoc_pol_mean"]})
    return agent, counts[SMOOTH]


def phase_train_hopper_trpo(fixed_grid_valid_per_s):
    e = GymEnv("Hopper-v3")
    policy = MLP(e.spec, hidden_sizes=(64, 64))
    baseline = QuadraticBaseline(e.spec)
    agent = TRPO(e, policy, baseline, kl_dist=0.01, save_logs=True,
                 autoreset=True)
    if baseline.cfg.num_features() != 82:
        raise AssertionError("QuadraticBaseline of 11 obs is not 82 wide")
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "train_hopper_trpo")
        with contextlib.redirect_stdout(sys.stderr):
            _, counts, seconds = run_counted(lambda: train_agent(
                job, agent, seed=0, niter=NITER, num_traj=NUM_ENVS,
                gamma=0.995, gae_lambda=0.97, save_freq=10))
    want = {CONTACT: NITER * HOPPER_HORIZON, SMOOTH: 0}
    if counts != want:
        raise AssertionError(f"TRPO launched {counts}, expected {want}")
    log = agent.logger.log
    check_log(log, "train_hopper_trpo")
    grid = NUM_ENVS * HOPPER_HORIZON
    if log["num_samples"] != [grid] * NITER:
        raise AssertionError(f"num_samples {log['num_samples']} short of "
                             f"the grid {grid}")
    if not all(kl < 0.01 for kl in log["kl_dist"]):
        raise AssertionError(f"kl_dist {log['kl_dist']} not under 0.01")
    steps_per_s = [grid / t for t in log["time_sampling"]]
    emit({"phase": "train_hopper_trpo", "env": "Hopper-v3",
          "num_traj": NUM_ENVS, "horizon": HOPPER_HORIZON,
          "autoreset": True, "baseline": "QuadraticBaseline, 82 features",
          "iterations": NITER, "seconds": seconds, "kernel_launches": counts,
          "num_samples": log["num_samples"],
          "num_episodes": log["num_episodes"],
          "line_search_steps": log["line_search_steps"],
          "kl_dist": log["kl_dist"], "alpha": log["alpha"],
          "time_sampling": log["time_sampling"], "time_npg": log["time_npg"],
          "time_VF": log["time_VF"],
          "control_steps_per_s": steps_per_s,
          "valid_samples_per_s": steps_per_s,
          "fixed_grid_valid_samples_per_s": fixed_grid_valid_per_s,
          "VF_error_after": log["VF_error_after"],
          "stoc_pol_mean": log["stoc_pol_mean"]})
    return counts[CONTACT]


def phase_bc_swimmer(expert):
    e = GymEnv("mjrl_swimmer-v0")
    policy = MLP(e.spec, hidden_sizes=(32, 32), seed=500)

    def run():
        demos = sample_paths(10, e, expert, base_seed=1)
        bc = BC(demos, policy, epochs=5, batch_size=64, lr=1e-3,
                loss_type="MSE", set_transforms=True)
        bc.train()
        ev = sample_paths(10, e, policy, eval_mode=True, base_seed=2)
        return demos, bc, ev

    (demos, bc, ev), counts, seconds = run_counted(run)
    want = {SMOOTH: 2 * HORIZON, CONTACT: 0}
    if counts != want:
        raise AssertionError(f"BC launched {counts}, expected {want}")
    n = sum(len(p["observations"]) for p in demos)
    log = bc.logger.log
    before, after = log["loss_before"][-1], log["loss_after"][-1]
    returns = [float(np.sum(p["rewards"])) for p in ev]
    if n != 10 * HORIZON or not np.isfinite(after) or not after < before \
            or not np.all(np.isfinite(returns)):
        raise AssertionError(f"BC: {n} demo steps, loss {before} -> {after}, "
                             f"returns {returns}")
    emit({"phase": "bc_swimmer", "demo_steps": n, "seconds": seconds,
          "kernel_launches": counts, "adam_steps": bc.opt_state["count"],
          "loss_before": before, "loss_after": after, "time_fit": log["time"],
          "eval_mean_return": float(np.mean(returns)),
          "expert_mean_return": float(np.mean([np.sum(p["rewards"])
                                               for p in demos]))})
    return counts[SMOOTH]


def phase_autoreset_card():
    """The autoreset Hopper rollout on the card (K2) against the same
    rollout on the CPU (K2's plain version), float64, same noise and fresh
    states: a third of the starts and fresh states tilted past the healthy
    range's edge, so rows hold several episodes."""
    B, T = 64, 20
    rng = np.random.RandomState(17)
    devices = ("cuda", "cpu")
    envs = [HopperEnv(dtype=torch.float64, device=d) for d in devices]
    qpos0 = envs[1].model.qpos0

    def starts(*lead):
        q = np.tile(qpos0, lead + (1,)) + rng.uniform(-5e-3, 5e-3,
                                                      lead + (6,))
        v = rng.uniform(-5e-3, 5e-3, lead + (6,))
        tilt = rng.uniform(size=lead) < 1.0 / 3.0
        q[..., 2] = np.where(tilt, 0.19, q[..., 2])
        v[..., 2] = np.where(tilt, 1.5, v[..., 2])
        return q, v

    q0, v0 = starts(B)
    resets = starts(T, B)
    noise = rng.normal(size=(T, B, 3))
    spec = envs[1].spec
    params = convert.params_to_numpy(MLP(
        spec, hidden_sizes=(64, 64), seed=3, dtype=torch.float64,
        device="cpu").params)
    out = []
    for d, env in zip(devices, envs):
        policy = convert.policy_params_from_numpy(
            MLP(spec, hidden_sizes=(64, 64), dtype=torch.float64, device=d),
            params)
        out.append(run_counted(lambda: rollout_batch(
            env, policy.config, policy.params, policy.transforms, None, B,
            horizon=T, autoreset=True,
            state0=env.state_from_qpos_qvel(q0, v0),
            noise=torch.tensor(noise, device=d),
            resets=tuple(torch.tensor(a, device=d) for a in resets))))
    (gpu, counts, seconds), (cpu, _, _) = out
    if counts != {CONTACT: T, SMOOTH: 0}:
        raise AssertionError(f"autoreset rollout launched {counts}")
    tol = CONTACT_TOL[torch.float64][0]
    errs = {}
    for k in ("observations", "actions", "rewards", "last_obs"):
        torch.testing.assert_close(gpu[k].cpu(), cpu[k], rtol=tol, atol=tol,
                                   msg=lambda m: f"{k}: {m}")
        errs[k] = (gpu[k].cpu() - cpu[k]).abs().max().item()
    if not torch.equal(gpu["dones"].cpu(), cpu["dones"]):
        raise AssertionError("dones differ between the card and the CPU")
    n_done = int(cpu["dones"].sum())
    if n_done == 0 or float(cpu["dones"].sum(1).max()) < 2:
        raise AssertionError(f"{n_done} episode ends: the grid does not "
                             "restart episodes")
    emit({"phase": "autoreset_card", "B": B, "horizon": T,
          "dtype": "float64", "kernel_launches": counts,
          "episode_ends": n_done, "max_abs_err": errs, "rtol_atol": tol,
          "seconds": seconds})
    return counts[CONTACT]


# ---------------------------------------------------------------------------
# the general engine (eager PyTorch): no planar kernel on these paths
# ---------------------------------------------------------------------------

NO_LAUNCHES = {SMOOTH: 0, CONTACT: 0}


def profiled_window(fn, steps):
    """fn() under torch.profiler (device activity only) -> (device launches
    per control step, share of the window's wall time the device was busy,
    window ms).  The device's events are read from the raw Kineto results:
    building the profiler's per-event tables costs far more than the
    window on paths of tens of thousands of launches per step, so the
    windows are one or two steps long."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.time() - t0) * 1e3
    busy_ms, n = 0.0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            busy_ms += e.duration_ns() / 1e6
            n += 1
    return n / steps, busy_ms / window_ms, window_ms


def check_finite(batch, phase):
    for k, leaf in batch.items():
        if torch.is_tensor(leaf) and leaf.is_floating_point() \
                and not torch.isfinite(leaf).all():
            raise AssertionError(f"{phase}: leaf {k} not finite")


def general_rollout(phase, env, hidden, horizon, window):
    """A stochastic rollout of ``env`` at NUM_ENVS x horizon through the
    general engine: no planar kernel launches; -> (batch, record)."""
    assert env.device.type == "cuda" and env._planar is None
    policy = MLP(env.spec, hidden_sizes=hidden, seed=1)
    gen = make_generator(7, env.device)
    roll = lambda T: rollout_batch(env, policy.config, policy.params,
                                   policy.transforms, gen, NUM_ENVS,
                                   horizon=T)
    roll(2)                                         # warms up
    torch.cuda.reset_peak_memory_stats()
    batch, counts, seconds = run_counted(lambda: roll(horizon))
    if counts != NO_LAUNCHES:
        raise AssertionError(f"{phase}: launched {counts}")
    check_finite(batch, phase)
    A, O = env.action_dim, env.observation_dim
    if tuple(batch["observations"].shape) != (NUM_ENVS, horizon, O) \
            or tuple(batch["actions"].shape) != (NUM_ENVS, horizon, A):
        raise AssertionError(f"{phase}: shapes wrong")
    per_step, busy, window_ms = profiled_window(lambda: roll(window), window)
    return batch, {
        "phase": phase, "num_envs": NUM_ENVS, "horizon": horizon,
        "dtype": str(env.dtype).replace("torch.", ""), "seconds": seconds,
        "control_steps_per_s": NUM_ENVS * horizon / seconds,
        "ms_per_control_step": seconds / horizon * 1e3,
        "kernel_launches": counts, "window_steps": window,
        "window_ms": window_ms, "device_launches_per_step": per_step,
        "device_busy_share": busy,
        "peak_device_memory_bytes": torch.cuda.max_memory_allocated()}


def phase_rollout_point_mass():
    batch, rec = general_rollout("rollout_point_mass", PointMassEnv(),
                                 (32, 32), 25, 2)
    solved = batch["env_infos"]["solved"]
    rec.update(mean_return=batch["rewards"].sum(1).mean().item(),
               success_rate=PointMassEnv.evaluate_success(
                   solved.cpu().numpy()))
    emit(rec)
    return rec["kernel_launches"]


def reacher_card_vs_cpu():
    """A 64 x 5 float64 reacher rollout (injected start states near the
    joint limits, targets, action noise and autoreset fresh states) on the
    card against the same on the CPU -> max abs error by leaf."""
    B, T = 64, 5
    rng = np.random.RandomState(19)
    envs = [Reacher7DOFEnv(dtype=torch.float64, device=d)
            for d in ("cuda", "cpu")]
    lo, hi = envs[1].model.jnt_range[:, 0], envs[1].model.jnt_range[:, 1]
    q0 = rng.uniform(lo - 0.05, hi + 0.05, (B, 7))
    v0 = rng.uniform(-2, 2, (B, 7))
    target = rng.uniform(-1, 1, (B, 3)) * np.array([0.3, 0.2, 0.25])
    resets = (np.zeros((T, B, 7)), np.zeros((T, B, 7)))
    noise = rng.normal(size=(T, B, 7))
    params = convert.params_to_numpy(MLP(
        envs[1].spec, hidden_sizes=(64, 64), seed=3, dtype=torch.float64,
        device="cpu").params)
    out = []
    for env in envs:
        d = env.device
        policy = convert.policy_params_from_numpy(
            MLP(env.spec, hidden_sizes=(64, 64), dtype=torch.float64,
                device=d), params)
        out.append(run_counted(lambda: rollout_batch(
            env, policy.config, policy.params, policy.transforms, None, B,
            horizon=T, autoreset=True,
            state0=env.state_from_qpos_qvel(q0, v0, {"target_pos": target}),
            noise=torch.tensor(noise, device=d),
            resets=tuple(torch.tensor(a, device=d) for a in resets)))[:2])
    (gpu, counts), (cpu, _) = out
    if counts != NO_LAUNCHES:
        raise AssertionError(f"reacher card vs CPU launched {counts}")
    tol, errs = 1e-10, {}
    for k in ("observations", "actions", "rewards", "last_obs"):
        torch.testing.assert_close(gpu[k].cpu(), cpu[k], rtol=tol, atol=tol,
                                   msg=lambda m: f"{k}: {m}")
        errs[k] = (gpu[k].cpu() - cpu[k]).abs().max().item()
    return {"B": B, "horizon": T, "dtype": "float64", "rtol_atol": tol,
            "max_abs_err": errs}


def phase_rollout_reacher():
    env = Reacher7DOFEnv()
    if env.model.solver != 1 or not env.model.contact_pairs:
        raise AssertionError("the reacher is not on its implicit solver "
                             "with its table contact")
    batch, rec = general_rollout("rollout_reacher", env, (64, 64), 50, 2)
    rec["mean_return"] = batch["rewards"].sum(1).mean().item()
    q = batch["observations"][..., :7]
    lo = torch.tensor(env.model.jnt_range[:, 0], device=q.device,
                      dtype=q.dtype)
    hi = torch.tensor(env.model.jnt_range[:, 1], device=q.device,
                      dtype=q.dtype)
    rec["share_of_steps_past_a_limit"] = (
        ((q < lo) | (q > hi)).any(-1).float().mean().item())
    rec["card_vs_cpu"] = reacher_card_vs_cpu()
    emit(rec)
    return rec["kernel_launches"]


def phase_rollout_inverted_pendulum():
    horizon = 100
    batch, rec = general_rollout("rollout_inverted_pendulum",
                                 InvertedPendulumEnv(), (64, 64), horizon, 2)
    mask = batch["mask"]
    if not bool((mask[:, :-1] >= mask[:, 1:]).all()) \
            or not bool(((mask == 0) | (mask == 1)).all()):
        raise AssertionError("mask is not a prefix of ones")
    lengths = mask.sum(1)
    n_term = int(batch["terminated"].sum())
    if n_term == 0 or not bool((lengths < horizon).any()):
        raise AssertionError("no pendulum episode ended early")
    if not bool((batch["terminated"] == (lengths < horizon)).all()):
        raise AssertionError("terminated disagrees with the mask")
    if float((batch["rewards"] * (1 - mask)).abs().sum()) != 0.0:
        raise AssertionError("rewards after the end of an episode")
    rec.update(valid_steps=int(mask.sum()), terminated=n_term,
               mean_episode_length=lengths.mean().item())
    emit(rec)
    return rec["kernel_launches"]


def phase_train_job_point_mass_npg():
    torch.cuda.reset_peak_memory_stats()
    agent, counts, seconds, vf_steps = phase_train_job(
        "point_mass_npg.json", None, 0, "train_job_point_mass_npg", [])
    log = agent.logger.log
    if type(agent).__name__ != "NPG" or agent.fenv.horizon != 25 \
            or log["num_samples"] != [40 * 25] * NITER:
        raise AssertionError(f"point_mass_npg.json did not build its NPG: "
                             f"num_samples {log['num_samples']}")
    for k in ("success_rate", "eval_success"):
        if k not in log:
            raise AssertionError(f"{k} not logged")
    kl_cap = agent.kl_guard * agent.n_step_size / 2
    if not all(kl <= kl_cap * (1 + 1e-6) for kl in log["kl_dist"]):
        raise AssertionError(f"kl_dist {log['kl_dist']} above {kl_cap}")
    emit({"phase": "train_job_point_mass_npg",
          "config": "point_mass_npg.json", "iterations": NITER,
          "seconds": seconds, "kernel_launches": counts,
          "num_samples": log["num_samples"],
          "time_sampling": log["time_sampling"], "time_npg": log["time_npg"],
          "time_VF": log["time_VF"], "vf_adam_steps": vf_steps,
          "kl_dist": log["kl_dist"], "success_rate": log["success_rate"],
          "eval_success": log["eval_success"],
          "stoc_pol_mean": log["stoc_pol_mean"],
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated()})
    return counts


# ---------------------------------------------------------------------------
# M10: DAPG, MPC and the model-based branch (general engine and K1)
# ---------------------------------------------------------------------------

M10_CONFIGS = os.path.join(HERE, "mjrl_tpu_torch", "algos", "model_accel",
                           "run_experiments", "configs")
# float64, card against CPU: a stacked fit (11 Adam steps) and one MPPI
# plan differ by summation order only (1e-9, relative to the largest
# weight); one DAPG update amplifies that through ten CG iterations (1e-8,
# as tests/test_torch_dapg.py holds it to the JAX package)
M10_CARD_TOL = 1e-9
M10_DAPG_TOL = 1e-8


def adam_step_probe(ens, n, mb):
    """A stacked fit of ``ens``'s width on n random samples, one epoch:
    -> (ms per Adam step, device launches per step, busy share)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    d, m = ens.members[0].state_dim, ens.members[0].act_dim
    s = torch.randn((n, d), generator=g, device="cuda")
    a = torch.randn((n, m), generator=g, device="cuda")
    sp = s + 0.1 * torch.randn((n, d), generator=g, device="cuda")
    steps = n // mb
    ens.fit_dynamics(s, a, sp, mb, 1)                  # warms up
    torch.cuda.synchronize()
    t0 = time.time()
    ens.fit_dynamics(s, a, sp, mb, 1)
    torch.cuda.synchronize()
    ms = (time.time() - t0) * 1e3 / steps
    per_step, busy, _ = profiled_window(
        lambda: ens.fit_dynamics(s, a, sp, mb, 1), steps)
    return ms, per_step, busy


def phase_train_model_accel(name, num_iter, eval_rollouts):
    """A shipped model_accel config through its runner, full width, with
    ``num_iter`` outer iterations and ``eval_rollouts`` evaluation
    episodes -> launches."""
    from mjrl_tpu_torch.algos.model_accel.nn_dynamics import \
        WorldModelEnsemble
    from mjrl_tpu_torch.algos.model_accel.run_experiments import \
        run_model_accel_npg
    phase = f"train_model_accel_{name}"
    with open(os.path.join(M10_CONFIGS, f"{name}.json")) as f:
        job = json.load(f)
    job.update(num_iter=num_iter, eval_rollouts=eval_rollouts)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, phase)
        with contextlib.redirect_stdout(sys.stderr):
            (agent, logger), counts, seconds = run_counted(
                lambda: run_model_accel_npg.run(out, job))
        for f in ("job_data.json", os.path.join("logs", "log.csv"),
                  os.path.join("iterations", "agent_final.pickle"),
                  os.path.join("iterations", "best_policy.pickle")):
            if not os.path.exists(os.path.join(out, f)):
                raise AssertionError(f"{phase}: the runner did not write {f}")
    peak = torch.cuda.max_memory_allocated()
    if counts != NO_LAUNCHES:
        raise AssertionError(f"{phase}: launched {counts}")
    M, T = job["num_models"], job["horizon"]
    log, alog = logger.log, agent.logger.log
    # every member's losses, beside the runner's other keys (the keys
    # themselves are held to the JAX runner's by the CPU tests)
    if not {f"{k}_{i}" for k in ("dyn_loss", "dyn_loss_gen")
            for i in range(M)} | {"num_samples", "eval_score"} <= set(log):
        raise AssertionError(f"{phase}: log keys {sorted(log)}")
    for lg, n in ((log, num_iter), (alog, num_iter * job["inner_steps"])):
        for k, v in lg.items():
            if len(v) != n or not np.all(np.isfinite(v)):
                raise AssertionError(f"{phase}: {k} missing or not finite: "
                                     f"{v}")
    horizon = agent.fenv.horizon
    want = [job["init_samples"]] + [job["iter_samples"]] * (num_iter - 1)
    if log["num_samples"] != want:
        raise AssertionError(f"{phase}: num_samples {log['num_samples']}, "
                             f"expected {want}")
    if alog["num_samples"] != [job["update_paths"] * M * T] \
            * (num_iter * job["inner_steps"]):
        raise AssertionError(f"{phase}: imagined samples "
                             f"{alog['num_samples']}")
    ens = agent.learned_model[0]._ens
    if agent.device.type != "cuda" or ens.device.type != "cuda" \
            or ens._dyn["params"]["layers.0.weight"].shape \
            != (M, job["hidden_size"][0], agent.fenv.observation_dim
                + agent.fenv.action_dim):
        raise AssertionError(f"{phase}: the ensemble is not stacked on the "
                             "card at its width")
    # each fit takes every buffered path's transitions (length - 1 each)
    rows = np.cumsum([w - w // horizon for w in want])
    fit_steps = [int(job["fit_epochs"] * (r // job["fit_mb_size"]))
                 for r in rows]
    fresh = WorldModelEnsemble(M, agent.fenv.observation_dim,
                               agent.fenv.action_dim,
                               hidden_size=tuple(job["hidden_size"]))
    n = int(rows[-1])
    ms, launches, busy = adam_step_probe(fresh, n, job["fit_mb_size"])
    emit({"phase": phase, "config": f"{name}.json", "num_iter": num_iter,
          "eval_rollouts": eval_rollouts, "seconds": seconds,
          "kernel_launches": counts, "num_models": M,
          "hidden_size": job["hidden_size"],
          "policy_size": job["policy_size"],
          "num_samples": log["num_samples"],
          "imagined_samples_per_update": alog["num_samples"][0],
          "data_collect_time": log["data_collect_time"],
          "model_update_time": log["model_update_time"],
          "model_adam_steps": fit_steps,
          "policy_update_time": log["policy_update_time"],
          "eval_log_time": log["eval_log_time"],
          "iter_time": log["iter_time"],
          "dyn_loss": [log[f"dyn_loss_{i}"] for i in range(M)],
          "eval_score": log["eval_score"],
          "rollout_score": log["rollout_score"],
          "kl_dist": alog["kl_dist"],
          "adam_step_ms_4_member_fit": ms,
          "adam_step_probe_samples": n,
          "device_launches_per_adam_step": launches,
          "adam_step_device_busy_share": busy,
          "peak_device_memory_bytes": peak})
    return counts


def phase_dapg_point_mass():
    example = example_module("torch_dapg_point_mass")
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--niter", str(NITER), "--finetune_niter", str(NITER),
                "--eval_episodes", "2", "--job", tmp]
        with contextlib.redirect_stdout(sys.stderr):
            out, counts, seconds = run_counted(lambda: example.main(argv))
    if counts != NO_LAUNCHES:
        raise AssertionError(f"dapg_point_mass: launched {counts}")
    dapg, expert = out["dapg"], out["expert"]
    for agent in (dapg, expert):
        check_log({k: v for k, v in agent.logger.log.items()
                   if k != "eval_success"}, "dapg_point_mass")
        if agent.device.type != "cuda":
            raise AssertionError("dapg_point_mass: not on the card")
    demos = out["demo_paths"]
    if dapg.iter_count != NITER or len(demos) != 10 \
            or dapg._demo_obs.shape[0] != 10 * 25 \
            or dapg.logger.log["num_samples"] != [40 * 25] * NITER \
            or not np.isfinite([out["demo_return"], out["bc_score"],
                                out["final_score"]]).all():
        raise AssertionError("dapg_point_mass: wrong counts or scores")
    emit({"phase": "dapg_point_mass", "seconds": seconds,
          "kernel_launches": counts, "expert_niter": NITER,
          "finetune_niter": NITER, "num_traj": 40, "num_demos": len(demos),
          "eval_episodes": 2, "iter_count": dapg.iter_count,
          "demo_return": out["demo_return"], "bc_score": out["bc_score"],
          "final_score": out["final_score"],
          "expert_time_sampling": expert.logger.log["time_sampling"],
          "dapg_time_sampling": dapg.logger.log["time_sampling"],
          "dapg_time_npg": dapg.logger.log["time_npg"],
          "dapg_kl_dist": dapg.logger.log["kl_dist"],
          "dapg_stoc_pol_mean": dapg.logger.log["stoc_pol_mean"],
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated()})
    return counts


def time_actions(get_action, arg, n=3):
    """Seconds per call of an MPC policy's ``get_action`` (after one)."""
    get_action(arg)
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(n):
        get_action(arg)
    torch.cuda.synchronize()
    return (time.time() - t0) / n


def phase_mbac_point_mass():
    from mjrl_tpu_torch.algos import MBAC
    e = GymEnv("mjrl_point_mass-v0")
    policy = MLP(e.spec, hidden_sizes=(32, 32), seed=1)
    torch.cuda.reset_peak_memory_stats()
    agent = MBAC("mjrl_point_mass-v0", policy, seed=123)
    actor = agent.mpc_policy
    if (actor.H, actor.num_candidates, actor.kappa) != (10, 25, 10.0) \
            or list(actor.filter_coefs[1:]) != [0.05, 0.0, 0.0]:
        raise AssertionError("mbac_point_mass: not MBAC's default MPC")
    perf, counts, seconds = run_counted(lambda: agent.train_step(num_traj=1))
    if counts != NO_LAUNCHES:
        raise AssertionError(f"mbac_point_mass: launched {counts}")
    path = agent.expert_paths[0]
    if len(agent.expert_paths) != 1 or path["observations"].shape != (25, 6) \
            or path["expert_actions"].shape != (25, 2) \
            or not np.isfinite(path["expert_actions"]).all() \
            or not np.isfinite(perf) \
            or not np.isfinite(agent.logger.log["loss_after"][-1]):
        raise AssertionError("mbac_point_mass: wrong path or loss")
    per_action = time_actions(actor.get_action, path["states"][-1], 2)
    emit({"phase": "mbac_point_mass", "seconds": seconds,
          "kernel_launches": counts, "H": actor.H,
          "candidates": actor.num_candidates, "path_steps": 25,
          "seconds_per_mpc_actor_action": per_action,
          "stoc_pol_perf": float(perf),
          "bc_loss_before": agent.logger.log["loss_before"][-1],
          "bc_loss_after": agent.logger.log["loss_after"][-1],
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated()})
    return counts


def phase_mpc_actor_swimmer(kernel):
    """MBAC's default planner (H 10, 25 candidates) shooting in the
    Swimmer: every horizon step is one launch of K1 for all candidates.
    Each launch's inputs and outputs on this path are kept, and K1 is held
    against the plain step on them: its float32 outputs at K1's float32
    tolerances, and the same inputs in float64 (comparison launches, after
    the counted run) at its float64 ones.  The worst float32 error joins
    ``kernel``'s ``max_abs_err``."""
    from mjrl_tpu_torch.envs import base as env_base
    from mjrl_tpu_torch.models.mpc_actor import MPCActor
    e = GymEnv("mjrl_swimmer-v0")
    e.reset(seed=0)
    actor = MPCActor(e, H=10, paths_per_cpu=25, kappa=10.0, gamma=1.0,
                     filter_coefs=[np.ones(e.action_dim), 0.05, 0.0, 0.0])
    launched = env_base.cuda_step_n_batched
    calls = []

    def kept(p, q, v, u, n, lanes=None):
        gq, gv = launched(p, q, v, u, n, lanes=lanes)
        calls.append((p, n, lanes, q.clone(), v.clone(), u.clone(),
                      gq.clone(), gv.clone()))
        return gq, gv

    counts, seconds = {SMOOTH: 0, CONTACT: 0}, []
    env_base.cuda_step_n_batched = kept
    try:
        for _ in range(3):
            a, c, s = run_counted(
                lambda: actor.get_action(e.get_env_state()))
            counts = {k: counts[k] + c[k] for k in counts}
            seconds.append(s)
            if a.shape != (e.action_dim,) or not np.isfinite(a).all():
                raise AssertionError(f"mpc_actor_swimmer: action {a}")
            # the real env's own step is no part of the planner's path
            env_base.cuda_step_n_batched = launched
            e.step(a)
            env_base.cuda_step_n_batched = kept
    finally:
        env_base.cuda_step_n_batched = launched
    want = {SMOOTH: 3 * actor.H, CONTACT: 0}
    if counts != want or len(calls) != 3 * actor.H:
        raise AssertionError(f"mpc_actor_swimmer: launched {counts}, "
                             f"expected {want}")
    errs = {"float32": 0.0, "float64": 0.0}
    for p, n, lanes, q, v, u, gq, gv in calls:
        if q.shape[0] != actor.num_candidates or q.dtype != torch.float32:
            raise AssertionError(f"mpc_actor_swimmer: K1 given "
                                 f"{tuple(q.shape)} {q.dtype}")
        for dtype, (tol_q, tol_v) in ((torch.float32, (2e-5, 2e-4)),
                                      (torch.float64, (1e-9, 1e-9))):
            tq, tv, tu = (x.to(dtype) for x in (q, v, u))
            if dtype == torch.float32:
                kq, kv = gq, gv
            else:
                kq, kv = cuda_planar.cuda_step_n_batched(
                    p, tq, tv, tu, n, lanes=lanes)
            rq, rv = step_n_arrays(p, tq, tv, tu, n)
            torch.testing.assert_close(kq, rq, rtol=tol_q, atol=tol_q)
            torch.testing.assert_close(kv, rv, rtol=tol_v, atol=tol_v)
            key = str(dtype).split(".")[-1]
            errs[key] = max(errs[key], (kq - rq).abs().max().item(),
                            (kv - rv).abs().max().item())
    kernel["max_abs_err"] = max(kernel["max_abs_err"], errs["float32"])
    kernel["checks"].append({"path": "mpc_actor_swimmer",
                             "B": actor.num_candidates,
                             "launches_checked": len(calls),
                             "max_abs_err": errs,
                             "rtol_atol_q": {"float32": 2e-5,
                                             "float64": 1e-9},
                             "rtol_atol_v": {"float32": 2e-4,
                                             "float64": 1e-9}})
    emit({"phase": "mpc_actor_swimmer", "actions": 3, "H": actor.H,
          "candidates": actor.num_candidates, "kernel_launches": counts,
          "k1_launches_checked": len(calls), "k1_max_abs_err": errs,
          "seconds_per_mpc_actor_action": seconds,
          "seconds": sum(seconds)})
    return counts


def phase_learned_mpc_point_mass():
    from mjrl_tpu_torch.algos.model_accel.run_experiments import \
        run_model_learning_mpc
    job = dict(env_name="mjrl_point_mass-v0", num_models=4, num_iter=2,
               samples_per_iter=2)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(sys.stderr):
            (model, mpc, logger), counts, seconds = run_counted(
                lambda: run_model_learning_mpc.run(tmp, job))
    if counts != NO_LAUNCHES:
        raise AssertionError(f"learned_mpc_point_mass: launched {counts}")
    log = logger.log
    if sorted(log) != ["dyn_loss", "iteration", "rollout_score"] \
            or log["iteration"] != [0, 1] \
            or not np.all(np.isfinite(log["dyn_loss"]
                                      + log["rollout_score"])) \
            or len(mpc.fitted_model) != 4 \
            or model._dyn["params"]["layers.0.weight"].shape != (4, 256, 8):
        raise AssertionError(f"learned_mpc_point_mass: {log}")
    obs = np.array([0.3, -0.2, 0.0, 0.1, -0.5, 0.6])
    per_action = time_actions(mpc.get_action, obs)
    per_action_launches, busy, _ = profiled_window(
        lambda: mpc.get_action(obs), 1)
    # the second fit's data: 10 warm-up paths and 2 MPC paths, 24 rows each
    ms, launches, fit_busy = adam_step_probe(model, 12 * 24, 64)
    emit({"phase": "learned_mpc_point_mass", "seconds": seconds,
          "kernel_launches": counts, "num_models": 4, "num_iter": 2,
          "samples_per_iter": 2, "plan_horizon": mpc.plan_horizon,
          "plan_paths": mpc.num_traj, "dyn_loss": log["dyn_loss"],
          "rollout_score": log["rollout_score"],
          "seconds_per_mpc_policy_action": per_action,
          "device_launches_per_mpc_policy_action": per_action_launches,
          "mpc_policy_device_busy_share": busy,
          "adam_step_ms_4_member_fit": ms,
          "device_launches_per_adam_step": launches,
          "adam_step_device_busy_share": fit_busy,
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated()})
    return counts


def m10_card_vs_cpu():
    """float64, the same inputs on the card and on the CPU: a 4-member
    stacked fit at 256-256 (injected permutations, 11 Adam steps), one
    MPCPolicy plan (injected candidates) and one DAPG update -> max abs
    error by quantity."""
    from mjrl_tpu_torch.algos import DAPG, MPCPolicy, WorldModelEnsemble
    from mjrl_tpu_torch.baselines import LinearBaseline as LB
    rng = np.random.RandomState(23)
    n, D, A, M = 704, 6, 2, 4
    s = rng.normal(size=(n, D))
    a = rng.normal(size=(n, A))
    sp = s + 0.1 * np.tanh(s @ rng.normal(size=(D, D))) \
        + 0.05 * a @ rng.normal(size=(A, D))
    perms = np.stack([np.stack([rng.permutation(n)]) for _ in range(M)])
    eps = rng.normal(size=(32, 10, A))
    obs0 = rng.normal(size=D)
    pol_np = convert.params_to_numpy(MLP(
        PointMassEnv(device="cpu").spec, hidden_sizes=(32, 32), seed=2,
        dtype=torch.float64, device="cpu").params)
    errs, out = {}, {}
    for dev in ("cuda", "cpu"):
        ens = WorldModelEnsemble(M, D, A, seed=5, hidden_size=(256, 256),
                                 device="cpu", dtype=torch.float64)
        if dev == "cuda":
            card = WorldModelEnsemble(M, D, A, seed=5,
                                      hidden_size=(256, 256), device=dev,
                                      dtype=torch.float64)
            for src, dst in zip(ens, card):
                convert.world_model_from_numpy(
                    dst, **convert.world_model_to_numpy(src))
            ens = card
        losses = ens.fit_dynamics(s, a, sp, 64, 1, perms=perms)
        weights = {k: v.cpu() for k, v in ens._dyn["params"].items()}
        env = GymEnv("mjrl_point_mass-v0", device=dev,
                     env_kwargs={"dtype": torch.float64})
        mpc = MPCPolicy(env, plan_horizon=10, plan_paths=32, kappa=5.0,
                        gamma=0.99, fitted_model=ens, omega=5.0)
        action = mpc.get_action(obs0, eps=eps)
        # the CPU policy's weights on both devices (a CUDA generator draws
        # other numbers than a CPU one)
        pol = convert.policy_params_from_numpy(
            MLP(env.spec, hidden_sizes=(32, 32), dtype=torch.float64,
                device=dev), pol_np)
        dg = np.random.RandomState(29)
        demos = [dict(observations=dg.normal(size=(25, D)),
                      actions=dg.normal(size=(25, A))) for _ in range(3)]
        dapg = DAPG(env, pol, LB(env.spec, dtype=torch.float64, device=dev),
                    demo_paths=demos, normalized_step_size=0.05, seed=1,
                    device=dev)
        bg = np.random.RandomState(31)
        batch = {k: torch.tensor(v, device=dev) for k, v in dict(
            observations=bg.normal(size=(40, 25, D)),
            actions=bg.normal(size=(40, 25, A)),
            rewards=bg.normal(size=(40, 25)), mask=np.ones((40, 25)),
            terminated=np.zeros(40, bool)).items()}
        batch["env_infos"] = {}
        _, process_fn, update_fn, _ = dapg._get_phases(40, 25, 0.95, 0.97)
        dapg._train_from_batch(batch, process_fn, update_fn)
        out[dev] = dict(losses=torch.tensor(losses), weights=weights,
                        action=torch.tensor(action),
                        dapg=convert.params_to_numpy(pol.params))
    for k in ("losses", "action"):
        torch.testing.assert_close(out["cuda"][k], out["cpu"][k],
                                   rtol=M10_CARD_TOL, atol=M10_CARD_TOL)
        errs[k] = (out["cuda"][k] - out["cpu"][k]).abs().max().item()
    errs["fit_weights"] = max(
        (out["cuda"]["weights"][k] - v).abs().max().item()
        for k, v in out["cpu"]["weights"].items())
    flat = lambda p: np.concatenate([np.ravel(l[x]) for l in p["layers"]
                                     for x in ("w", "b")]
                                    + [p["log_std"]])
    errs["dapg_params"] = float(np.abs(flat(out["cuda"]["dapg"])
                                       - flat(out["cpu"]["dapg"])).max())
    scale = lambda x: max(1.0, x)
    if errs["fit_weights"] > M10_CARD_TOL * scale(max(
            v.abs().max().item() for v in out["cpu"]["weights"].values())) \
            or errs["dapg_params"] > M10_DAPG_TOL * scale(np.abs(flat(
                out["cpu"]["dapg"])).max()):
        raise AssertionError(f"M10 card vs CPU: {errs}")
    emit({"phase": "m10_card_vs_cpu", "dtype": "float64",
          "tol": M10_CARD_TOL, "dapg_tol": M10_DAPG_TOL,
          "fit_adam_steps": n // 64,
          "num_models": M, "hidden_size": [256, 256], "max_abs_err": errs})


# ---------------------------------------------------------------------------
# M9a: the contact half of the general engine (no planar kernel)
# ---------------------------------------------------------------------------

# one NPG iteration of Ant-v3 at 4096 environments is held to this many
# seconds by cutting its horizon: the rollout gets this share of it, from
# a 2-step rollout's seconds per step (a training rollout's steps took up to
# 1.34 x as long, and the baseline fit ~0.2 s per step of horizon, on an
# H100 at 700 W); cut from 40 s to keep the whole script near 600 s
ANT_ITER_S = 30.0
ANT_ROLLOUT_SHARE = 0.55
M9A_NITER = 2
PEG_NITER = 1              # cut from 2 to keep the whole script near 600 s
M9A_CARD_TOL = 1e-9


def check_model_m9a(env, topk, frozen):
    m = env.model
    if m.solver != 1 or m.contact_topk != topk \
            or m.row_freeze_step != frozen or env._planar is not None:
        raise AssertionError(
            f"{type(env).__name__}: solver {m.solver}, contact_topk "
            f"{m.contact_topk}, row_freeze_step {m.row_freeze_step}")


def phase_rollout_peg():
    env = PegEnv()
    check_model_m9a(env, 64, True)
    batch, rec = general_rollout("rollout_peg", env, (64, 64), env.horizon,
                                 2)
    # the scenery moved the hole: the target's y spans the reset range
    ty = batch["observations"][:, 0, -2]
    if not (0.1 <= float(ty.min()) and float(ty.max()) <= 0.5
            and float(ty.max() - ty.min()) > 0.2):
        raise AssertionError(f"peg targets y in [{float(ty.min())}, "
                             f"{float(ty.max())}]")
    rec.update(mean_return=batch["rewards"].sum(1).mean().item(),
               contact_slots=len(contact_pair_condims(env.model)),
               contact_topk=env.model.contact_topk)
    emit(rec)
    return rec["kernel_launches"]


def phase_rollout_humanoid():
    env = HumanoidEnv()
    check_model_m9a(env, 64, False)
    batch, rec = general_rollout("rollout_humanoid", env, (64, 64), 10, 2)
    rec.update(horizon_cut_from=env.horizon,
               mean_return=(batch["rewards"] * batch["mask"]).sum(1)
               .mean().item(),
               contact_slots=len(contact_pair_condims(env.model)))
    emit(rec)
    return rec["kernel_launches"]


def ant_horizon():
    """The largest Ant-v3 horizon whose rollout at NUM_ENVS keeps within
    ANT_ROLLOUT_SHARE of ANT_ITER_S, from a measured 2-step rollout ->
    (horizon, seconds per control step, device launches per step)."""
    env = AntEnv()
    policy = MLP(env.spec, hidden_sizes=(64, 64), init_log_std=-0.5,
                 seed=0)
    gen = make_generator(3, env.device)
    roll = lambda T: rollout_batch(env, policy.config, policy.params,
                                   policy.transforms, gen, NUM_ENVS,
                                   horizon=T)
    roll(1)                                         # warms up
    _, counts, seconds = run_counted(lambda: roll(2))
    if counts != NO_LAUNCHES:
        raise AssertionError(f"Ant rollout launched {counts}")
    per_step = seconds / 2
    horizon = max(1, min(env.horizon,
                         int(ANT_ITER_S * ANT_ROLLOUT_SHARE / per_step)))
    launches, _, _ = profiled_window(lambda: roll(1), 1)
    return horizon, per_step, launches


def train_npg_general(env_id, horizon, phase, topk, frozen, extra,
                      niter=M9A_NITER):
    """NPG on ``env_id`` through GymEnv -> MLP -> MLPBaseline -> NPG ->
    train_agent, with tools/train_gym.py's hyperparameters (64-64,
    init_log_std -0.5, step 0.05, gamma 0.995, GAE 0.97), ``niter``
    iterations of NUM_ENVS x ``horizon``; no planar kernel launched."""
    e = GymEnv(env_id, horizon=horizon)
    e.env.horizon = horizon              # the rollout reads the env's own
    check_model_m9a(e.env, topk, frozen)
    policy = MLP(e.spec, hidden_sizes=(64, 64), init_log_std=-0.5, seed=0)
    baseline = MLPBaseline(e.spec, reg_coef=1e-3, batch_size=64, epochs=2,
                           learn_rate=1e-3)
    agent = NPG(e, policy, baseline, normalized_step_size=0.05, seed=0,
                save_logs=True)
    assert agent.device.type == "cuda" and policy.device.type == "cuda"
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, phase)
        with contextlib.redirect_stdout(sys.stderr):
            _, counts, seconds = run_counted(lambda: train_agent(
                job, agent, seed=0, niter=niter, num_traj=NUM_ENVS,
                gamma=0.995, gae_lambda=0.97, save_freq=10))
    if counts != NO_LAUNCHES:
        raise AssertionError(f"{phase}: launched {counts}")
    log = agent.logger.log
    for k, vals in log.items():
        if len(vals) != niter or not np.all(np.isfinite(vals)):
            raise AssertionError(f"{phase}: logged {k} not finite: {vals}")
    if not np.all(np.isfinite(policy.get_param_values())):
        raise AssertionError(f"{phase}: policy parameters not finite")
    kl_cap = agent.kl_guard * agent.n_step_size / 2
    if not all(kl <= kl_cap * (1 + 1e-6) for kl in log["kl_dist"]):
        raise AssertionError(f"kl_dist {log['kl_dist']} above {kl_cap}")
    fenv = e.env
    gen = make_generator(9, fenv.device)
    launches, busy, window_ms = profiled_window(
        lambda: rollout_batch(fenv, policy.config, policy.params,
                              policy.transforms, gen, NUM_ENVS, horizon=1),
        1)
    iteration_s = [a + b + c for a, b, c in zip(
        log["time_sampling"], log["time_npg"], log["time_VF"])]
    emit({"phase": phase, "env": env_id, "iterations": niter,
          "num_traj": NUM_ENVS, "horizon": horizon, **extra,
          "seconds": seconds, "iteration_seconds": iteration_s,
          "kernel_launches": counts, "num_samples": log["num_samples"],
          "time_sampling": log["time_sampling"],
          "time_npg": log["time_npg"], "time_VF": log["time_VF"],
          "ms_per_control_step": [t / horizon * 1e3
                                  for t in log["time_sampling"]],
          "kl_dist": log["kl_dist"], "stoc_pol_mean": log["stoc_pol_mean"],
          "device_launches_per_step": launches, "window_ms": window_ms,
          "device_busy_share": busy,
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated()})
    return counts


def phase_train_peg_npg():
    return train_npg_general("mjrl_peg_insertion-v0", PegEnv.horizon,
                             "train_peg_npg", 64, True,
                             {"iterations_cut_from": M9A_NITER},
                             niter=PEG_NITER)


def phase_train_ant_npg():
    horizon, per_step, launches = ant_horizon()
    return train_npg_general(
        "Ant-v3", horizon, "train_ant_npg", 0, False,
        {"horizon_cut_from": AntEnv.horizon,
         "horizon_cut_basis": {"iteration_budget_s": ANT_ITER_S,
                               "rollout_share": ANT_ROLLOUT_SHARE,
                               "measured_s_per_control_step": per_step,
                               "device_launches_per_step": launches}})


def _slot_ids(env, state):
    """slot_ids of the constraint rows at ``state`` (B, C)."""
    q, v = state.physics.qpos, state.physics.qvel
    data = body_frames(env.model, q, env._body_pos(state.scenery))
    cdof = dynamics.compute_cdof(env.model, data)
    return solver.constraint_rows(env.model, data, cdof, q, v)[7]


def phase_contact_card_vs_cpu():
    """Float64, B 8: 2 control steps of peg (frozen rows, top-k cap) and
    Ant (rows at every RK4 stage) from the contact golden states, on the
    card and on the CPU: obs, state and reward within M9A_CARD_TOL, equal
    slot_ids before every step."""
    B, T = 8, 2
    rec = {"phase": "contact_card_vs_cpu", "B": B, "control_steps": T,
           "dtype": "float64", "rtol_atol": M9A_CARD_TOL}
    t_start = time.time()
    for name, cls, golden in (("peg", PegEnv, "contact_peg_insertion"),
                              ("ant", AntEnv, "contact_ant")):
        g = np.load(os.path.join(HERE, "tests", "golden", golden + ".npz"))
        rng = np.random.RandomState(5)
        q, v = g["qpos"][:B], g["qvel"][:B]
        scenery = ({"goal_y": rng.uniform(0.1, 0.5, B)} if cls is PegEnv
                   else {})
        runs = {}
        for dev in ("cuda", "cpu"):
            env = cls(dtype=torch.float64, device=dev)
            acts = np.random.RandomState(6).uniform(-1, 1,
                                                    (T, B, env.action_dim))

            def run():
                s = env.state_from_qpos_qvel(q, v, scenery)
                ids, states = [], []
                for t in range(T):
                    ids.append(_slot_ids(env, s))
                    s = env.step(s, torch.tensor(acts[t], device=dev))
                    states.append(s)
                return ids, states
            runs[dev], counts, _ = run_counted(run)
            if counts != NO_LAUNCHES:
                raise AssertionError(f"{name} card vs CPU launched {counts}")
            if dev == "cuda":
                launches, busy, _ = profiled_window(
                    lambda: env.step(env.state_from_qpos_qvel(q, v, scenery),
                                     torch.tensor(acts[0], device=dev)), 1)
        errs = {}
        for t in range(T):
            (gi, gs), (ci, cs) = ((runs[d][0][t], runs[d][1][t])
                                  for d in ("cuda", "cpu"))
            if not torch.equal(gi.cpu(), ci):
                raise AssertionError(f"{name}: slot_ids differ at step {t}")
            for k, a, b in (("obs", gs.obs, cs.obs),
                            ("qpos", gs.physics.qpos, cs.physics.qpos),
                            ("qvel", gs.physics.qvel, cs.physics.qvel),
                            ("reward", gs.reward, cs.reward)):
                torch.testing.assert_close(
                    a.cpu(), b, rtol=M9A_CARD_TOL, atol=M9A_CARD_TOL,
                    msg=lambda m: f"{name} {k} step {t}: {m}")
                errs[k] = max(errs.get(k, 0.0),
                              (a.cpu() - b).abs().max().item())
        n_con = int((runs["cpu"][0][0] >= 0).sum())
        rec[name] = {"max_abs_err": errs, "contact_rows": n_con,
                     "device_launches_per_step": launches,
                     "device_busy_share": busy}
    rec["seconds"] = time.time() - t_start
    emit(rec)
    return NO_LAUNCHES


# ---- M9b: the rest of the general engine and the Adroit hand -----------------

M9B_TOL = 1e-9
RELOCATE_HORIZON = 20      # rollout_relocate's cut of the 200-step horizon
DAPG_HORIZON = 25          # dapg_relocate's cut

M9B_CONDIM = """<mujoco><option timestep="0.002" {opt}/><worldbody>
<geom type="plane" size="1 1 0.1" friction="1 0.01 0.0001"/>
<body pos="0 0 0.034"><joint type="slide" axis="1 0 0"/>
<joint type="slide" axis="0 1 0"/><joint type="slide" axis="0 0 1"/>
<joint type="hinge" axis="1 0 0"/><joint type="hinge" axis="0 1 0"/>
<joint type="hinge" axis="0 0 1"/><geom type="sphere" size="0.035"
condim="{condim}" friction="1 0.005 0.0001"/></body></worldbody></mujoco>"""
M9B_EQUALITY = """<mujoco><worldbody>
<body name="A" pos="0 0 1"><joint name="ja" type="hinge" axis="0 1 0"
damping="0.2"/><geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.04"
contype="0" conaffinity="0"/><body name="B" pos="0.4 0 0"><joint name="jb"
type="hinge" axis="0 1 0" damping="0.1"/><geom type="capsule"
fromto="0 0 0 0.3 0 0" size="0.03" contype="0" conaffinity="0"/></body>
</body><body name="C" pos="0.7 0 1"><joint name="jc" type="hinge"
axis="0 1 0" damping="0.1"/><geom type="capsule" fromto="0 0 0 0.2 0 0"
size="0.03" contype="0" conaffinity="0"/></body>
<body name="D" pos="0 1 1"><joint type="free"/><geom type="box"
size="0.1 0.08 0.06" contype="0" conaffinity="0"/></body>
<body name="E" pos="0.5 1 1" euler="0 0 0.3"><joint type="free"/>
<geom type="box" size="0.1 0.08 0.06" contype="0" conaffinity="0"/></body>
</worldbody><equality><joint joint1="ja" joint2="jb"
polycoef="0.1 0.5 0.2 0 0"/><connect body1="B" body2="C" anchor="0.3 0 0"/>
<weld body1="D" body2="E" anchor="0.2 0 0" torquescale="0.7"/></equality>
<actuator><motor joint="ja"/><motor joint="jc"/></actuator></mujoco>"""
M9B_ACTUATORS = """<mujoco><worldbody>
<body pos="0 0 1"><joint name="sh" type="hinge" axis="0 1 0" damping="0.3"/>
<geom type="capsule" fromto="0 0 0 0.4 0 0" size="0.04" contype="0"
conaffinity="0"/><body pos="0.4 0 0"><joint name="j1" type="hinge"
axis="0 1 0" damping="0.1"/><geom type="capsule" fromto="0 0 0 0.3 0 0"
size="0.03" contype="0" conaffinity="0"/></body></body>
<body pos="1 0 1"><joint name="b" type="ball" damping="0.2" stiffness="5"/>
<geom type="capsule" fromto="0 0 0 0 0 -0.3" size="0.04" contype="0"
conaffinity="0"/></body></worldbody>
<tendon><fixed name="t" range="-0.4 0.4"><joint joint="sh" coef="1"/>
<joint joint="j1" coef="-0.5"/></fixed></tendon>
<actuator><position joint="sh" kp="50" kv="3" gear="2"/>
<motor joint="b" gear="1 0.5 0.25" ctrlrange="-2 2" ctrllimited="true"/>
<motor tendon="t" gear="3"/></actuator></mujoco>"""


def _m9b_scenes():
    """name -> (float64 model, substeps per control step, initial (qpos,
    qvel, ctrl) of B 8)."""
    B = 8
    rng = np.random.RandomState(29)

    def condim(cd, opt="", **kw):
        q = np.zeros((B, 6))
        q[:, 2] = rng.uniform(-0.002, 0.0005, B)
        v = rng.normal(0, 1, (B, 6))
        v[:, 5] = rng.uniform(-8, 8, B)
        m = load_mjcf(xml_string=M9B_CONDIM.format(condim=cd, opt=opt))
        return m.finalize(solver="newton", **kw), 5, (q, v, np.zeros((B, 0)))

    def xml_scene(xml, **kw):
        m = load_mjcf(xml_string=xml).finalize(**kw)
        q = np.tile(m.qpos0, (B, 1)) + rng.uniform(-0.3, 0.3, (B, m.nq))
        for j, jt in enumerate(m.jnt_type):
            if jt in (0, 1):                  # free, ball: unit quaternions
                qa = m.jnt_qposadr[j] + (3 if jt == 0 else 0)
                quat = q[:, qa:qa + 4] + np.array([1.0, 0, 0, 0])
                q[:, qa:qa + 4] = quat / np.linalg.norm(quat, axis=1,
                                                        keepdims=True)
        return m, 5, (q, rng.uniform(-1, 1, (B, m.nv)),
                      rng.uniform(-1.5, 1.5, (B, m.nu)))

    hopper = load_mjcf(os.path.join(HERE, "mjrl_tpu_torch", "envs", "mjcf",
                                    "hopper.xml"))
    hopper.opt["cone"] = ELLIPTIC
    g = np.load(os.path.join(HERE, "tests", "golden", "contact_hopper.npz"))
    idx = np.flatnonzero(g["ncon"] > 0)[:B]
    return {
        "condim4": condim(4),
        "condim6": condim(6),
        "condim4_newton_noslip": condim(4, 'noslip_iterations="10"',
                                        newton_iters=25),
        "hopper_elliptic": (hopper.finalize(solver="newton"), 4,
                            (g["qpos"][idx], g["qvel"][idx],
                             g["ctrl"][idx])),
        "equalities": xml_scene(M9B_EQUALITY, solver="newton"),
        "actuators": xml_scene(M9B_ACTUATORS),
    }


def phase_m9b_card_vs_cpu():
    """Float64, B 8: 2 control steps of each M9b scene on the card and on
    the CPU within M9B_TOL (qvel relative to its largest entry)."""
    rec = {"phase": "m9b_card_vs_cpu", "B": 8, "control_steps": 2,
           "dtype": "float64", "rtol_atol": M9B_TOL}
    t_start = time.time()
    for name, (model, n, (q, v, u)) in _m9b_scenes().items():
        out = {}
        for dev in ("cuda", "cpu"):
            kw = dict(dtype=torch.float64, device=dev)
            s = State(qpos=torch.tensor(q, **kw), qvel=torch.tensor(v, **kw))
            ctrl = torch.tensor(u, **kw)

            def run():
                states = [s]
                for _ in range(2):
                    states.append(step_n(model, states[-1], ctrl, n))
                return states[1:]
            out[dev], counts, _ = run_counted(run)
            if counts != NO_LAUNCHES:
                raise AssertionError(f"m9b {name} launched {counts}")
            if dev == "cuda":
                launches, busy, _ = profiled_window(
                    lambda: step_n(model, s, ctrl, n), 1)
        errs = {}
        for t, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
            for k in ("qpos", "qvel"):
                x, y = getattr(a, k).cpu(), getattr(b, k)
                scale = max(float(y.abs().max()), 1.0) if k == "qvel" else 1.0
                torch.testing.assert_close(
                    x, y, rtol=M9B_TOL, atol=M9B_TOL * scale,
                    msg=lambda m: f"m9b {name} {k} step {t}: {m}")
                if not torch.isfinite(x).all():
                    raise AssertionError(f"m9b {name}: {k} not finite")
                errs[k] = max(errs.get(k, 0.0), (x - y).abs().max().item())
        rec[name] = {"max_abs_err": errs, "substeps": n,
                     "constraint_rows": solver.n_constraint_rows(model)
                     if model.solver else 0,
                     "device_launches_per_step": launches,
                     "device_busy_share": busy}
    rec["seconds"] = time.time() - t_start
    emit(rec)
    return NO_LAUNCHES


def _relocate_scenery(n, seed):
    rng = np.random.RandomState(seed)
    return {"obj_pos": np.c_[rng.uniform(-0.15, 0.15, n),
                             rng.uniform(-0.15, 0.3, n), np.full(n, 0.035)],
            "target_pos": np.c_[rng.uniform(-0.2, 0.2, (n, 2)),
                                rng.uniform(0.15, 0.35, n)]}


def phase_relocate_card_vs_cpu():
    """Float64: the 20 first Adroit grasp states through qacc_smooth on the
    card and on the CPU, and the card against MuJoCo's golden qacc; one
    control step from 8 golden states, card against CPU."""
    g = np.load(os.path.join(HERE, "tests", "golden", "contact_adroit.npz"))
    N, B = 20, 8
    t_start = time.time()
    acc, steps = {}, {}
    sc = _relocate_scenery(B, 30)
    act = np.random.RandomState(31).uniform(-1.2, 1.2, (B, 30))
    for dev in ("cuda", "cpu"):
        env = AdroitRelocateEnv(dtype=torch.float64, device=dev)
        kw = dict(dtype=torch.float64, device=dev)

        def run():
            a = qacc_smooth(env.model, State(
                qpos=torch.tensor(g["qpos"][:N], **kw),
                qvel=torch.tensor(g["qvel"][:N], **kw)),
                torch.tensor(g["ctrl"][:N], **kw))
            s = env.state_from_qpos_qvel(g["qpos"][:B], g["qvel"][:B], sc)
            return a, env.step(s, torch.tensor(act, **kw))
        (acc[dev], steps[dev]), counts, _ = run_counted(run)
        if counts != NO_LAUNCHES:
            raise AssertionError(f"relocate card vs CPU launched {counts}")
        if dev == "cuda":
            s0 = env.state_from_qpos_qvel(g["qpos"][:B], g["qvel"][:B], sc)
            launches, busy, _ = profiled_window(
                lambda: env.step(s0, torch.tensor(act, **kw)), 1)
    a_gpu, a_cpu = acc["cuda"].cpu().numpy(), acc["cpu"].numpy()
    rel = np.abs(a_gpu - a_cpu).max(1) / np.maximum(
        np.abs(a_cpu).max(1), 1.0)
    if not rel.max() < M9B_TOL:
        raise AssertionError(f"relocate qacc card vs CPU {rel.max()}")
    mj = g["qacc"][:N]
    errs = np.abs(a_gpu - mj).max(1) / np.maximum(np.abs(mj).max(1), 1.0)
    if not np.median(errs) < 0.05:
        raise AssertionError(f"relocate qacc vs MuJoCo median "
                             f"{np.median(errs)}")
    step_err = {}
    gs, cs = steps["cuda"], steps["cpu"]
    for k, a, b in (("obs", gs.obs, cs.obs), ("qpos", gs.physics.qpos,
                                             cs.physics.qpos),
                    ("qvel", gs.physics.qvel, cs.physics.qvel),
                    ("reward", gs.reward, cs.reward)):
        scale = max(float(b.abs().max()), 1.0) if k == "qvel" else 1.0
        torch.testing.assert_close(a.cpu(), b, rtol=M9B_TOL,
                                   atol=M9B_TOL * scale,
                                   msg=lambda m: f"relocate {k}: {m}")
        step_err[k] = (a.cpu() - b).abs().max().item()
    emit({"phase": "relocate_card_vs_cpu", "dtype": "float64",
          "qacc_states": N, "qacc_card_vs_cpu_max_rel": float(rel.max()),
          "qacc_vs_mujoco_median_rel": float(np.median(errs)),
          "qacc_vs_mujoco_max_rel": float(errs.max()), "step_B": B,
          "step_max_abs_err": step_err, "rtol_atol": M9B_TOL,
          "device_launches_per_step": launches, "device_busy_share": busy,
          "seconds": time.time() - t_start})
    return NO_LAUNCHES


def check_model_relocate(env):
    m = env.model
    if (m.solver, m.newton_iters, m.noslip_iters, m.nv, m.nu,
            solver.n_constraint_rows(m)) != (1, 25, 20, 36, 30, 709) \
            or env._planar is not None:
        raise AssertionError(f"relocate model: solver {m.solver}, newton "
                             f"{m.newton_iters}, noslip {m.noslip_iters}")


def phase_rollout_relocate():
    env = AdroitRelocateEnv()
    check_model_relocate(env)
    batch, rec = general_rollout("rollout_relocate", env, (64, 64),
                                 RELOCATE_HORIZON, 1)
    rec.update(horizon_cut_from=env.horizon,
               mean_return=batch["rewards"].sum(1).mean().item(),
               constraint_rows=solver.n_constraint_rows(env.model))
    emit(rec)
    return rec["kernel_launches"]


def phase_dapg_relocate():
    """examples/torch_dapg_relocate.py at the example's widths: 2 expert
    demos made on the card, 2 BC epochs, 1 DAPG iteration of 50 paths, all
    at DAPG_HORIZON; no evaluation episodes."""
    example = example_module("torch_dapg_relocate")
    torch.cuda.reset_peak_memory_stats()
    argv = ["--make_demos", "2", "--keep_all_demos", "--horizon",
            str(DAPG_HORIZON), "--bc_epochs", "2", "--dapg_iters", "1",
            "--ntraj", "50", "--eval_episodes", "0"]
    with contextlib.redirect_stdout(sys.stderr):
        out, counts, seconds = run_counted(lambda: example.main(argv))
    if counts != NO_LAUNCHES:
        raise AssertionError(f"dapg_relocate: launched {counts}")
    dapg = out["dapg"]
    check_model_relocate(dapg.env.env)
    log = dapg.logger.log
    for k, vals in log.items():
        if len(vals) != 1 or not np.all(np.isfinite(vals)):
            raise AssertionError(f"dapg_relocate: logged {k} not finite: "
                                 f"{vals}")
    kl_cap = dapg.kl_guard * dapg.n_step_size / 2
    if not log["kl_dist"][0] <= kl_cap * (1 + 1e-6):
        raise AssertionError(f"dapg_relocate: kl_dist {log['kl_dist']}")
    if len(out["demo_paths"]) != 2 \
            or dapg._demo_obs.shape[0] != 2 * DAPG_HORIZON \
            or log["num_samples"] != [50 * DAPG_HORIZON] \
            or not np.isfinite(out["policy"].get_param_values()).all():
        raise AssertionError("dapg_relocate: wrong counts or parameters")
    if dapg.device.type != "cuda":
        raise AssertionError("dapg_relocate: not on the card")
    fenv, policy = dapg.env.env, out["policy"]
    gen = make_generator(9, fenv.device)
    launches, busy, window_ms = profiled_window(
        lambda: rollout_batch(fenv, policy.config, policy.params,
                              policy.transforms, gen, 50, horizon=1), 1)
    emit({"phase": "dapg_relocate", "seconds": seconds,
          "kernel_launches": counts, "horizon": DAPG_HORIZON,
          "horizon_cut_from": AdroitRelocateEnv.horizon, "num_demos": 2,
          "bc_epochs": 2, "dapg_iterations": 1, "num_traj": 50,
          "demo_return": out["demo_return"],
          "bc_loss_end": out["bc"].logger.log["loss_after"][-1]
          if "loss_after" in out["bc"].logger.log else None,
          "time_sampling": log["time_sampling"], "time_npg": log["time_npg"],
          "time_VF": log["time_VF"], "kl_dist": log["kl_dist"],
          "stoc_pol_mean": log["stoc_pol_mean"],
          "success_rate": log.get("success_rate"),
          "ms_per_control_step": [t / DAPG_HORIZON * 1e3
                                  for t in log["time_sampling"]],
          "device_launches_per_step": launches, "window_ms": window_ms,
          "device_busy_share": busy,
          "peak_device_memory_bytes": torch.cuda.max_memory_allocated()})
    return counts


# ---------------------------------------------------------------------------
# M12: the host utilities around the training loop (K1 and K2 under them)
# ---------------------------------------------------------------------------

def host_point_mass():
    """A point mass on the host with the gymnasium API (the shape of
    tests/test_external_env.py::ToyHostEnv: spaces, spec, a 5-tuple step)
    and the mjrl point mass's observation layout [agent xy, velocity,
    target xy], so that the registry's point-mass reward reads its paths."""
    return HostPointMass()


class HostPointMass:
    class _Space:
        def __init__(self, n, bound):
            self.shape = (n,)
            self.low, self.high = -bound * np.ones(n), bound * np.ones(n)

    class _Spec:
        max_episode_steps = 25

    def __init__(self):
        self.observation_space = self._Space(6, np.inf)
        self.action_space = self._Space(2, 1.0)
        self.spec = self._Spec()
        self.reset()

    def reset(self, seed=None):
        rng = np.random.RandomState(seed)
        self._x, self._v = rng.uniform(-1, 1, 2), np.zeros(2)
        self._g = rng.uniform(-1, 1, 2)
        self._t = 0
        return self._obs(), {}

    def _obs(self):
        return np.concatenate([self._x, self._v, self._g])

    def step(self, a):
        self._v = self._v + 0.05 * np.asarray(a)
        self._x = self._x + 0.05 * self._v
        self._t += 1
        d = self._x - self._g
        r = -np.abs(d).sum() - 0.5 * np.linalg.norm(d)
        return self._obs(), float(r), False, self._t >= 25, {}


def seconds_of(fn):
    """-> (fn(), host seconds)."""
    t0 = time.time()
    out = fn()
    return out, time.time() - t0


def phase_native_paths_hopper():
    """A Hopper-v3 rollout (64 x 1000, K2) turned into paths; returns and
    GAE through the native path ops against the plain numpy loops (1e-12),
    pack_paths exactly."""
    env = HopperEnv()
    policy = MLP(env.spec, hidden_sizes=(64, 64), seed=5)
    gen = make_generator(3, env.device)
    batch, counts, roll_s = run_counted(lambda: rollout_batch(
        env, policy.config, policy.params, policy.transforms, gen, 64,
        horizon=HOPPER_HORIZON))
    if counts != {CONTACT: HOPPER_HORIZON, SMOOTH: 0}:
        raise AssertionError(f"native_paths_hopper: launched {counts}")
    paths = paths_to_list(batch)
    lengths = [len(p["rewards"]) for p in paths]
    if len(set(lengths)) < 2:
        raise AssertionError("native_paths_hopper: the paths are not ragged")
    rewards = [p["rewards"].astype(np.float64) for p in paths]
    library, build_s = seconds_of(native.build)      # g++, at first use
    _, load_s = seconds_of(native._load)             # ctypes, once
    rets, native_s = seconds_of(lambda: native.discount_sums(rewards, 0.995))
    plain, plain_s = seconds_of(
        lambda: native.discount_sums_plain(rewards, 0.995))
    errs = {"returns": max(np.abs(a - b).max() for a, b in zip(rets, plain))}
    ps_paths = [dict(p) for p in paths]
    baseline = LinearBaseline(env.spec)
    process_samples.compute_returns(ps_paths, 0.995)
    baseline.fit(ps_paths)
    (_, adv_s) = seconds_of(lambda: process_samples.compute_advantages(
        ps_paths, baseline, 0.995, 0.97))
    want = native.gae_advantages_plain(
        rewards, [p["baseline"] for p in ps_paths],
        [p["terminated"] for p in ps_paths], 0.995, 0.97)
    errs["advantages"] = max(np.abs(p["advantages"] - w).max()
                             for p, w in zip(ps_paths, want))
    errs["compute_returns"] = max(np.abs(p["returns"] - r).max()
                                  for p, r in zip(ps_paths, plain))
    obs = [p["observations"] for p in paths]
    (packed, pack_s) = seconds_of(lambda: native.pack_paths(obs))
    (ref, pack_plain_s) = seconds_of(lambda: native.pack_paths_plain(obs))
    if not (np.array_equal(packed[0], ref[0])
            and np.array_equal(packed[1], ref[1])):
        raise AssertionError("native_paths_hopper: pack_paths differs")
    # many long paths: 1024 ragged paths of up to 1000 steps (the traffic
    # of a 1000-step horizon under a policy that stays up), host data
    rng = np.random.RandomState(4)
    long_paths = [rng.normal(size=n) for n in rng.randint(1, 1001, 1024)]
    long_ret, long_s = seconds_of(
        lambda: native.discount_sums(long_paths, 0.995))
    long_ref, long_plain_s = seconds_of(
        lambda: native.discount_sums_plain(long_paths, 0.995))
    errs["returns_long"] = max(np.abs(a - b).max()
                               for a, b in zip(long_ret, long_ref))
    if max(errs.values()) > 1e-12:
        raise AssertionError(f"native_paths_hopper: {errs}")
    emit({"phase": "native_paths_hopper", "num_paths": len(paths),
          "path_lengths_min_max": [min(lengths), max(lengths)],
          "rollout_seconds": roll_s, "kernel_launches": counts,
          "max_abs_err": errs, "tolerance": 1e-12,
          "discount_sums_s": native_s, "discount_sums_plain_s": plain_s,
          "compute_advantages_s": adv_s, "pack_paths_s": pack_s,
          "pack_paths_plain_s": pack_plain_s,
          "long_paths_steps": int(sum(len(x) for x in long_paths)),
          "discount_sums_long_s": long_s,
          "discount_sums_long_plain_s": long_plain_s,
          "library": os.path.relpath(library, HERE), "build_s": build_s,
          "load_s": load_s})
    return counts


def hopper_npg_agent(seed, mesh=None):
    """Hopper-v3 NPG: 64-64 policy, LinearBaseline, step 0.05."""
    e = GymEnv("Hopper-v3")
    policy = MLP(e.spec, hidden_sizes=(64, 64), seed=seed)
    return NPG(e, policy, LinearBaseline(e.spec), normalized_step_size=0.05,
               seed=seed, save_logs=True, mesh=mesh)


def phase_checkpoint_resume_hopper():
    """Hopper-v3 NPG at 4096 x 1000, float32: agent A takes 2 iterations;
    B takes 1 and saves a checkpoint; C, built with another seed, restores
    it and takes 1: C's policy must equal A's."""
    step = dict(N=NUM_ENVS, horizon=HOPPER_HORIZON, gamma=0.995,
                gae_lambda=0.97)

    def run():
        a = hopper_npg_agent(11)
        a.train_step(**step)
        a.train_step(**step)
        b = hopper_npg_agent(11)
        b.train_step(**step)
        with tempfile.TemporaryDirectory() as tmp:
            checkpoint.save_agent_checkpoint(tmp, b, 1)
            c = hopper_npg_agent(12)
            it = checkpoint.restore_agent_checkpoint(tmp, c)
            size = os.path.getsize(os.path.join(tmp, "state_1.pt"))
        c.train_step(**step)
        return a, c, it, size

    (a, c, it, size), counts, seconds = run_counted(run)
    if counts != {CONTACT: 4 * HOPPER_HORIZON, SMOOTH: 0}:
        raise AssertionError(f"checkpoint_resume_hopper: launched {counts}")
    diff = float(np.abs(a.policy.get_param_values()
                        - c.policy.get_param_values()).max())
    bound = 1e-5
    if it != 1 or not diff <= bound \
            or not np.isfinite(a.policy.get_param_values()).all():
        raise AssertionError(f"checkpoint_resume_hopper: resumed policy "
                             f"differs by {diff} (iteration {it})")
    emit({"phase": "checkpoint_resume_hopper", "num_envs": NUM_ENVS,
          "horizon": HOPPER_HORIZON, "seconds": seconds,
          "kernel_launches": counts, "max_abs_param_diff": diff,
          "bitwise": diff == 0.0, "bound": bound, "checkpoint_bytes": size,
          "running_score": [a.running_score, c.running_score]})
    return counts


def phase_sweep_swimmer_ppo():
    """run_sweep over swimmer_ppo.json, grid seed=1,2 rl_num_iter=1,
    through the port's job script: two job directories, finite logs."""
    cfg = os.path.join(EXAMPLES, "example_configs", "swimmer_ppo.json")
    grid = ["seed=1,2", "rl_num_iter=1"]
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(sys.stderr):
            res, counts, seconds = run_counted(lambda: sweep.run_sweep(
                tmp, load_config(cfg), grid, sweep.job_script_entry()))
        logs = {}
        for job_dir, overrides in res:
            with open(os.path.join(job_dir, "logs", "log.pickle"),
                      "rb") as f:
                log = pickle.load(f)
            check_log(log, f"sweep_swimmer_ppo {overrides}", 1)
            logs[os.path.basename(job_dir)] = log["stoc_pol_mean"]
    if len(res) != 2 or counts != {SMOOTH: 2 * HORIZON, CONTACT: 0}:
        raise AssertionError(f"sweep_swimmer_ppo: {len(res)} jobs, "
                             f"launched {counts}")
    emit({"phase": "sweep_swimmer_ppo", "grid": grid, "seconds": seconds,
          "kernel_launches": counts, "stoc_pol_mean": logs})
    return counts


def phase_visualize(env_id, kernel, phase):
    """GymEnv.visualize_policy, horizon 100, the mean action: one launch
    of ``kernel`` at B = 1 per control step; the frames drawn where
    matplotlib is present."""
    e = GymEnv(env_id)
    policy = MLP(e.spec, hidden_sizes=(64, 64), seed=4)
    other = SMOOTH if kernel == CONTACT else CONTACT
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(sys.stderr):
            frames, counts, seconds = run_counted(lambda: e.visualize_policy(
                policy, horizon=100, mode="evaluation", save_dir=tmp))
        qpos = np.load(os.path.join(tmp, "episode_0_qpos.npy"))
        written = sorted(os.listdir(tmp))
    steps = len(qpos) - 1
    drawn, reason = render.drawing_available()
    if counts != {kernel: steps, other: 0} or not 0 < steps <= 100 \
            or not np.isfinite(qpos).all():
        raise AssertionError(f"{phase}: {steps} steps, launched {counts}")
    if drawn != (frames == steps + 1):
        raise AssertionError(f"{phase}: {frames} frames drawn for "
                             f"{steps + 1} states")
    emit({"phase": phase, "seconds": seconds, "steps": steps,
          "kernel_launches": counts, "ms_per_step": seconds / steps * 1e3,
          "drawn": drawn, "reason": reason, "frames": frames,
          "files": written})
    return counts


def render_card_vs_cpu():
    """render_trajectory's geometry (one batched forward kinematics over
    the frames) on the card against the CPU, float32, for the point mass
    and the reacher; the frames drawn where matplotlib is present."""
    out = {}
    for env_id, T in (("mjrl_point_mass-v0", 20), ("mjrl_reacher_7dof-v0",
                                                   20)):
        model = GymEnv(env_id).env.model
        rng = np.random.RandomState(8)
        q = np.asarray(model.qpos0) + rng.uniform(-0.6, 0.6, (T, model.nq))
        card, card_s = seconds_of(
            lambda: render.trajectory_geometry(model, q, "cuda"))
        cpu = render.trajectory_geometry(model, q, "cpu")
        err = max(float(np.abs(a - b).max()) for a, b in zip(card, cpu))
        if err > 1e-5:
            raise AssertionError(f"render {env_id}: card vs CPU {err}")
        with tempfile.TemporaryDirectory() as tmp:
            with contextlib.redirect_stdout(sys.stderr):
                frames, draw_s = seconds_of(lambda: render.render_trajectory(
                    model, q, save_dir=tmp, device="cuda"))
        drawn, reason = render.drawing_available()
        if drawn != (frames == T):
            raise AssertionError(f"render {env_id}: {frames} frames")
        out[env_id] = {"frames": T, "geometry_max_abs_err": err,
                       "geometry_s": card_s, "drawn": drawn,
                       "reason": reason, "draw_s": draw_s}
    return out


def phase_visualize_hopper():
    counts = phase_visualize("Hopper-v3", CONTACT, "visualize_hopper")
    rec, extra, seconds = run_counted(render_card_vs_cpu)
    if extra != NO_LAUNCHES:
        raise AssertionError(f"render_trajectory launched {extra}")
    emit({"phase": "render_trajectory", "seconds": seconds, **rec})
    return counts


INVERTED_PENDULUM = os.path.join(HERE, "mjrl_tpu_torch", "envs", "mjcf",
                                 "inverted_pendulum.xml")


def pendulum_mjcf_env(dtype=torch.float32, device=None):
    return MJCFEnv(INVERTED_PENDULUM, frame_skip=2, horizon=100,
                   reset_noise=0.01, dtype=dtype, device=device,
                   reward_fn=lambda obs, act: 1.0 - obs[..., 1] ** 2,
                   done_fn=lambda obs: obs[..., 1].abs() > 0.2)


def phase_mjcf_env_card():
    """MJCFEnv on the port's copy of inverted_pendulum.xml with a torch
    reward: a 4096 x 100 float32 rollout (finite), and 8 x 5 float64 on the
    card against the CPU (1e-10)."""
    env = pendulum_mjcf_env()
    policy = MLP(env.spec, hidden_sizes=(32, 32), seed=2)
    gen = make_generator(5, env.device)
    batch, counts, seconds = run_counted(lambda: rollout_batch(
        env, policy.config, policy.params, policy.transforms, gen, NUM_ENVS,
        horizon=100))
    check_finite(batch, "mjcf_env_card")
    if counts != NO_LAUNCHES:
        raise AssertionError(f"mjcf_env_card: launched {counts}")
    B, T = 8, 5
    rng = np.random.RandomState(6)
    q0, v0 = rng.uniform(-0.1, 0.1, (B, 2)), rng.uniform(-0.5, 0.5, (B, 2))
    noise = rng.normal(size=(T, B, 1))
    params = convert.params_to_numpy(MLP(
        env.spec, hidden_sizes=(32, 32), seed=3, dtype=torch.float64,
        device="cpu").params)
    out = []
    for d in ("cuda", "cpu"):
        e = pendulum_mjcf_env(torch.float64, d)
        pol = convert.policy_params_from_numpy(
            MLP(e.spec, hidden_sizes=(32, 32), dtype=torch.float64,
                device=d), params)
        out.append(rollout_batch(
            e, pol.config, pol.params, pol.transforms, None, B, horizon=T,
            state0=e.state_from_qpos_qvel(q0, v0),
            noise=torch.tensor(noise, device=d)))
    errs = {}
    for k in ("observations", "actions", "rewards", "mask"):
        errs[k] = (out[0][k].cpu() - out[1][k]).abs().max().item()
    if max(errs.values()) > 1e-10:
        raise AssertionError(f"mjcf_env_card: card vs CPU {errs}")
    emit({"phase": "mjcf_env_card", "num_envs": NUM_ENVS, "horizon": 100,
          "seconds": seconds, "kernel_launches": counts,
          "ms_per_control_step": seconds / 100 * 1e3,
          "valid_steps": int(batch["mask"].sum()),
          "card_vs_cpu": {"B": B, "horizon": T, "dtype": "float64",
                          "max_abs_err": errs, "tolerance": 1e-10}})
    return counts


def phase_external_env_card():
    """A host env behind GymEnv with the policy on the card: evaluate_policy,
    then 1 iteration of run_model_accel_npg on configs/point_mass.json with
    env_factory pointing at it."""
    e = GymEnv(host_point_mass)
    policy = MLP(e.spec, hidden_sizes=(32, 32), seed=1)
    if not e._external or policy.device.type != "cuda":
        raise AssertionError("external_env_card: not an external env")
    (base, _, _), eval_s = seconds_of(
        lambda: e.evaluate_policy(policy, num_episodes=4, mean_action=True))
    from mjrl_tpu_torch.algos.model_accel.run_experiments import \
        run_model_accel_npg
    with open(os.path.join(M10_CONFIGS, "point_mass.json")) as f:
        job = json.load(f)
    job.update(num_iter=1, eval_rollouts=2,
               env_factory="chip_smoke:host_point_mass")
    with tempfile.TemporaryDirectory() as tmp:
        with contextlib.redirect_stdout(sys.stderr):
            (agent, logger), counts, seconds = run_counted(
                lambda: run_model_accel_npg.run(tmp, job))
    log = logger.log
    check_log(log, "external_env_card", 1)
    if counts != NO_LAUNCHES or not np.isfinite(base).all() \
            or log["num_samples"] != [job["init_samples"]] \
            or agent.device.type != "cuda" or not agent.env._external:
        raise AssertionError(f"external_env_card: launched {counts}, "
                             f"num_samples {log['num_samples']}")
    emit({"phase": "external_env_card", "evaluate_policy_s": eval_s,
          "eval_mean_return": base[0], "runner_seconds": seconds,
          "kernel_launches": counts, "num_samples": log["num_samples"],
          "rollout_score": log["rollout_score"],
          "eval_score": log["eval_score"],
          "data_collect_time": log["data_collect_time"],
          "model_update_time": log["model_update_time"],
          "policy_update_time": log["policy_update_time"]})
    return counts


def trace_kernel_events(events, kernel_name):
    """-> (the number of the Chrome trace's kernel events named
    ``kernel_name``, the number of the trace's launch calls that have no
    kernel event, and the first 8 of those: each its index among the
    launch calls, their count, and its start relative to the first and
    last launch, in microseconds)."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    hits = sum(kernel_name in e.get("name", "") for e in kernels)
    have = {e.get("args", {}).get("correlation") for e in kernels}
    launches = sorted((e for e in events
                       if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "LaunchKernel" in e.get("name", "")),
                      key=lambda e: e.get("ts", 0))
    missing = []
    for i, e in enumerate(launches):
        if e.get("args", {}).get("correlation") not in have:
            missing.append({"index": i, "of": len(launches),
                            "name": e.get("name"),
                            "from_first_us": e["ts"] - launches[0]["ts"],
                            "to_last_us": launches[-1]["ts"] - e["ts"]})
    return hits, len(missing), missing[:8]


def phase_profile_swimmer():
    """One Swimmer NPG train_step (4096 x 500) under profiling.trace: the
    trace file names K1's kernel; time_jitted of one control step."""
    e = GymEnv("mjrl_swimmer-v0")
    policy = MLP(e.spec, hidden_sizes=(64, 64), seed=6)
    agent = NPG(e, policy, LinearBaseline(e.spec), normalized_step_size=0.1,
                seed=6, save_logs=True)
    with tempfile.TemporaryDirectory() as tmp:
        def run():
            with profiling.trace(tmp):
                agent.train_step(N=NUM_ENVS, horizon=HORIZON, gamma=0.995,
                                 gae_lambda=0.97)
        _, counts, seconds = run_counted(run)
        path = os.path.join(tmp, "trace.json")
        size = os.path.getsize(path)
        kernel_name = "planar_step_kernel_f32"
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    hits, n_missing, missing = trace_kernel_events(events, kernel_name)
    if counts != {SMOOTH: HORIZON, CONTACT: 0} or hits < 1:
        raise AssertionError(f"profile_swimmer: launched {counts}, the "
                             f"trace names {kernel_name} {hits} times")
    fenv = e.env
    state = fenv.reset(NUM_ENVS, make_generator(1, fenv.device))
    act = torch.zeros((NUM_ENVS, fenv.action_dim), device=fenv.device)
    step_s, _, _ = run_counted(lambda: profiling.time_jitted(
        fenv.step, state, act, iters=50, warmup=5))
    emit({"phase": "profile_swimmer", "seconds": seconds,
          "kernel_launches": counts, "trace_bytes": size,
          "trace_kernel_events": hits, "expected_kernel_events": HORIZON,
          "launches_without_kernel_event": n_missing,
          "first_launches_without_kernel_event": missing,
          "time_jitted_control_step_ms": step_s * 1e3})
    return counts


def phase_fit_data_card():
    """fit_data (Adam) at float64 on the card against the CPU, the same
    injected permutations: 1e-10."""
    rng = np.random.RandomState(12)
    n, d = 512, 16
    x = rng.normal(size=(n, d))
    y = np.tanh(x @ rng.normal(size=(d, 4)))
    p = {"w1": rng.normal(0, 0.3, (d, 64)), "b1": np.zeros(64),
         "w2": rng.normal(0, 0.3, (64, 4)), "b2": np.zeros(4)}
    perms = np.stack([rng.permutation(n) for _ in range(3)])

    def loss(q, xb, yb):
        return torch.mean((torch.tanh(xb @ q["w1"] + q["b1"]) @ q["w2"]
                           + q["b2"] - yb) ** 2)
    out = {}
    for dev in ("cuda", "cpu"):
        params = {k: torch.tensor(v, device=dev) for k, v in p.items()}
        out[dev], secs = seconds_of(lambda: optimize_model.fit_data(
            loss, params, x, y, batch_size=64, epochs=3, perms=perms))
        out[dev + "_s"] = secs
    err = max((out["cuda"][0][k].cpu() - out["cpu"][0][k]).abs().max().item()
              for k in p)
    loss_err = float(np.abs(np.subtract(out["cuda"][2],
                                        out["cpu"][2])).max())
    if max(err, loss_err) > 1e-10 or out["cuda"][1]["count"] != 24:
        raise AssertionError(f"fit_data_card: {err}, losses {loss_err}")
    emit({"phase": "fit_data_card", "adam_steps": 24,
          "max_abs_err_params": err, "max_abs_err_losses": loss_err,
          "tolerance": 1e-10, "card_s": out["cuda_s"],
          "cpu_s": out["cpu_s"], "losses": out["cuda"][2]})
    return NO_LAUNCHES


def phase_examples_m12():
    """The three examples of this slice, their counts cut (each cut
    printed): the point-mass smoke benchmark, the NN-against-linear
    comparison on the swimmer and the visualizer smoke script."""
    cuts = {
        "torch_point_mass_smoke": (["--niter", "2"], "niter 50 -> 2"),
        "torch_linear_nn_comparison": (["--niter", "1", "--eval_rollouts",
                                        "1"],
                                       "niter 50 -> 1, eval_rollouts 5 -> 1"),
        "torch_visualizer_smoke": (["--niter", "1", "--episodes", "1"],
                                   "niter 10 -> 1, episodes 2 -> 1"),
    }
    # the swimmer: 2 policies x (10 x 500 rollout + 1 x 500 evaluation)
    want = {"torch_point_mass_smoke": NO_LAUNCHES,
            "torch_linear_nn_comparison": {SMOOTH: 2 * 2 * HORIZON,
                                           CONTACT: 0},
            "torch_visualizer_smoke": NO_LAUNCHES}
    total = dict(NO_LAUNCHES)
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (argv, cut) in cuts.items():
            mod = example_module(name)
            job = ["--job_prefix" if name == "torch_linear_nn_comparison"
                   else "--job", os.path.join(tmp, name)]
            with contextlib.redirect_stdout(sys.stderr):
                out, counts, seconds = run_counted(
                    lambda: mod.main(argv + job))
            agents = list(out.values()) if isinstance(out, dict) else \
                [out[0] if isinstance(out, tuple) else out]
            for agent in agents:
                if not np.isfinite(agent.policy.get_param_values()).all() \
                        or agent.device.type != "cuda":
                    raise AssertionError(f"{name}: policy not finite")
            if counts != want[name]:
                raise AssertionError(f"{name}: launched {counts}")
            rec[name] = {"cut": cut, "seconds": seconds,
                         "kernel_launches": counts}
            if name == "torch_visualizer_smoke":
                rec[name]["frames"] = out[1]
            for k in total:
                total[k] += counts[k]
    emit({"phase": "examples_m12", **rec})
    return total


# ---------------------------------------------------------------------------
# M11: data parallelism over ranks (mjrl_tpu_torch/parallel/)
# ---------------------------------------------------------------------------

M11_RANKS = 2
M11_TIMEOUT_S = 300
M11_GROUP_TIMEOUT_S = 120
# a sharded against an unsharded step: the JAX package's own bounds
# (tests/test_parallel.py), (rtol, atol)
M11_STATS_BOUND, M11_PARAMS_BOUND = (1e-3, 1e-3), (1e-2, 1e-3)
M11_UPDATE_RTOL = 1e-2
M11_ENSEMBLE = dict(num_models=4, state_dim=11, act_dim=3, n=4096,
                    hidden=(64, 64), mb=256, epochs=2)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rel_diff(a, b):
    """max |a - b| over max |b|: the largest difference relative to the
    quantity's scale."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def within(a, b, bound):
    rtol, atol = bound
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool(np.all(np.abs(a - b) <= atol + rtol * np.abs(b)))


def update_step(params, params0):
    """The size of one update: the norm and the largest entry of the
    parameters' change."""
    d = np.asarray(params, np.float64) - np.asarray(params0, np.float64)
    return {"step_norm": float(np.linalg.norm(d)),
            "step_max_abs": float(np.abs(d).max())}


def m11_hopper_iteration(mesh=None, num_envs=NUM_ENVS):
    """One Hopper-v3 NPG iteration at num_envs x 1000 (64-64 policy,
    LinearBaseline) through NPG(..., mesh=mesh), seed 21."""
    agent = hopper_npg_agent(21, mesh)
    c0 = 0 if mesh is None else mesh.collectives
    params0 = agent.policy.get_param_values()
    t0 = time.time()
    stats = agent.train_step(N=num_envs, horizon=HOPPER_HORIZON,
                             gamma=0.995, gae_lambda=0.97)
    torch.cuda.synchronize()
    log = {k: v[-1] for k, v in agent.logger.log.items()}
    params = agent.policy.get_param_values()
    return {"stats": stats[:4], "seconds": time.time() - t0,
            "params": params.tolist(),
            "update": {"alpha": log["alpha"], "kl_dist": log["kl_dist"],
                       **update_step(params, params0)},
            "num_samples": log["num_samples"], "kl_dist": log["kl_dist"],
            "time_sampling": log["time_sampling"],
            "time_npg": log["time_npg"], "time_VF": log["time_VF"],
            "collectives": 0 if mesh is None else mesh.collectives - c0}


def m11_swimmer_ppo_iteration(mesh=None, num_traj=None):
    """One iteration of examples/example_configs/swimmer_ppo.json (PPO +
    MLPBaseline, 10 x 500, or num_traj x 500) built by the job script's
    build_agent, with the mesh passed through the config's
    alg_hyper_params."""
    job = load_config(os.path.join(EXAMPLES, "example_configs",
                                   "swimmer_ppo.json"))
    job["alg_hyper_params"] = {**job["alg_hyper_params"], "mesh": mesh}
    if num_traj is not None:
        job["rl_num_traj"] = num_traj
    agent = job_script().build_agent(job)
    c0 = 0 if mesh is None else mesh.collectives
    params0 = agent.policy.get_param_values()
    t0 = time.time()
    stats = agent.train_step(N=job["rl_num_traj"],
                             sample_mode=job["sample_mode"],
                             gamma=job["rl_gamma"],
                             gae_lambda=job["rl_gae"])
    torch.cuda.synchronize()
    log = {k: v[-1] for k, v in agent.logger.log.items()}
    params = agent.policy.get_param_values()
    return {"stats": stats[:4], "seconds": time.time() - t0,
            "params": params.tolist(),
            "update": {"kl_dist": log["kl_dist"],
                       **update_step(params, params0)},
            "num_samples": log["num_samples"], "t_opt": log["t_opt"],
            "time_VF": log["time_VF"],
            "ppo_adam_steps": int(agent.opt_state["count"]),
            "collectives": 0 if mesh is None else mesh.collectives - c0}


def m11_ensemble(mesh=None):
    """A 4-member WorldModelEnsemble at float64 on the card: fit_dynamics
    (drawn permutations) and predict_all on numpy-seeded data."""
    from mjrl_tpu_torch.algos.model_accel.nn_dynamics import \
        WorldModelEnsemble
    c = M11_ENSEMBLE
    rng = np.random.RandomState(0)
    s = rng.normal(size=(c["n"], c["state_dim"]))
    a = rng.normal(size=(c["n"], c["act_dim"]))
    sp = s + 0.1 * np.tanh(a @ rng.normal(size=(c["act_dim"],
                                                c["state_dim"])))
    ens = WorldModelEnsemble(c["num_models"], c["state_dim"], c["act_dim"],
                             seed=7, hidden_size=c["hidden"],
                             dtype=torch.float64, mesh=mesh)
    t0 = time.time()
    losses = ens.fit_dynamics(s, a, sp, c["mb"], c["epochs"])
    pred = ens.predict_all(s[:256], a[:256])
    torch.cuda.synchronize()
    params = torch.cat([v.reshape(-1) for v in ens._dyn["params"].values()])
    return {"losses": np.asarray(losses).tolist(),
            "params": params.cpu().numpy().tolist(),
            "predict_all": pred.cpu().numpy().tolist(),
            "seconds": time.time() - t0}


def m11_contact_launch_check(mesh):
    """One launch of K2 on this rank's rows of a 4096-row Hopper reset (the
    policy's mean actions) against the plain version on the same inputs,
    at the float32 bounds of the kernels phase -> max abs errors."""
    env = HopperEnv()
    policy = MLP(env.spec, hidden_sizes=(64, 64), seed=21)
    s = env.reset(NUM_ENVS, make_generator(3, env.device), mesh=mesh)
    with torch.no_grad():
        u = policy.config.dist_info(policy.params, policy.transforms,
                                    s.obs)[0].contiguous()
    q, v = s.physics.qpos.contiguous(), s.physics.qvel.contiguous()
    gq, gv = cuda_planar.cuda_step_n_batched(env._planar, q, v, u,
                                             env.frame_skip)
    rq, rv = step_n_arrays(env._planar, q, v, u, env.frame_skip)
    torch.cuda.synchronize()
    tol_q, tol_v = CONTACT_TOL[torch.float32]
    torch.testing.assert_close(gq, rq, rtol=tol_q, atol=tol_q)
    torch.testing.assert_close(gv, rv, rtol=tol_v,
                               atol=tol_v * max(1.0, rv.abs().max().item()))
    return {"rows": int(q.shape[0]), "max_abs_err_q": (gq - rq).abs().max()
            .item(), "max_abs_err_v": (gv - rv).abs().max().item(),
            "tolerance": [tol_q, tol_v]}


def m11_worker(rank, world, init_method, out_path):
    """One rank of the two-rank phases (run as ``chip_smoke.py --m11-rank
    R ...``): a gloo group over CUDA tensors on the one card; the kernels
    come from the build phase's libraries."""
    import datetime
    import torch.distributed as dist
    from mjrl_tpu_torch.parallel import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=M11_GROUP_TIMEOUT_S))
    mesh = make_mesh()
    res = {"rank": rank, "mesh": repr(mesh)}
    built = {name: cuda_planar.kernel_build_info(env._planar)
             ["build_seconds"] for name, env in
             (("hopper", HopperEnv()), ("swimmer", SwimmerEnv()))}
    if any(built.values()):
        raise AssertionError(f"rank {rank} built a kernel: {built}")
    for name, fn in (("hopper", m11_hopper_iteration),
                     ("swimmer_ppo", m11_swimmer_ppo_iteration)):
        out, counts, seconds = run_counted(lambda: fn(mesh))
        res[name] = {**out, "kernel_launches": counts,
                     "counted_seconds": seconds}
    res["contact_check"] = m11_contact_launch_check(mesh)
    res["ensemble"] = m11_ensemble(mesh)
    dist.barrier()
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(res, f)


def run_m11_ranks(tmp):
    """Two fresh processes of this script, one per rank, on the one card;
    the first to fail (or the deadline) stops the other -> results."""
    init = "file://" + os.path.join(tmp, "group_init")
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(M11_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--m11-rank", str(r),
         "--m11-world", str(M11_RANKS), "--m11-init", init, "--m11-out",
         outs[r]], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(M11_RANKS)]
    deadline = time.time() + M11_TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) \
                    or time.time() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    logs = [p.communicate()[0] for p in procs]
    for r, p in enumerate(procs):
        if p.returncode != 0:
            print("\n".join(f"--- rank {i} ---\n{log[-6000:]}"
                            for i, log in enumerate(logs)), file=sys.stderr)
            raise AssertionError(f"rank {r} of {M11_RANKS} failed (rc "
                                 f"{p.returncode}) or the pair passed "
                                 f"{M11_TIMEOUT_S} s")
    res = []
    for path in outs:
        with open(path) as f:
            res.append(json.load(f))
    return res


def phase_m11_world1_hopper():
    """An NCCL group of world size 1 in this process: Hopper-v3 NPG at
    4096 x 1000 through NPG(..., mesh=make_mesh()), one iteration, against
    the unsharded agent's iteration from the same seed -> (unsharded
    result, sharded result, K2 launches)."""
    import datetime
    import torch.distributed as dist
    from mjrl_tpu_torch.parallel import make_mesh
    ref, ref_counts, _ = run_counted(lambda: m11_hopper_iteration(None))
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=M11_GROUP_TIMEOUT_S))
    try:
        mesh = make_mesh()
        got, counts, _ = run_counted(lambda: m11_hopper_iteration(mesh))
    finally:
        dist.destroy_process_group()
    want = {CONTACT: HOPPER_HORIZON, SMOOTH: 0}
    if counts != want or ref_counts != want:
        raise AssertionError(f"m11_world1_hopper: launched {counts} "
                             f"(unsharded {ref_counts}), expected {want}")
    diffs = {k: rel_diff(got[k], ref[k]) for k in ("stats", "params")}
    diffs["update"] = rel_diff(list(got["update"].values()),
                               list(ref["update"].values()))
    bound = 1e-6
    if not max(diffs.values()) <= bound or got["collectives"] == 0:
        raise AssertionError(f"m11_world1_hopper: sharded against "
                             f"unsharded {diffs} (bound {bound}), "
                             f"{got['collectives']} collectives")
    emit({"phase": "m11_world1_hopper", "backend": "nccl", "world": 1,
          "num_envs": NUM_ENVS, "horizon": HOPPER_HORIZON,
          "kernel_launches": counts, "max_rel_diff": diffs, "bound": bound,
          "seconds_unsharded": ref["seconds"], "seconds": got["seconds"],
          "collectives": got["collectives"],
          "stats": got["stats"], "kl_dist": got["kl_dist"]})
    return ref, got, counts


def m11_compare(phase, rank_res, ref):
    """Every rank against the one-rank run: statistics and parameters at
    the JAX package's bounds, and what the update moves (alpha, kl_dist,
    the norm of the parameters' change) at rtol M11_UPDATE_RTOL, since the
    statistics are the pre-update rollout's and a step wrong by tens of
    per cent can stay inside the parameters' atol -> the measured
    differences, with the one-rank step's size beside its bound."""
    diffs = {"stats_max_abs": 0.0, "params_max_abs": 0.0,
             "stats_rel": 0.0, "params_rel": 0.0,
             **{f"{k}_rel": 0.0 for k in ref["update"]}}
    for r in rank_res:
        got = r[phase]
        if not (within(got["stats"], ref["stats"], M11_STATS_BOUND)
                and within(got["params"], ref["params"], M11_PARAMS_BOUND)):
            raise AssertionError(
                f"{phase}: rank {r['rank']} stats {got['stats']} against "
                f"{ref['stats']}, params off by "
                f"{rel_diff(got['params'], ref['params'])}")
        for k, want in ref["update"].items():
            d = abs(got["update"][k] - want) / max(abs(want), 1e-30)
            if not d <= M11_UPDATE_RTOL:
                raise AssertionError(
                    f"{phase}: rank {r['rank']} {k} {got['update'][k]} "
                    f"against {want} (rtol {M11_UPDATE_RTOL})")
            diffs[f"{k}_rel"] = max(diffs[f"{k}_rel"], d)
        for k in ("stats", "params"):
            a, b = np.asarray(got[k]), np.asarray(ref[k])
            diffs[f"{k}_max_abs"] = max(diffs[f"{k}_max_abs"],
                                        float(np.abs(a - b).max()))
            diffs[f"{k}_rel"] = max(diffs[f"{k}_rel"], rel_diff(a, b))
    if any(r[phase]["params"] != rank_res[0][phase]["params"]
           for r in rank_res[1:]):
        raise AssertionError(f"{phase}: the ranks' policies differ")
    diffs["one_rank_update"] = ref["update"]
    diffs["params_atol_over_step_max_abs"] = \
        M11_PARAMS_BOUND[1] / max(ref["update"]["step_max_abs"], 1e-30)
    return diffs


def phase_m11_two_ranks(hopper_ref):
    """Two ranks (fresh processes, gloo over CUDA tensors, one card):
    Hopper NPG, swimmer_ppo.json and a 4-member ensemble against the
    one-rank runs of this process -> {phase: per-rank launches}."""
    ppo_ref, ppo_counts, _ = run_counted(lambda: m11_swimmer_ppo_iteration())
    ens_ref = m11_ensemble()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        ranks = run_m11_ranks(tmp)
        pair_s = time.time() - t0
    launches = {}
    # Hopper: 2048 rows and 1000 K2 launches per rank
    want = {CONTACT: HOPPER_HORIZON, SMOOTH: 0}
    for r in ranks:
        if r["hopper"]["kernel_launches"] != want:
            raise AssertionError(f"m11_two_ranks_hopper: rank {r['rank']} "
                                 f"launched {r['hopper']['kernel_launches']}")
        if r["contact_check"]["rows"] != NUM_ENVS // M11_RANKS:
            raise AssertionError("m11_two_ranks_hopper: the K2 check took "
                                 f"{r['contact_check']['rows']} rows")
    diffs = m11_compare("hopper", ranks, hopper_ref)
    emit({"phase": "m11_two_ranks_hopper", "backend": "gloo",
          "world": M11_RANKS, "rows_per_rank": NUM_ENVS // M11_RANKS,
          "horizon": HOPPER_HORIZON,
          "kernel_launches": [r["hopper"]["kernel_launches"] for r in ranks],
          "k2_against_plain": [r["contact_check"] for r in ranks],
          "diff_to_one_rank": diffs, "bounds": {
              "stats": M11_STATS_BOUND, "params": M11_PARAMS_BOUND,
              "update_rtol": M11_UPDATE_RTOL},
          "seconds": [r["hopper"]["seconds"] for r in ranks],
          "collectives": [r["hopper"]["collectives"] for r in ranks],
          "num_samples": [r["hopper"]["num_samples"] for r in ranks]})
    launches["m11_two_ranks_hopper"] = [
        r["hopper"]["kernel_launches"] for r in ranks]
    # swimmer_ppo.json: 5 rows and 500 K1 launches per rank
    want = {SMOOTH: HORIZON, CONTACT: 0}
    if ppo_counts != want:
        raise AssertionError(f"m11_two_ranks_swimmer_ppo: one rank "
                             f"launched {ppo_counts}")
    for r in ranks:
        if r["swimmer_ppo"]["kernel_launches"] != want:
            raise AssertionError(
                f"m11_two_ranks_swimmer_ppo: rank {r['rank']} launched "
                f"{r['swimmer_ppo']['kernel_launches']}")
        if r["swimmer_ppo"]["ppo_adam_steps"] != ppo_ref["ppo_adam_steps"]:
            raise AssertionError("m11_two_ranks_swimmer_ppo: Adam steps "
                                 f"{r['swimmer_ppo']['ppo_adam_steps']}")
    diffs = m11_compare("swimmer_ppo", ranks, ppo_ref)
    emit({"phase": "m11_two_ranks_swimmer_ppo", "config": "swimmer_ppo.json",
          "backend": "gloo", "world": M11_RANKS,
          "kernel_launches": [r["swimmer_ppo"]["kernel_launches"]
                              for r in ranks],
          "diff_to_one_rank": diffs, "bounds": {
              "stats": M11_STATS_BOUND, "params": M11_PARAMS_BOUND,
              "update_rtol": M11_UPDATE_RTOL},
          "ppo_adam_steps": ppo_ref["ppo_adam_steps"],
          "seconds_one_rank": ppo_ref["seconds"],
          "seconds": [r["swimmer_ppo"]["seconds"] for r in ranks],
          "t_opt": [r["swimmer_ppo"]["t_opt"] for r in ranks],
          "t_opt_one_rank": ppo_ref["t_opt"],
          "collectives": [r["swimmer_ppo"]["collectives"] for r in ranks]})
    launches["m11_two_ranks_swimmer_ppo"] = [
        r["swimmer_ppo"]["kernel_launches"] for r in ranks]
    # the ensemble, float64
    ens = {k: max(rel_diff(r["ensemble"][k], ens_ref[k]) for r in ranks)
           for k in ("losses", "params", "predict_all")}
    bound = 1e-10
    if not max(ens.values()) <= bound:
        raise AssertionError(f"m11_ensemble: two ranks against one {ens}")
    emit({"phase": "m11_ensemble", "world": M11_RANKS, **M11_ENSEMBLE,
          "dtype": "float64", "max_rel_diff": ens, "bound": bound,
          "seconds_one_rank": ens_ref["seconds"],
          "seconds": [r["ensemble"]["seconds"] for r in ranks]})
    launches["m11_ensemble"] = [NO_LAUNCHES, NO_LAUNCHES]
    return launches, ranks, ppo_ref, pair_s


def phase_m11(kernel, contact):
    """The M11 block: world size 1 over NCCL, then two ranks over gloo;
    adds each phase's launches to the kernels' launches_by_path."""
    phase_seconds = {}
    t0 = time.time()
    hopper_ref, world1, counts = phase_m11_world1_hopper()
    phase_seconds["m11_world1_hopper"] = time.time() - t0
    kernel["launches_by_path"]["m11_world1_hopper"] = counts[SMOOTH]
    contact["launches_by_path"]["m11_world1_hopper"] = counts[CONTACT]
    t0 = time.time()
    launches, ranks, ppo_ref, pair_s = phase_m11_two_ranks(hopper_ref)
    phase_seconds["m11_two_ranks"] = time.time() - t0
    for name, per_rank in launches.items():
        kernel["launches_by_path"][name] = [c[SMOOTH] for c in per_rank]
        contact["launches_by_path"][name] = [c[CONTACT] for c in per_rank]
    per_rank = lambda k, f: [r[k][f] for r in ranks]
    emit({"phase": "m11_timing",
          "note": "the two ranks share one card: their times measure "
                  "correctness and overhead, not scaling",
          "hopper_seconds_per_iteration": {
              "one_rank": hopper_ref["seconds"],
              "world1_nccl": world1["seconds"],
              "two_ranks_gloo": per_rank("hopper", "seconds")},
          "hopper_collectives_per_iteration": {
              "world1_nccl": world1["collectives"],
              "two_ranks_gloo": per_rank("hopper", "collectives")},
          "swimmer_ppo_seconds_per_iteration": {
              "one_rank": ppo_ref["seconds"],
              "two_ranks_gloo": per_rank("swimmer_ppo", "seconds")},
          "swimmer_ppo_collectives_per_iteration":
              per_rank("swimmer_ppo", "collectives"),
          "two_rank_processes_seconds": pair_s})
    emit({"phase": "m11", "phase_seconds": phase_seconds,
          "seconds": sum(phase_seconds.values())})
    return {"swimmer_ppo": ppo_ref}


# ---------------------------------------------------------------------------
# M11 on every card of one host: torchrun, initialize(), train_agent
# ---------------------------------------------------------------------------

CARDS_TIMEOUT_S = 420       # the R rank processes, start-up included
CARDS_ENSEMBLE_BOUND = 1e-12
CARDS_PROFILE_STEPS = 20    # control steps of the busy-share window


def cards_world():
    """(R, backend): four ranks over NCCL, one per card, on a host of four
    cards or more; else two over gloo (asked for) sharing the one card."""
    if torch.cuda.device_count() >= 4:
        return 4, "nccl"
    return 2, "gloo"


def job_files(job):
    return sorted(os.path.relpath(os.path.join(d, f), job)
                  for d, _, fs in os.walk(job) for f in fs)


def timed_steps(agent, mesh, record):
    """Wrap agent.train_step: each call appends its seconds, its
    collectives, its statistics, the parameters after it and what the
    update moved."""
    step = agent.train_step

    def timed(*args, **kwargs):
        c0 = 0 if mesh is None else mesh.collectives
        params0 = agent.policy.get_param_values()
        torch.cuda.synchronize()
        t0 = time.time()
        stats = step(*args, **kwargs)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        log = {k: v[-1] for k, v in agent.logger.log.items()}
        params = agent.policy.get_param_values()
        record.append({
            "seconds": seconds, "stats": list(stats[:4]),
            "params": params.tolist(),
            "update": {"alpha": log["alpha"], "kl_dist": log["kl_dist"],
                       **update_step(params, params0)},
            "collectives": 0 if mesh is None else mesh.collectives - c0})
        return stats
    agent.train_step = timed


def cards_train_agent(mesh, root):
    """Hopper-v3 NPG at 4096 x 1000 through train_agent (the agent of
    m11_hopper_iteration): 2 iterations with save_freq 1, a resume for 1
    more, and 3 uninterrupted iterations -> what the parent checks."""
    kw = dict(seed=0, gamma=0.995, gae_lambda=0.97, num_traj=NUM_ENVS,
              save_freq=1)
    job, whole = os.path.join(root, "job"), os.path.join(root, "whole")
    runs, out = {}, {}
    for name, path, niter in (("first", job, 2), ("resumed", job, 3),
                              ("whole", whole, 3)):
        agent, record = hopper_npg_agent(21, mesh), []
        timed_steps(agent, mesh, record)
        with contextlib.redirect_stdout(sys.stderr):
            _, counts, seconds = run_counted(
                lambda: train_agent(path, agent, niter=niter, **kw))
        runs[name] = agent
        out[name] = {"iterations": record, "kernel_launches": counts,
                     "seconds": seconds}
        if name == "first":
            out["files"] = job_files(job)
    out["files_after_resume"] = job_files(job)
    a, b = runs["resumed"], runs["whole"]
    same = {
        "params": bool(np.array_equal(a.policy.get_param_values(),
                                      b.policy.get_param_values())),
        "baseline": bool(torch.equal(a.baseline.state, b.baseline.state)),
        "generator": bool(torch.equal(a.generator.get_state(),
                                      b.generator.get_state())),
        "policy_generator": bool(torch.equal(
            a.policy.generator.get_state(), b.policy.generator.get_state())),
        "stats": out["resumed"]["iterations"][-1]["stats"]
        == out["whole"]["iterations"][-1]["stats"]}
    out["resume_bitwise"] = same
    out["resumed_policy_device"] = str(a.policy.device)
    out["resumed_baseline_device"] = str(a.baseline.state.device)
    return out, a


def m11_smooth_launch_check(mesh):
    """One launch of K1 on this rank's rows of a 4096-row Swimmer batch
    against the plain version on the same inputs, at the float32 bounds of
    the kernels phase -> max abs errors."""
    p = SwimmerEnv()._planar
    q, v, u = (torch.tensor(a, dtype=torch.float32, device=mesh.device)
               [mesh.rows(NUM_ENVS)] for a in swimmer_test_states(
                   NUM_ENVS, seed=5))
    gq, gv = cuda_planar.cuda_step_n_batched(p, q, v, u, FRAME_SKIP)
    rq, rv = step_n_arrays(p, q, v, u, FRAME_SKIP)
    torch.cuda.synchronize()
    torch.testing.assert_close(gq, rq, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(gv, rv, rtol=2e-4, atol=2e-4)
    return {"rows": int(q.shape[0]), "max_abs_err_q": (gq - rq).abs().max()
            .item(), "max_abs_err_v": (gv - rv).abs().max().item(),
            "tolerance": [2e-5, 2e-4]}


def cards_busy_share(agent, mesh):
    """The device's busy share and launches per control step over a
    CARDS_PROFILE_STEPS-step rollout of this rank's rows."""
    fenv, pol = agent.fenv, agent.policy
    launches, busy, window_ms = profiled_window(
        lambda: rollout_batch(fenv, pol.config, pol.params, pol.transforms,
                              make_generator(1, mesh.device), NUM_ENVS,
                              horizon=CARDS_PROFILE_STEPS, mesh=mesh),
        CARDS_PROFILE_STEPS)
    return {"launches_per_step": launches, "busy_share": busy,
            "window_ms": window_ms, "steps": CARDS_PROFILE_STEPS}


def cards_scaling(mesh, repeats=2):
    """Hopper NPG seconds per iteration at R = 1, 2 and 4 on this host's
    cards: strong (4096 rows split R ways) and weak (R x 4096 rows), each
    run ``repeats`` times in turns; the ranks outside a run wait at a
    barrier, and a group's communicator is built before its clock
    starts."""
    import torch.distributed as dist
    from mjrl_tpu_torch.parallel.mesh import Mesh
    groups = {2: dist.new_group([0, 1]), 4: dist.group.WORLD}
    out = {}
    for R in (1, 2, 4) * repeats:
        for kind, rows in (("strong", NUM_ENVS), ("weak", R * NUM_ENVS)):
            if R == 1 and kind == "weak":
                continue                # the same run as strong
            if mesh.rank < R:
                sub = None if R == 1 else Mesh(groups[R], mesh.rank, R,
                                               mesh.device)
                if sub is not None:
                    sub.barrier()
                (r, counts, _) = run_counted(
                    lambda: m11_hopper_iteration(sub, rows))
                out.setdefault(f"R{R}_{kind}", []).append({
                    "rows": rows, "rows_per_rank": rows // R,
                    "seconds": r["seconds"],
                    "time_sampling": r["time_sampling"],
                    "time_npg": r["time_npg"], "time_VF": r["time_VF"],
                    "control_steps_per_s": rows * HOPPER_HORIZON
                    / r["seconds"],
                    "num_samples": r["num_samples"],
                    "collectives": r["collectives"],
                    "kernel_launches": counts})
            mesh.barrier()
    return out


def cards_worker(out_dir, backend, scaling):
    """One rank of m11_cards, started by torchrun (``chip_smoke.py
    --cards-rank``): the group through parallel.distributed.initialize()
    and global_mesh(), as a user's script joins it; the kernels come from
    the build phase's libraries."""
    import torch.distributed as dist
    from mjrl_tpu_torch.parallel import distributed as pdist
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    if backend == "gloo":         # ranks sharing the one card
        pdist.initialize(backend="gloo", local_device_ids=[0],
                         timeout=M11_GROUP_TIMEOUT_S)
    else:
        pdist.initialize(timeout=M11_GROUP_TIMEOUT_S)
    mesh = pdist.global_mesh()
    res = {"rank": mesh.rank, "world": mesh.size, "mesh": repr(mesh),
           "device": str(mesh.device), "backend": dist.get_backend(),
           "local_rank": int(os.environ["LOCAL_RANK"])}
    built = {name: cuda_planar.kernel_build_info(env._planar)
             ["build_seconds"] for name, env in
             (("hopper", HopperEnv()), ("swimmer", SwimmerEnv()))}
    if any(built.values()):
        raise AssertionError(f"rank {mesh.rank} built a kernel: {built}")
    res["hopper"], resumed = cards_train_agent(mesh, out_dir)
    for r in range(mesh.size):      # one profiler at a time
        if r == mesh.rank:
            res["busy"] = cards_busy_share(resumed, mesh)
        mesh.barrier()
    num_traj = -(-10 // mesh.size) * mesh.size
    out, counts, seconds = run_counted(
        lambda: m11_swimmer_ppo_iteration(mesh, num_traj))
    res["swimmer_ppo"] = {**out, "num_traj": num_traj,
                          "kernel_launches": counts,
                          "counted_seconds": seconds}
    res["ensemble"], res["ensemble_launches"], _ = run_counted(
        lambda: m11_ensemble(mesh))
    res["contact_check"] = m11_contact_launch_check(mesh)
    res["smooth_check"] = m11_smooth_launch_check(mesh)
    if scaling:
        res["scaling"] = cards_scaling(mesh)
    res["seconds"] = time.time() - t0
    mesh.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{res['rank']}.json"), "w") as f:
        json.dump(res, f)


def run_cards_ranks(tmp, world, backend, scaling):
    """torchrun starting ``world`` ranks of this script; it stops the other
    ranks when one fails, and this process stops it at the deadline ->
    every rank's results."""
    import signal
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={world}", os.path.abspath(__file__),
           "--cards-rank", "--cards-out", tmp, "--cards-backend", backend]
    if scaling:
        cmd.append("--cards-scaling")
    p = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        log = p.communicate(timeout=CARDS_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        log = p.communicate()[0]
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    if p.returncode != 0:
        print(log[-12000:], file=sys.stderr)
        raise AssertionError(f"torchrun of {world} ranks failed (rc "
                             f"{p.returncode}) or passed {CARDS_TIMEOUT_S} s")
    res = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res


def phase_m11_cards(kernel, contact, m11_refs):
    """M11 on every card of one host, through torchrun and
    parallel.distributed.initialize(): four ranks over NCCL, one per card,
    on a host of four cards or more, else two over gloo on the one card.
    Hopper-v3 NPG through train_agent (2 iterations, a resume for 1 more,
    3 uninterrupted), swimmer_ppo.json, a 4-member ensemble and each
    rank's K2 and K1 launches, against one rank in this process."""
    world, backend = cards_world()
    scaling = world == 4
    t_start = time.time()
    ens_ref = m11_ensemble()
    num_traj = -(-10 // world) * world
    ppo_ref = m11_swimmer_ppo_iteration(None, num_traj) \
        if num_traj != 10 else m11_refs["swimmer_ppo"]
    with tempfile.TemporaryDirectory() as tmp:
        one_dir, ranks_dir = os.path.join(tmp, "one"), \
            os.path.join(tmp, "ranks")
        os.makedirs(ranks_dir)
        # one rank on card 0: train_agent's first 2 iterations
        agent, record = hopper_npg_agent(21), []
        timed_steps(agent, None, record)
        with contextlib.redirect_stdout(sys.stderr):
            train_agent(os.path.join(one_dir, "job"), agent, niter=2,
                        seed=0, gamma=0.995, gae_lambda=0.97,
                        num_traj=NUM_ENVS, save_freq=1)
        one_files = job_files(os.path.join(one_dir, "job"))
        t0 = time.time()
        ranks = run_cards_ranks(ranks_dir, world, backend, scaling)
        ranks_s = time.time() - t0
    hopper_ref = record[0]
    for r in ranks:
        exp_dev = f"cuda:{r['rank'] if backend == 'nccl' else 0}"
        h = r["hopper"]
        for name, n in (("first", 2), ("resumed", 1), ("whole", 3)):
            if h[name]["kernel_launches"] != {CONTACT: n * HOPPER_HORIZON,
                                              SMOOTH: 0}:
                raise AssertionError(f"m11_cards: rank {r['rank']} {name} "
                                     f"launched {h[name]['kernel_launches']}")
        if r["device"] != exp_dev or h["resumed_policy_device"] != exp_dev \
                or h["resumed_baseline_device"] != exp_dev:
            raise AssertionError(f"m11_cards: rank {r['rank']} on "
                                 f"{r['device']}, its resumed policy on "
                                 f"{h['resumed_policy_device']}, expected "
                                 f"{exp_dev}")
        if h["files"] != one_files:
            raise AssertionError(f"m11_cards: the job directory holds "
                                 f"{h['files']}, one rank's {one_files}")
        if not all(h["resume_bitwise"].values()):
            raise AssertionError(f"m11_cards: rank {r['rank']}: the resumed "
                                 f"run against the uninterrupted "
                                 f"{h['resume_bitwise']}")
        if h["first"]["iterations"][0]["stats"] != hopper_ref["stats"]:
            raise AssertionError(
                f"m11_cards: rank {r['rank']} first iteration's statistics "
                f"{h['first']['iterations'][0]['stats']} against one rank's "
                f"{hopper_ref['stats']}")
        if r["contact_check"]["rows"] != NUM_ENVS // world \
                or r["smooth_check"]["rows"] != NUM_ENVS // world:
            raise AssertionError("m11_cards: the launch checks took "
                                 f"{r['contact_check']['rows']} / "
                                 f"{r['smooth_check']['rows']} rows")
        if r["swimmer_ppo"]["kernel_launches"] != {SMOOTH: HORIZON,
                                                   CONTACT: 0} \
                or r["ensemble_launches"] != NO_LAUNCHES:
            raise AssertionError(f"m11_cards: rank {r['rank']} launched "
                                 f"{r['swimmer_ppo']['kernel_launches']} / "
                                 f"{r['ensemble_launches']}")
    hopper_diffs = m11_compare(
        "first_iteration",
        [{"rank": r["rank"],
          "first_iteration": r["hopper"]["first"]["iterations"][0]}
         for r in ranks], hopper_ref)
    ppo_diffs = m11_compare("swimmer_ppo", ranks, ppo_ref)
    ens = {k: max(rel_diff(r["ensemble"][k], ens_ref[k]) for r in ranks)
           for k in ("losses", "params", "predict_all")}
    if not max(ens.values()) <= CARDS_ENSEMBLE_BOUND:
        raise AssertionError(f"m11_cards: ensemble against one rank {ens}")
    per_iter = lambda r, name: [it["seconds"] for it in
                                r["hopper"][name]["iterations"]]
    emit({"phase": "m11_cards", "launcher": "torchrun --standalone "
          f"--nproc-per-node {world}", "backend": backend, "world": world,
          "ran": f"{world} ranks over {backend}, "
          + ("one per card" if backend == "nccl" else "sharing the one card"),
          "rows_per_rank": NUM_ENVS // world,
          "hopper_diff_to_one_rank": hopper_diffs,
          "first_iteration_stats_equal": True,
          "resume_bitwise": [r["hopper"]["resume_bitwise"] for r in ranks],
          "job_files": one_files,
          "devices": [r["device"] for r in ranks],
          "resumed_policy_devices": [r["hopper"]["resumed_policy_device"]
                                     for r in ranks],
          "swimmer_ppo_num_traj": num_traj, "swimmer_ppo_diff": ppo_diffs,
          "ensemble_max_rel_diff": ens, "ensemble_bound":
              CARDS_ENSEMBLE_BOUND,
          "k2_against_plain": [r["contact_check"] for r in ranks],
          "k1_against_plain": [r["smooth_check"] for r in ranks],
          "bounds": {"stats": "equal", "params": M11_PARAMS_BOUND,
                     "update_rtol": M11_UPDATE_RTOL}})
    emit({"phase": "m11_cards_numbers",
          "note": "per rank; not limits",
          "one_rank_seconds_per_iteration": [it["seconds"]
                                             for it in record],
          "seconds_per_iteration": {
              name: [per_iter(r, name) for r in ranks]
              for name in ("first", "resumed", "whole")},
          "kernel_launches": {
              "hopper_train_agent": [
                  {k: sum(r["hopper"][n]["kernel_launches"][k]
                          for n in ("first", "resumed", "whole"))
                   for k in (SMOOTH, CONTACT)} for r in ranks],
              "swimmer_ppo": [r["swimmer_ppo"]["kernel_launches"]
                              for r in ranks]},
          "collectives_per_iteration": [
              [it["collectives"] for it in r["hopper"]["whole"]
               ["iterations"]] for r in ranks],
          "swimmer_ppo_seconds": [r["swimmer_ppo"]["seconds"]
                                  for r in ranks],
          "swimmer_ppo_seconds_one_rank": ppo_ref["seconds"],
          "swimmer_ppo_collectives": [r["swimmer_ppo"]["collectives"]
                                      for r in ranks],
          "busy": [r["busy"] for r in ranks],
          "rank_process_seconds": [r["seconds"] for r in ranks],
          "torchrun_seconds": ranks_s})
    if scaling:
        emit({"phase": "m11_cards_scaling", "rows_per_card": NUM_ENVS,
              "runs": ranks[0]["scaling"],
              "by_rank": [r.get("scaling") for r in ranks]})
    else:
        emit({"phase": "m11_cards_scaling", "measured": False,
              "reason": f"{torch.cuda.device_count()} card(s): scaling over "
              "cards needs four"})
    launches = {
        "m11_cards_hopper": [
            {k: sum(r["hopper"][n]["kernel_launches"][k]
                    for n in ("first", "resumed", "whole"))
             for k in (SMOOTH, CONTACT)} for r in ranks],
        "m11_cards_swimmer_ppo": [r["swimmer_ppo"]["kernel_launches"]
                                  for r in ranks],
        "m11_cards_ensemble": [r["ensemble_launches"] for r in ranks]}
    for name, per_rank in launches.items():
        kernel["launches_by_path"][name] = [c[SMOOTH] for c in per_rank]
        contact["launches_by_path"][name] = [c[CONTACT] for c in per_rank]
    emit({"phase": "m11_cards_block", "seconds": time.time() - t_start})


def phase_hopper_jax_policy_card(contact, every=100):
    """The JAX package's trained Hopper-v3 policy on the card: 100 x 1000
    paths stochastic and in eval_mode (K2), held against the JAX package's
    CPU evaluation stored with the policy (4 combined standard errors).
    Every ``every``-th launch of K2 on this path keeps its inputs and
    outputs, and is held against the plain step on those inputs at the
    float32 bounds of the kernels phase; the worst error joins
    ``contact``'s ``max_abs_err``."""
    from mjrl_tpu_torch.envs import base as env_base
    transplant = example_module("torch_hopper_transplant", TOOLS)
    launched = env_base.cuda_step_n_batched
    calls, n_calls = [], [0]

    def kept(p, q, v, u, n, lanes=None):
        gq, gv = launched(p, q, v, u, n, lanes=lanes)
        if n_calls[0] % every == 0:
            calls.append((p, n, q.clone(), v.clone(), u.clone(), gq.clone(),
                          gv.clone()))
        n_calls[0] += 1
        return gq, gv

    env_base.cuda_step_n_batched = kept
    try:
        out, counts, seconds = run_counted(lambda: transplant.evaluate(
            transplant.GOLDEN, "cuda", ntraj=100, horizon=HOPPER_HORIZON))
    finally:
        env_base.cuda_step_n_batched = launched
    if counts != {CONTACT: 2 * HOPPER_HORIZON, SMOOTH: 0}:
        raise AssertionError(f"hopper_jax_policy_card: launched {counts}")
    t0 = time.time()
    tol_q, tol_v = CONTACT_TOL[torch.float32]
    err_q = err_v = 0.0
    for p, n, q, v, u, gq, gv in calls:
        if q.shape[0] != 100 or q.dtype != torch.float32:
            raise AssertionError(f"hopper_jax_policy_card: K2 given "
                                 f"{tuple(q.shape)} {q.dtype}")
        rq, rv = step_n_arrays(p, q, v, u, n)
        torch.testing.assert_close(gq, rq, rtol=tol_q, atol=tol_q)
        torch.testing.assert_close(
            gv, rv, rtol=tol_v, atol=tol_v * max(1.0, rv.abs().max().item()))
        err_q = max(err_q, (gq - rq).abs().max().item())
        err_v = max(err_v, (gv - rv).abs().max().item())
    check = {"path": "hopper_jax_policy_card", "B": 100,
             "launches_checked": len(calls), "every": every,
             "max_abs_err_q": err_q, "max_abs_err_v": err_v,
             "tolerance": [tol_q, tol_v], "seconds": time.time() - t0}
    if len(calls) != 2 * HOPPER_HORIZON // every:
        raise AssertionError(f"hopper_jax_policy_card: kept {len(calls)}")
    contact["max_abs_err"] = max(contact["max_abs_err"], err_q, err_v)
    contact["checks"].append(check)
    line = {"phase": "hopper_jax_policy_card", "ntraj": 100,
            "horizon": HOPPER_HORIZON, "seconds": seconds,
            "kernel_launches": counts, "max_z": transplant.MAX_Z,
            "k2_check": check}
    for mode in ("stoch", "eval"):
        line[mode] = {k: out[mode][k] for k in ("port", "jax", "z",
                                                "seconds")}
    emit(line)
    if not abs(out["stoch"]["z"]) <= transplant.MAX_Z:
        raise AssertionError(
            f"hopper_jax_policy_card: the port's mean return "
            f"{out['stoch']['port']['mean']} lies {out['stoch']['z']} "
            f"combined standard errors from the JAX package's "
            f"{out['stoch']['jax']['mean']}")
    return counts


def phase_train_gym_hopper():
    """tools/torch_train_gym.py's main on the card: bench_hopper's agent,
    100 x 1000, 3 iterations; every row key of the JAX tool, finite."""
    import io
    gym = example_module("torch_train_gym", TOOLS)
    buf = io.StringIO()
    argv = ["--env", "Hopper-v3", "--ntraj", "100", "--iters", str(NITER),
            "--step_size", "0.1"]
    with contextlib.redirect_stdout(buf):
        (agent, rows, summary), counts, seconds = run_counted(
            lambda: gym.main(argv))
    if counts != {CONTACT: NITER * HOPPER_HORIZON, SMOOTH: 0}:
        raise AssertionError(f"train_gym_hopper: launched {counts}")
    keys = {"iter", "mean_return", "elapsed_s", "log_std", "ep_len",
            *gym.ROW_KEYS}
    printed = [json.loads(x) for x in buf.getvalue().splitlines()]
    if printed[:NITER] != rows or len(rows) != NITER:
        raise AssertionError(f"train_gym_hopper: printed {printed}")
    for row in rows:
        if set(row) != keys or not all(np.isfinite(v)
                                       for v in row.values()):
            raise AssertionError(f"train_gym_hopper: row {row}")
    if agent.device.type != "cuda":
        raise AssertionError(f"train_gym_hopper: ran on {agent.device}")
    log = agent.logger.log
    emit({"phase": "train_gym_hopper", "argv": argv, "seconds": seconds,
          "kernel_launches": counts, "rows": rows, "summary": summary,
          "time_sampling": log["time_sampling"], "time_npg": log["time_npg"],
          "time_VF": log["time_VF"]})
    return counts


def main():
    t_start = time.time()
    phase = "device"
    try:
        smi = phase_device()
        torch.backends.cuda.matmul.allow_tf32 = False
        p = SwimmerEnv()._planar
        contact_envs = {"hopper": HopperEnv(), "walker2d": Walker2dEnv(),
                        "half_cheetah": HalfCheetahEnv()}
        phase = "build"
        ptxas = phase_build({"swimmer": p, **{k: e._planar
                                              for k, e in contact_envs.items()}})
        phase = "kernels"
        kernel = phase_kernels(p, smi, ptxas["swimmer"])
        contact = phase_kernels_contact(
            contact_envs, smi, {k: ptxas[k] for k in contact_envs})
        phase = "fvp_kernel"
        phase_fvp_kernel(smi)
        phase = "rollout"
        phase_rollout(kernel["ms"])
        phase = "train"
        kernel["launches"] = phase_train("mjrl_swimmer-v0", 0.1, HORIZON,
                                         SMOOTH, "train")
        phase = "rollout_hopper"
        valid_per_s = phase_rollout_hopper(contact["ms"])
        phase = "train_hopper"
        contact["launches"] = phase_train("Hopper-v3", 0.05, HOPPER_HORIZON,
                                          CONTACT, "train_hopper")
        # the later slices' paths, each counted on its own
        kernel["launches_by_path"] = {"train": kernel["launches"]}
        contact["launches_by_path"] = {"train_hopper": contact["launches"]}
        phase = "train_job_hopper_npg"
        contact["launches_by_path"][phase] = phase_train_job_hopper_npg()
        phase = "train_job_swimmer_ppo"
        expert, kernel["launches_by_path"][phase] = \
            phase_train_job_swimmer_ppo()
        phase = "train_hopper_trpo"
        contact["launches_by_path"][phase] = phase_train_hopper_trpo(
            valid_per_s)
        phase = "bc_swimmer"
        kernel["launches_by_path"][phase] = phase_bc_swimmer(expert.policy)
        phase = "autoreset_card"
        contact["launches_by_path"][phase] = phase_autoreset_card()
        # the general engine's paths: each launches neither kernel
        phase_seconds = {}
        for phase, fn in (
                ("rollout_point_mass", phase_rollout_point_mass),
                ("rollout_reacher", phase_rollout_reacher),
                ("rollout_inverted_pendulum",
                 phase_rollout_inverted_pendulum),
                ("train_job_point_mass_npg",
                 phase_train_job_point_mass_npg)):
            t0 = time.time()
            counts = fn()
            phase_seconds[phase] = time.time() - t0
            kernel["launches_by_path"][phase] = counts[SMOOTH]
            contact["launches_by_path"][phase] = counts[CONTACT]
        emit({"phase": "general_engine", "phase_seconds": phase_seconds,
              "seconds": sum(phase_seconds.values())})
        # M10: the model-based branch, DAPG and MPC
        phase_seconds = {}
        for phase, fn in (
                ("train_model_accel_point_mass",
                 lambda: phase_train_model_accel("point_mass", 2, 2)),
                ("train_model_accel_reacher",
                 lambda: phase_train_model_accel("reacher", 1, 1)),
                ("dapg_point_mass", phase_dapg_point_mass),
                ("mbac_point_mass", phase_mbac_point_mass),
                ("mpc_actor_swimmer",
                 lambda: phase_mpc_actor_swimmer(kernel)),
                ("learned_mpc_point_mass", phase_learned_mpc_point_mass)):
            t0 = time.time()
            counts = fn()
            phase_seconds[phase] = time.time() - t0
            kernel["launches_by_path"][phase] = counts[SMOOTH]
            contact["launches_by_path"][phase] = counts[CONTACT]
        phase = "m10_card_vs_cpu"
        t0 = time.time()
        m10_card_vs_cpu()
        phase_seconds[phase] = time.time() - t0
        emit({"phase": "m10", "phase_seconds": phase_seconds,
              "seconds": sum(phase_seconds.values())})
        # M9a: the contact half of the general engine
        phase_seconds = {}
        for phase, fn in (
                ("rollout_peg", phase_rollout_peg),
                ("train_peg_npg", phase_train_peg_npg),
                ("train_ant_npg", phase_train_ant_npg),
                ("rollout_humanoid", phase_rollout_humanoid),
                ("contact_card_vs_cpu", phase_contact_card_vs_cpu)):
            t0 = time.time()
            counts = fn()
            phase_seconds[phase] = time.time() - t0
            kernel["launches_by_path"][phase] = counts[SMOOTH]
            contact["launches_by_path"][phase] = counts[CONTACT]
        emit({"phase": "m9a", "phase_seconds": phase_seconds,
              "seconds": sum(phase_seconds.values())})
        # M9b: the rest of the general engine and the Adroit hand
        phase_seconds = {}
        for phase, fn in (
                ("m9b_card_vs_cpu", phase_m9b_card_vs_cpu),
                ("relocate_card_vs_cpu", phase_relocate_card_vs_cpu),
                ("rollout_relocate", phase_rollout_relocate),
                ("dapg_relocate", phase_dapg_relocate)):
            t0 = time.time()
            counts = fn()
            phase_seconds[phase] = time.time() - t0
            kernel["launches_by_path"][phase] = counts[SMOOTH]
            contact["launches_by_path"][phase] = counts[CONTACT]
        emit({"phase": "m9b", "phase_seconds": phase_seconds,
              "seconds": sum(phase_seconds.values())})
        # M12: the host utilities around the training loop
        phase_seconds = {}
        for phase, fn in (
                ("native_paths_hopper", phase_native_paths_hopper),
                ("checkpoint_resume_hopper", phase_checkpoint_resume_hopper),
                ("sweep_swimmer_ppo", phase_sweep_swimmer_ppo),
                ("visualize_swimmer",
                 lambda: phase_visualize("mjrl_swimmer-v0", SMOOTH,
                                         "visualize_swimmer")),
                ("visualize_hopper", phase_visualize_hopper),
                ("mjcf_env_card", phase_mjcf_env_card),
                ("external_env_card", phase_external_env_card),
                ("profile_swimmer", phase_profile_swimmer),
                ("fit_data_card", phase_fit_data_card),
                ("examples_m12", phase_examples_m12)):
            t0 = time.time()
            counts = fn()
            phase_seconds[phase] = time.time() - t0
            kernel["launches_by_path"][phase] = counts[SMOOTH]
            contact["launches_by_path"][phase] = counts[CONTACT]
        emit({"phase": "m12", "phase_seconds": phase_seconds,
              "seconds": sum(phase_seconds.values())})
        # M11: data parallelism over ranks
        phase = "m11"
        m11_refs = phase_m11(kernel, contact)
        # M11 on every card of one host, through torchrun
        phase = "m11_cards"
        phase_m11_cards(kernel, contact, m11_refs)
        # the learning path: a JAX-package policy and the learning CLI
        phase_seconds = {}
        for phase, fn in (
                ("hopper_jax_policy_card",
                 lambda: phase_hopper_jax_policy_card(contact)),
                ("train_gym_hopper", phase_train_gym_hopper)):
            t0 = time.time()
            counts = fn()
            phase_seconds[phase] = time.time() - t0
            kernel["launches_by_path"][phase] = counts[SMOOTH]
            contact["launches_by_path"][phase] = counts[CONTACT]
        emit({"phase": "learning", "phase_seconds": phase_seconds,
              "seconds": sum(phase_seconds.values())})
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' failed", file=sys.stderr)
        sys.exit(1)
    emit({"phase": "done", "seconds": time.time() - t_start})
    emit({"kernels": [kernel, contact]})
    print(smi, flush=True)
    emit({"ok": True,
          "device": {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if "--cards-rank" in sys.argv:         # one rank of m11_cards (torchrun)
        import argparse
        ap = argparse.ArgumentParser()
        ap.add_argument("--cards-rank", action="store_true")
        ap.add_argument("--cards-out", required=True)
        ap.add_argument("--cards-backend", choices=("gloo", "nccl"),
                        required=True)
        ap.add_argument("--cards-scaling", action="store_true")
        args = ap.parse_args()
        cards_worker(args.cards_out, args.cards_backend, args.cards_scaling)
    elif "--m11-rank" in sys.argv:         # one rank of the M11 phases
        import argparse
        ap = argparse.ArgumentParser()
        for name, typ in (("--m11-rank", int), ("--m11-world", int),
                          ("--m11-init", str), ("--m11-out", str)):
            ap.add_argument(name, type=typ, required=True)
        args = ap.parse_args()
        m11_worker(args.m11_rank, args.m11_world, args.m11_init,
                   args.m11_out)
    else:
        main()
