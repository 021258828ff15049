"""A whole sharded ``train_step`` on two gloo ranks (CPU, float64).

NPG with a LinearBaseline on the point mass (the general engine, the
success rate logged) and on Hopper-v3 (contacts, early termination; the
plain version of the contact kernel), built through GymEnv -> MLP ->
LinearBaseline -> NPG(..., mesh=make_mesh()) as a user builds them, each
taking 2 iterations whose resets and action noise are drawn from the
agent's generator (nothing injected).  Against the one-rank port run from
the same seed, on both ranks:

- exactly: the generator's state after both iterations, the sample counts,
  and the first iteration's statistics (its rollout is the one-rank
  rollout row for row), so every draw stays in lockstep with one rank's;
- at 1e-10, the statistics, the logged values and the policy and baseline
  parameters of both iterations, with the Fisher damping at 1.0 (a
  well-conditioned CG solve);
- at the default damping 1e-4, Hopper at the JAX package's own bounds for
  a sharded against an unsharded step (``tests/test_parallel.py``:
  statistics rtol 1e-3 / atol 1e-3, parameters rtol 1e-2 / atol 1e-3):
  there ten CG iterations amplify the roundoff of the reordered sums (one
  part in 1e16) to about 1e-4 relative in the step size.

The witness that this drift is roundoff and not a sharding fault (which
would show at damping 1.0 too): the one-rank run with every rollout's rows
reversed (each sum reordered, the arithmetic otherwise the same) drifts at
damping 1e-4 by as much as the two ranks do.  In the first iteration the policy gradient and the baseline fit (reordered
sums, no CG solve) agree to 1e-10 in both, and the CG direction is the
first quantity to drift.

Four ranks (2 rows each) take the Hopper run's two steps and equal one
rank as two do.

``train_agent`` on the two ranks (the point mass with its horizon cut to
5, an MLPBaseline, evaluation rollouts, ``save_freq`` 1): 2 iterations,
then a resume for 1 more, against 3 uninterrupted iterations on the ranks
and the same runs on one rank: one job directory holding the files one
rank leaves, the resumed run equal to the uninterrupted one bit for bit on
every rank, and an agent that pickles under the mesh without it.

The ranks import this file, which imports no JAX.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from mjrl_tpu_torch.algos import NPG
from mjrl_tpu_torch.baselines import LinearBaseline, MLPBaseline
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.models.policies import MLP
from mjrl_tpu_torch.parallel import make_mesh
from mjrl_tpu_torch.utils.train_agent import train_agent

from test_torch_parallel_mesh import (init_ranks, join_ranks, load_ranks,
                                      spawn_ranks)

TOL = 1e-10
JAX_STATS, JAX_PARAMS = (1e-3, 1e-3), (1e-2, 1e-3)   # (rtol, atol)
RUNS = {"point_mass": ("mjrl_point_mass-v0", 8, 10, 1.0),
        "hopper": ("Hopper-v3", 8, 5, 1.0),
        "hopper_default_damping": ("Hopper-v3", 8, 5, 1e-4)}
LOGGED = ("stoc_pol_mean", "stoc_pol_std", "stoc_pol_min", "stoc_pol_max",
          "running_score", "num_samples", "alpha", "delta", "kl_dist",
          "surr_improvement", "VF_error_before", "VF_error_after")


def reverse_rows(agent, n):
    """Hand the agent each rollout with its ``n`` rows in reverse order."""
    phases = agent._get_phases

    def reversed_phases(*args, **kwargs):
        rollout_fn, *rest = phases(*args, **kwargs)

        def rollout_reversed(*a, **kw):
            return {k: torch.flip(v, (0,)) if torch.is_tensor(v)
                    and v.ndim and v.shape[0] == n else v
                    for k, v in rollout_fn(*a, **kw).items()}
        return (rollout_reversed, *rest)
    agent._get_phases = reversed_phases


def record_directions(agent):
    """Keep every update's policy gradient and NPG direction (flattened)."""
    core, seen = agent._update_core, {"vpg_grad": [], "npg_grad": []}

    def recording_core(*args, **kwargs):
        new_params, stats = core(*args, **kwargs)
        for k in seen:
            seen[k].append(torch.cat([v.reshape(-1)
                                      for v in stats[k].values()]))
        return new_params, stats
    agent._update_core = recording_core
    return seen


def train(mesh, runs=tuple(RUNS), reverse=False):
    """``runs`` of RUNS: 2 NPG iterations on ``mesh`` (None: one rank),
    each rollout's rows reversed if ``reverse``; ``vpg_grad_1`` and
    ``npg_grad_1`` are the first update's gradient and CG direction."""
    out = {}
    for name in runs:
        env_id, n, horizon, damping = RUNS[name]
        e = GymEnv(env_id, device="cpu",
                   env_kwargs={"dtype": torch.float64})
        policy = MLP(e.spec, hidden_sizes=(8, 8), seed=3,
                     dtype=torch.float64, device="cpu")
        agent = NPG(e, policy, LinearBaseline(e.spec, dtype=torch.float64,
                                              device="cpu"),
                    normalized_step_size=0.05, seed=5, save_logs=True,
                    FIM_invert_args={"iters": 10, "damping": damping},
                    device="cpu", mesh=mesh)
        if reverse:
            reverse_rows(agent, n)
        seen = record_directions(agent)
        stats = [agent.train_step(n, horizon=horizon, gamma=0.995,
                                  gae_lambda=0.97) for _ in range(2)]
        log = agent.logger.log
        out[name] = {
            "stats": torch.tensor(stats, dtype=torch.float64),
            **policy.params, "baseline": agent.baseline.state,
            "generator": agent.generator.get_state().double(),
            **{f"{k}_1": v[0] for k, v in seen.items()},
            **{k: torch.tensor(log[k], dtype=torch.float64)
               for k in LOGGED + ("success_rate",) if k in log}}
    return out


def job_agent(mesh):
    """NPG on the point mass (horizon cut to 5) with an MLPBaseline."""
    e = GymEnv("mjrl_point_mass-v0", device="cpu",
               env_kwargs={"dtype": torch.float64})
    e.env.horizon = 5
    policy = MLP(e.spec, hidden_sizes=(8, 8), seed=3, dtype=torch.float64,
                 device="cpu")
    baseline = MLPBaseline(e.spec, batch_size=8, epochs=1,
                           dtype=torch.float64, device="cpu")
    return NPG(e, policy, baseline, normalized_step_size=0.05, seed=5,
               save_logs=True, FIM_invert_args={"iters": 10, "damping": 1.0},
               device="cpu", mesh=mesh)


def job_files(job):
    return sorted(os.path.relpath(os.path.join(d, f), job)
                  for d, _, fs in os.walk(job) for f in fs)


def agent_state(agent):
    return {**agent.policy.params, "baseline": torch.cat(
                [v.reshape(-1) for v in agent.baseline.state[0].values()]),
            "generator": agent.generator.get_state().double(),
            "baseline_generator":
                agent.baseline.generator.get_state().double(),
            "policy_generator": agent.policy.generator.get_state().double(),
            "stats": torch.tensor([agent.logger.log[k][-1] for k in LOGGED
                                   if k in agent.logger.log])}


def train_jobs(mesh, root):
    """train_agent: 2 iterations, a resume for 1 more, and 3 uninterrupted
    iterations, each job under ``root``."""
    kw = dict(seed=0, gamma=0.995, gae_lambda=0.97, num_traj=8,
              save_freq=1, evaluation_rollouts=2)
    resumed, whole = os.path.join(root, "resumed"), \
        os.path.join(root, "whole")
    first = train_agent(resumed, job_agent(mesh), niter=2, **kw)
    files = job_files(resumed)
    again = job_agent(mesh)
    train_agent(resumed, again, niter=3, **kw)
    uninterrupted = train_agent(whole, job_agent(mesh), niter=3, **kw)
    copy = pickle.loads(pickle.dumps(uninterrupted))
    with open(os.path.join(resumed, "results.txt")) as f:
        results = f.read()
    return {"first": agent_state(first), "resumed": agent_state(again),
            "whole": agent_state(uninterrupted),
            "files": files, "files_after_resume": job_files(resumed),
            "results": results, "pickled_mesh": copy.mesh,
            "policy_device": str(again.policy.device)}


def train_worker(rank, world, init_method, out_dir):
    init_ranks(rank, world, init_method)
    mesh = make_mesh(device="cpu")
    out = train(mesh)
    out["collectives"] = {"count": torch.tensor(mesh.collectives)}
    out["jobs"] = train_jobs(mesh, os.path.join(out_dir, "jobs"))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_ranks")
    out4 = tmp_path_factory.mktemp("train_4_ranks")
    procs = spawn_ranks("test_torch_parallel_train", "train_worker", out)
    procs4 = spawn_ranks("test_torch_parallel_train", "train4_worker", out4,
                         world=4)
    one = train(None)
    one["reversed"] = train(None, ("hopper_default_damping",), reverse=True)
    one["jobs"] = train_jobs(None, str(tmp_path_factory.mktemp("one_job")))
    join_ranks(procs)
    join_ranks(procs4)
    return one, [torch.load(os.path.join(str(out), f"rank{r}.pt"),
                            weights_only=False) for r in range(2)], \
        load_ranks(out4, world=4)


def train4_worker(rank, world, init_method, out_dir):
    init_ranks(rank, world, init_method)
    torch.save(train(make_mesh(device="cpu"), ("hopper",)),
               os.path.join(out_dir, f"rank{rank}.pt"))


def rel(a, b):
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def drift(run, ref):
    """The largest relative difference of the policy's parameters and of
    alpha, over both iterations."""
    return max(rel(run[k], ref[k]) for k in ref
               if k.startswith("layers.") or k in ("log_std", "alpha"))


def close(a, b, rtol, atol=None):
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol,
                               atol=rtol if atol is None else atol)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_draws_stay_in_lockstep_with_one_rank(results, name):
    one, ranks, _ = results
    for r in ranks:
        for k in ("generator", "num_samples"):
            close(r[name][k], one[name][k], 0.0)
        close(r[name]["stats"][0], one[name]["stats"][0], 0.0)


def test_four_rank_train_steps_equal_one_rank(results):
    one, _, ranks4 = results
    one = one["hopper"]
    for r in ranks4:
        assert set(r["hopper"]) == set(one)
        for k in ("generator", "num_samples"):
            close(r["hopper"][k], one[k], 0.0)
        close(r["hopper"]["stats"][0], one["stats"][0], 0.0)
        for k, v in one.items():
            close(r["hopper"][k], v, TOL)
            close(r["hopper"][k], ranks4[0]["hopper"][k], 0.0)


@pytest.mark.parametrize("name", ["point_mass", "hopper"])
def test_two_rank_train_steps_equal_one_rank(results, name):
    one, ranks, _ = results
    assert set(ranks[0][name]) == set(one[name])
    for k, v in one[name].items():
        close(ranks[0][name][k], v, TOL)
        close(ranks[1][name][k], ranks[0][name][k], 0.0)


def test_default_damping_within_the_jax_bounds(results):
    one, ranks, _ = results
    name = "hopper_default_damping"
    for k, v in one[name].items():
        bounds = JAX_PARAMS if k.startswith("layers.") or k in (
            "log_std", "baseline") else JAX_STATS
        close(ranks[0][name][k], v, *bounds)
        close(ranks[1][name][k], ranks[0][name][k], 0.0)


def test_reordered_rows_alone_drift_as_far_at_default_damping(results):
    one, ranks, _ = results
    rev = one["reversed"]
    name = "hopper_default_damping"
    by_order, by_ranks = drift(rev[name], one[name]), \
        drift(ranks[0][name], one[name])
    # the same order: reorderings alone spread over a few times each other,
    # where a dropped Fisher all-reduce would move alpha by tens of per cent
    assert by_order > 1e3 * TOL
    assert by_ranks <= 30 * by_order, (by_ranks, by_order)
    # the first iteration's gradient and baseline fit (reordered sums, no
    # CG solve) agree; the CG direction is the first quantity to drift
    for run in (rev[name], ranks[0][name]):
        close(run["vpg_grad_1"], one[name]["vpg_grad_1"], TOL)
        for k in ("VF_error_before", "VF_error_after"):
            close(run[k][:1], one[name][k][:1], TOL)
        assert rel(run["npg_grad_1"], one[name]["npg_grad_1"]) > 1e3 * TOL


def test_the_runs_do_real_work(results):
    """The point mass logs its success rate, the policy moved, and the
    ranks issued collectives."""
    one, ranks, _ = results
    hop = one["hopper"]
    assert "success_rate" in one["point_mass"]
    assert bool(torch.isfinite(hop["stats"]).all())
    assert float(hop["kl_dist"].min()) > 0
    assert int(ranks[0]["collectives"]["count"]) > 40


def test_train_agent_on_two_ranks_leaves_one_ranks_job(results):
    """Rank 0 alone writes: one job directory with the files one rank
    leaves, its results.txt the same; every rank resumed onto its device
    and the agent pickles without its mesh."""
    one, ranks, _ = results
    assert ranks[0]["jobs"]["files"] == one["jobs"]["files"]
    assert "iterations/checkpoint_1.pickle" in one["jobs"]["files"]
    assert ranks[0]["jobs"]["files_after_resume"] == \
        one["jobs"]["files_after_resume"]
    for r in ranks:
        assert r["jobs"]["results"] == one["jobs"]["results"]
        assert r["jobs"]["pickled_mesh"] is None
        assert r["jobs"]["policy_device"] == "cpu"


@pytest.mark.parametrize("run", ["first", "resumed", "whole"])
def test_train_agent_on_two_ranks_equals_one_rank(results, run):
    one, ranks, _ = results
    for k, v in one["jobs"][run].items():
        tol = 0.0 if "generator" in k else TOL
        close(ranks[0]["jobs"][run][k], v, tol)
        close(ranks[1]["jobs"][run][k], ranks[0]["jobs"][run][k], 0.0)


def test_train_agent_resume_equals_the_uninterrupted_run(results):
    """On one rank and on every rank of two, bit for bit."""
    one, ranks, _ = results
    for res in [one] + ranks:
        for k, v in res["jobs"]["whole"].items():
            close(res["jobs"]["resumed"][k], v, 0.0)
