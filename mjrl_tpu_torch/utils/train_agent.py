"""Training loop (counterpart of ``mjrl_tpu/utils/train_agent.py``).

Parity:
- same signature and per-iteration flow: best-policy tracking ->
  ``agent.train_step`` -> optional evaluation rollouts + success metric ->
  periodic checkpointing + plots -> console table + results.txt
  (train_agent.py:62-148);
- resume: scans logs/log.csv for the newest saved iteration, restores
  policy/baseline, truncates the logger, continues (train_agent.py:15-60).

Improvements over the reference (capability, not bug, parity):
- never mutates the process CWD (reference does os.chdir,
  train_agent.py:80) — all outputs live under ``job_name``;
- checkpoints include the agent's generator state and optimizer state
  (``checkpoint_<i>.pickle``), which the reference acknowledges losing
  (train_agent.py:89-90);
- pickles hold CPU tensors whatever device the agent trains on, and a
  resume loads them onto the agent's device.

Under a mesh of R ranks (``agent.mesh``, ``parallel/``) every rank runs
the same iterations and takes the same decisions (the statistics are
all-reduced, the evaluation rollouts replicated from generators alike;
each iteration checks that the ranks agree); rank 0 alone creates the job
directory and writes logs, pickles, ``results.txt`` and plots, so R ranks
leave the files one rank leaves.  Every rank waits at a barrier after the
resume's reads and after each save, and a resume puts each rank's policy
on its own card.
"""

import copy
import os
import pickle

import numpy as np

from mjrl_tpu_torch.device import load_pickle, set_generator_state
from mjrl_tpu_torch.ops.flat import tree_to
from mjrl_tpu_torch.samplers.rollout import sample_paths
from mjrl_tpu_torch.utils.make_train_plots import make_train_plots


def _load_latest_policy_and_logs(agent, policy_dir, logs_dir, device):
    """-> next iteration number to run (0 if nothing to resume); the
    policy, baseline and optimizer state are loaded onto ``device``."""
    log_csv_path = os.path.join(logs_dir, "log.csv")
    if not (os.path.exists(log_csv_path) and os.path.isdir(policy_dir)):
        return 0
    data = agent.logger.read_log(log_csv_path)
    if agent.logger.max_len == 0:
        return 0
    last_step = agent.logger.max_len
    for i in range(last_step - 1, -1, -1):
        policy_path = os.path.join(policy_dir, f"policy_{i}.pickle")
        baseline_path = os.path.join(policy_dir, f"baseline_{i}.pickle")
        ckpt_path = os.path.join(policy_dir, f"checkpoint_{i}.pickle")
        if not os.path.isfile(policy_path):
            continue
        agent.policy = load_pickle(policy_path, device)
        if os.path.isfile(baseline_path):
            agent.baseline = load_pickle(baseline_path, device)
        if os.path.isfile(ckpt_path):
            extra = load_pickle(ckpt_path, device)
            if "rng_state" in extra:
                set_generator_state(agent.generator, extra["rng_state"])
            agent.running_score = extra.get("running_score",
                                            agent.running_score)
            if "opt_state" in extra and hasattr(agent, "opt_state"):
                agent.opt_state = tree_to(extra["opt_state"], device)
        agent.logger.shrink_to(i + 1)
        return i + 1
    return 0


def train_agent(job_name, agent,
                seed=0,
                niter=101,
                gamma=0.995,
                gae_lambda=None,
                num_cpu=1,
                sample_mode="trajectories",
                num_traj=50,
                num_samples=50000,
                save_freq=10,
                evaluation_rollouts=None,
                plot_keys=["stoc_pol_mean"],
                env_kwargs=None,
                ):
    np.random.seed(seed)
    mesh = getattr(agent, "mesh", None)
    root = mesh is None or mesh.rank == 0
    iter_dir = os.path.join(job_name, "iterations")
    logs_dir = os.path.join(job_name, "logs")
    if root:
        if os.path.isdir(job_name):
            print(f"Job directory {job_name} already exists — continuing.")
        os.makedirs(iter_dir, exist_ok=True)
        if agent.save_logs:
            os.makedirs(logs_dir, exist_ok=True)

    if sample_mode not in ("trajectories", "samples"):
        raise ValueError("sample_mode must be 'trajectories' or 'samples'")
    N = num_traj if sample_mode == "trajectories" else num_samples

    best_policy = copy.deepcopy(agent.policy)
    best_perf = -1e8
    train_curve = best_perf * np.ones(niter)
    mean_pol_perf = 0.0

    fenv = agent.fenv

    # a resume loads each rank's copy onto its own card
    device = agent.device if mesh is None else mesh.device
    i_start = _load_latest_policy_and_logs(agent, iter_dir, logs_dir,
                                           device) if agent.save_logs else 0
    if mesh is not None:
        mesh.check_same("the iteration to resume from", [i_start])
        mesh.barrier()          # every rank has read before rank 0 writes
    if i_start and root:
        print(f"Resuming from iteration {i_start}")

    for i in range(i_start, niter):
        if root:
            print("......................................................")
            print(f"ITERATION : {i}")

        if train_curve[i - 1] > best_perf:
            best_policy = copy.deepcopy(agent.policy)
            best_perf = train_curve[i - 1]

        stats = agent.train_step(N=N, sample_mode=sample_mode,
                                 gamma=gamma, gae_lambda=gae_lambda,
                                 num_cpu=num_cpu, env_kwargs=env_kwargs)
        train_curve[i] = stats[0]

        if evaluation_rollouts is not None and evaluation_rollouts > 0:
            if root:
                print("Performing evaluation rollouts ........")
            eval_paths = sample_paths(
                num_traj=evaluation_rollouts, env=fenv, policy=agent.policy,
                eval_mode=True, base_seed=seed,
                generator=agent.generator)
            mean_pol_perf = float(np.mean([np.sum(p["rewards"])
                                           for p in eval_paths]))
            if agent.save_logs:
                agent.logger.log_kv("eval_score", mean_pol_perf)
                # only absence of the capability is benign (not every env
                # defines success); real evaluate_success failures raise
                if hasattr(fenv, "evaluate_success"):
                    eval_success = fenv.evaluate_success(eval_paths)
                    agent.logger.log_kv("eval_success", eval_success)

        if mesh is not None:
            mesh.check_same(f"iteration {i}'s scores",
                            [train_curve[i], mean_pol_perf, best_perf])
        if i % save_freq == 0 and i > 0:
            _save(agent, best_policy, job_name, i, plot_keys, root, mesh)

        if root:
            print_data = sorted(
                filter(lambda v: np.asarray(v[1]).size == 1,
                       agent.logger.get_current_log().items())) \
                if agent.save_logs else []
            _print_table(job_name, i, train_curve[i], mean_pol_perf,
                         best_perf, print_data)

    _save(agent, best_policy, job_name, "final", plot_keys, root, mesh)
    return agent


def _save(agent, best_policy, job_name, tag, plot_keys, root, mesh):
    """Rank 0 writes the logs, plots and pickles of iteration ``tag``;
    every rank then waits at a barrier, so a later read finds them
    whole."""
    if root:
        logs_dir = os.path.join(job_name, "logs")
        if agent.save_logs:
            agent.logger.save_log(logs_dir)
            make_train_plots(log=agent.logger.log, keys=plot_keys,
                             save_loc=logs_dir)
        _save_checkpoint(agent, best_policy,
                         os.path.join(job_name, "iterations"), tag)
    if mesh is not None:
        mesh.barrier()


def _save_checkpoint(agent, best_policy, iter_dir, tag):
    with open(os.path.join(iter_dir, f"policy_{tag}.pickle"), "wb") as f:
        pickle.dump(agent.policy, f)
    with open(os.path.join(iter_dir, f"baseline_{tag}.pickle"), "wb") as f:
        pickle.dump(agent.baseline, f)
    with open(os.path.join(iter_dir, "best_policy.pickle"), "wb") as f:
        pickle.dump(best_policy, f)
    extra = dict(rng_state=agent.generator.get_state(),
                 running_score=agent.running_score)
    if hasattr(agent, "opt_state"):
        extra["opt_state"] = tree_to(agent.opt_state, "cpu")
    with open(os.path.join(iter_dir, f"checkpoint_{tag}.pickle"), "wb") as f:
        pickle.dump(extra, f)


def _print_table(job_name, i, train_score, eval_score, best_perf,
                 print_data):
    results_path = os.path.join(job_name, "results.txt")
    header_needed = i == 0 or not os.path.exists(results_path)
    with open(results_path, "a") as f:
        if header_needed:
            f.write("Iter | Stoc Pol | Mean Pol | Best (Stoc)\n")
        f.write(f"{i}   {train_score:.2f}   {eval_score:.2f}   "
                f"{best_perf:.2f}\n")
    print(f"[iter {i}] stoc_pol: {train_score:.2f}  eval: "
          f"{eval_score:.2f}  best: {best_perf:.2f}")
    if print_data:
        width = max(len(k) for k, _ in print_data)
        for k, v in print_data:
            try:
                print(f"  {k:<{width}} : {float(v):.4g}")
            except (TypeError, ValueError):
                pass
