"""MBRL outer loop: the model-accelerated NPG runner (counterpart of
``mjrl_tpu/algos/model_accel/run_experiments/run_model_accel_npg.py``).

Per outer iteration: collect real samples (stochastic policy, batched
rollouts) -> FIFO buffer capped at ``buffer_size`` steps -> fit the
world-model ensemble (generalization error logged per member; one stacked
fit for all members) -> ``inner_steps`` NPG updates on imagined rollouts
from buffer / init states (``start_state`` 'init' | 'buffer' with optional
``buffer_frac``; the picks are numpy's, from the seed) -> evaluation
rollouts on the real env -> pickles of the agent and policy, logs, plots.
Reward functions come from a registry (``reward_functions.py``).

Usage (``--device cpu`` without a GPU):
    python -m \\
        mjrl_tpu_torch.algos.model_accel.run_experiments.run_model_accel_npg \\
        --output <dir> --config <file.{json,yaml,txt}> [--device cuda]
"""

import argparse
import copy
import importlib
import os
import pickle
import time as timer

import numpy as np

from mjrl_tpu_torch.algos.model_accel.model_accel_npg import ModelAccelNPG
from mjrl_tpu_torch.algos.model_accel.nn_dynamics import WorldModelEnsemble
from mjrl_tpu_torch.algos.model_accel.reward_functions import \
    get_reward_function
from mjrl_tpu_torch.algos.model_accel.sampling import evaluate_policy
from mjrl_tpu_torch.baselines import MLPBaseline
from mjrl_tpu_torch.device import load_pickle, resolve_device
from mjrl_tpu_torch.envs.gym_env import GymEnv
from mjrl_tpu_torch.models.policies import GaussianMLP, Policy
from mjrl_tpu_torch.samplers.rollout import sample_data_batch
from mjrl_tpu_torch.utils.config import load_config, save_config
from mjrl_tpu_torch.utils.logger import DataLog
from mjrl_tpu_torch.utils.make_train_plots import make_train_plots

DEFAULTS = dict(eval_rollouts=0, save_freq=10, device=None, hvp_frac=1.0,
                start_state="init", learn_reward=True, num_cpu=1,
                npg_hp=dict(), act_repeat=1, refresh_fit=False,
                refresh_policy=False, fit_wd=0.0, activation="relu",
                debug_mode=False)


def buffer_steps(paths_list):
    return int(np.sum([p["observations"].shape[0] - 1
                       for p in paths_list]))


def run(output, job_data, device=None):
    """``device`` (default: the config's ``device``, else the GPU)."""
    job_data = {**DEFAULTS, **job_data}
    assert job_data["start_state"] in ("init", "buffer")
    device = resolve_device(job_data["device"] if device is None
                            else device)
    os.makedirs(os.path.join(output, "iterations"), exist_ok=True)
    os.makedirs(os.path.join(output, "logs"), exist_ok=True)
    save_config(job_data, output, "job_data.json")

    logger = DataLog()
    env_name = job_data["env_name"]
    seed = job_data["seed"]
    np.random.seed(seed)

    # env_factory = "pkg.module:callable" constructs any host-API env
    # (gymnasium, dmc) behind the GymEnv surface; it steps on the host
    if job_data.get("env_factory"):
        mod_name, _, fn_name = job_data["env_factory"].partition(":")
        factory = getattr(importlib.import_module(mod_name), fn_name)
        e = GymEnv(factory, act_repeat=job_data["act_repeat"],
                   horizon=job_data.get("horizon"), device=device)
    else:
        e = GymEnv(env_name, act_repeat=job_data["act_repeat"],
                   device=device)
    e.set_seed(seed)

    # reward function: the registry first, else the env's batched reward;
    # without either, the learned reward head
    reward_function = get_reward_function(env_name)
    if reward_function is None and hasattr(e.env, "compute_path_rewards"):
        reward_function = e.env.compute_path_rewards
    learn_reward = reward_function is None if not job_data["debug_mode"] \
        else job_data["learn_reward"]

    def ensemble(model_seed):
        return WorldModelEnsemble(
            job_data["num_models"], e.observation_dim, int(e.action_dim),
            seed=model_seed, learn_reward=learn_reward,
            hidden_size=tuple(job_data["hidden_size"]),
            fit_lr=job_data["fit_lr"], fit_wd=job_data["fit_wd"],
            activation=job_data["activation"], device=device)

    def new_policy():
        return Policy(GaussianMLP(
            e.observation_dim, int(e.action_dim),
            hidden_sizes=tuple(job_data["policy_size"]),
            init_log_std=job_data["init_log_std"],
            min_log_std=job_data["min_log_std"], device=device), seed=seed)

    models = ensemble(seed)
    policy = new_policy()
    if job_data.get("init_policy"):
        policy = load_pickle(job_data["init_policy"], device)
    baseline = MLPBaseline(e.spec, reg_coef=1e-3, batch_size=256, epochs=1,
                           learn_rate=1e-3, device=device)
    agent = ModelAccelNPG(
        learned_model=models, env=e, policy=policy, baseline=baseline,
        seed=seed, normalized_step_size=job_data["step_size"],
        save_logs=True, reward_function=reward_function,
        hvp_sample_frac=job_data["hvp_frac"], device=device,
        **job_data["npg_hp"])

    paths, init_states_buffer = [], []
    best_perf = -1e8
    best_policy = copy.deepcopy(policy)

    for outer_iter in range(job_data["num_iter"]):
        ts = timer.time()
        print(f"================> ITERATION : {outer_iter}")
        to_collect = job_data["init_samples"] if outer_iter == 0 \
            else job_data["iter_samples"]
        iter_paths = sample_data_batch(
            to_collect, e, agent.policy, eval_mode=False,
            base_seed=seed + outer_iter)
        for p in iter_paths:
            paths.append(p)
            init_states_buffer.append(p["observations"][0])
        while buffer_steps(paths) > job_data["buffer_size"]:
            paths[:1] = []
            init_states_buffer[:1] = []

        s = np.concatenate([p["observations"][:-1] for p in paths])
        a = np.concatenate([p["actions"][:-1] for p in paths])
        sp = np.concatenate([p["observations"][1:] for p in paths])
        r = np.concatenate([p["rewards"][:-1] for p in paths])
        rollout_score = np.mean([np.sum(p["rewards"]) for p in iter_paths])
        num_samples = int(np.sum([p["rewards"].shape[0]
                                  for p in iter_paths]))

        logger.log_kv("fit_epochs", job_data["fit_epochs"])
        logger.log_kv("rollout_score", rollout_score)
        logger.log_kv("iter_samples", num_samples)
        logger.log_kv("num_samples", num_samples)
        try:
            logger.log_kv("rollout_metric",
                          e.env.evaluate_success(iter_paths))
        except Exception:
            pass

        t1 = timer.time()
        logger.log_kv("data_collect_time", t1 - ts)

        if job_data["refresh_fit"]:
            models = ensemble(seed + 123 * outer_iter)

        # generalization error on the freshest chunk, then one stacked
        # ensemble fit
        for i, model in enumerate(models):
            logger.log_kv(f"dyn_loss_gen_{i}", model.compute_loss(
                s[-to_collect:], a[-to_collect:], sp[-to_collect:]))
        dyn_losses = models.fit_dynamics(
            s, a, sp, fit_mb_size=job_data["fit_mb_size"],
            fit_epochs=job_data["fit_epochs"],
            max_steps=job_data.get("max_steps", 1e4))
        for i in range(len(models)):
            logger.log_kv(f"dyn_loss_{i}", float(dyn_losses[i, -1]))
        if learn_reward:
            for i, model in enumerate(models):
                rl = model.fit_reward(
                    s, a, r.reshape(-1, 1),
                    fit_mb_size=job_data["fit_mb_size"],
                    fit_epochs=job_data["fit_epochs"],
                    max_steps=job_data.get("max_steps", 1e4))
                logger.log_kv(f"rew_loss_{i}", rl[-1])
        t2 = timer.time()
        logger.log_kv("model_update_time", t2 - t1)

        if job_data["refresh_policy"]:
            policy = new_policy()
            agent.policy = policy

        agent.learned_model = list(models)
        for _ in range(job_data["inner_steps"]):
            n_up = job_data["update_paths"]
            if job_data["start_state"] == "init":
                idx = np.random.choice(len(init_states_buffer), size=n_up)
                init_states = np.array([init_states_buffer[i]
                                        for i in idx])
            else:
                frac = job_data.get("buffer_frac", 0.5)
                n1 = int(n_up * (1 - frac)) + 1
                n2 = int(n_up * frac) + 1
                idx1 = np.random.choice(len(init_states_buffer), size=n1)
                idx2 = np.random.choice(s.shape[0], size=n2)
                init_states = np.concatenate(
                    [np.array([init_states_buffer[i] for i in idx1]),
                     s[idx2]])
            agent.train_step(N=len(init_states), init_states=init_states,
                             horizon=job_data["horizon"],
                             truncate_lim=job_data.get("truncate_lim"),
                             truncate_reward=job_data.get(
                                 "truncate_reward", 0.0))
        t3 = timer.time()
        logger.log_kv("policy_update_time", t3 - t2)

        if job_data["eval_rollouts"] > 0:
            eval_paths = evaluate_policy(
                e, agent.policy, agent.learned_model[0], noise_level=0.0,
                real_step=True, num_episodes=job_data["eval_rollouts"])
            eval_score = np.mean([np.sum(p["rewards"])
                                  for p in eval_paths])
            logger.log_kv("eval_score", eval_score)
            try:
                logger.log_kv("eval_metric",
                              e.env.evaluate_success(eval_paths))
            except Exception:
                pass
        else:
            eval_score = -1e8

        policy_score = eval_score if job_data["eval_rollouts"] > 0 \
            else rollout_score
        if policy_score > best_perf:
            best_policy = copy.deepcopy(agent.policy)
            best_perf = policy_score

        if outer_iter > 0 and outer_iter % job_data["save_freq"] == 0:
            _dump(agent, output, f"agent_{outer_iter}.pickle")
            _dump(agent.policy, output, f"policy_{outer_iter}.pickle")
            _dump(best_policy, output, "best_policy.pickle")

        tf = timer.time()
        logger.log_kv("eval_log_time", tf - t3)
        logger.log_kv("iter_time", tf - ts)
        logger.save_log(os.path.join(output, "logs"))
        make_train_plots(
            log=logger.log,
            keys=["rollout_score", "eval_score", "rollout_metric",
                  "eval_metric"],
            x_scale=float(job_data["act_repeat"]),
            save_loc=os.path.join(output, "logs"))

    _dump(agent, output, "agent_final.pickle")
    _dump(agent.policy, output, "policy_final.pickle")
    _dump(best_policy, output, "best_policy.pickle")
    return agent, logger


def _dump(obj, output, name):
    with open(os.path.join(output, "iterations", name), "wb") as f:
        pickle.dump(obj, f)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Model accelerated policy optimization.")
    parser.add_argument("--output", "-o", type=str, required=True)
    parser.add_argument("--config", "-c", type=str, required=True)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda / cpu (default: the config's, else cuda)")
    args = parser.parse_args(argv)
    return run(args.output, load_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
