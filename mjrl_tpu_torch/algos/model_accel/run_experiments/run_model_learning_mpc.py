"""MPC-only model-learning loop (counterpart of
``mjrl_tpu/algos/model_accel/run_experiments/run_model_learning_mpc.py``).

Loop: fit the dynamics model (or ensemble) on the data so far -> collect
real-env paths with the MPC policy (+ exploration noise), one environment
at a time -> repeat; logs rollout scores and model losses.  The first data
come from a random gaussian policy (batched rollouts).

    python -m mjrl_tpu_torch.algos.model_accel.run_experiments.\\
run_model_learning_mpc --output <dir> --config <file> [--device cuda]

Config keys: env_name, seed, num_iter, samples_per_iter, plan_horizon,
plan_paths, kappa, gamma, filter_sigma, noise_level, hidden_size, fit_lr,
fit_mb_size, fit_epochs, num_models (ensemble optional), omega,
warmup_paths.
"""

import argparse
import os
import pickle

import numpy as np

from mjrl_tpu_torch.algos.model_accel.model_learning_mpc import MPCPolicy
from mjrl_tpu_torch.algos.model_accel.nn_dynamics import (WorldModel,
                                                          WorldModelEnsemble)
from mjrl_tpu_torch.algos.model_accel.sampling import sample_paths
from mjrl_tpu_torch.device import resolve_device
from mjrl_tpu_torch.envs.gym_env import GymEnv
from mjrl_tpu_torch.models.policies import GaussianMLP, Policy
from mjrl_tpu_torch.samplers.rollout import \
    sample_paths as policy_sample_paths
from mjrl_tpu_torch.utils.config import load_config, save_config
from mjrl_tpu_torch.utils.logger import DataLog

DEFAULTS = dict(num_iter=5, samples_per_iter=10, plan_horizon=10,
                plan_paths=32, kappa=5.0, gamma=0.99, filter_sigma=1.0,
                noise_level=0.1, hidden_size=(256, 256), fit_lr=1e-3,
                fit_mb_size=64, fit_epochs=10, num_models=1, omega=5.0,
                warmup_paths=10)


def run(output, job_data, device=None):
    job_data = {**DEFAULTS, **job_data}
    device = resolve_device(job_data.get("device") if device is None
                            else device)
    os.makedirs(output, exist_ok=True)
    save_config(job_data, output, "job_data.json")
    logger = DataLog()
    seed = job_data.get("seed", 123)
    np.random.seed(seed)

    e = GymEnv(job_data["env_name"], device=device)
    e.set_seed(seed)
    obs_dim, act_dim = e.observation_dim, int(e.action_dim)

    kw = dict(seed=seed, hidden_size=tuple(job_data["hidden_size"]),
              fit_lr=job_data["fit_lr"], device=device)
    if job_data["num_models"] > 1:
        model = WorldModelEnsemble(job_data["num_models"], obs_dim, act_dim,
                                   **kw)
    else:
        model = WorldModel(obs_dim, act_dim, **kw)

    # warmup data from a random gaussian policy
    rand_pol = Policy(GaussianMLP(obs_dim, act_dim, hidden_sizes=(32, 32),
                                  init_log_std=0.0, device=device),
                      seed=seed)
    paths = policy_sample_paths(job_data["warmup_paths"], e.env, rand_pol,
                                base_seed=seed)

    mpc = MPCPolicy(env=e, plan_horizon=job_data["plan_horizon"],
                    plan_paths=job_data["plan_paths"],
                    kappa=job_data["kappa"], gamma=job_data["gamma"],
                    filter_coefs=[job_data["filter_sigma"]
                                  * np.ones(act_dim), 1.0, 0.0, 0.0],
                    seed=seed, fitted_model=model,
                    omega=job_data["omega"])

    for it in range(job_data["num_iter"]):
        s = np.concatenate([p["observations"][:-1] for p in paths])
        a = np.concatenate([p["actions"][:-1] for p in paths])
        sp = np.concatenate([p["observations"][1:] for p in paths])
        losses = model.fit_dynamics(s, a, sp,
                                    fit_mb_size=job_data["fit_mb_size"],
                                    fit_epochs=job_data["fit_epochs"])
        last_loss = float(np.asarray(losses).ravel()[-1])
        logger.log_kv("dyn_loss", last_loss)

        new_paths = sample_paths(job_data["samples_per_iter"], e, mpc,
                                 eval_mode=False, base_seed=seed + it,
                                 noise_level=job_data["noise_level"])
        score = np.mean([np.sum(p["rewards"]) for p in new_paths])
        logger.log_kv("iteration", it)
        logger.log_kv("rollout_score", float(score))
        print(f"iter {it}: mpc score {score:.2f}  dyn loss {last_loss:.5f}")
        paths.extend(new_paths)
        logger.save_log(output)

    with open(os.path.join(output, "model_final.pickle"), "wb") as f:
        pickle.dump(model, f)
    return model, mpc, logger


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--output", "-o", type=str, required=True)
    parser.add_argument("--config", "-c", type=str, required=True)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda / cpu (default: the config's, else cuda)")
    args = parser.parse_args(argv)
    return run(args.output, load_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
