"""Policy-gradient job script for the PyTorch/CUDA port (counterpart of
``examples/policy_opt_job_script.py``).

Runs NPG / VPG / NVPG / PPO / TRPO from a config file (json, yaml, or a
dict-literal .txt), e.g. the repo's own ``examples/example_configs/*.json``:

    python examples/torch_policy_opt_job_script.py --output <dir> \\
        --config examples/example_configs/swimmer_ppo.json     # on the GPU
    python examples/torch_policy_opt_job_script.py --device cpu \\
        --config examples/example_configs/swimmer_ppo.json --output /tmp/ppo \\
        --horizon 50 --set rl_num_iter=2                       # small CPU run

``alg_hyper_params`` reach the agent as keyword arguments, so
``--set 'alg_hyper_params={"autoreset": True}'`` turns on autoreset
rollouts.  ``--set key=value`` overrides any entry of the config.
"""

import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))

import argparse                                              # noqa: E402
import time as timer                                         # noqa: E402

from mjrl_tpu_torch.algos import NPG, PPO, TRPO, BatchREINFORCE  # noqa: E402
from mjrl_tpu_torch.baselines import MLPBaseline             # noqa: E402
from mjrl_tpu_torch.envs import GymEnv                       # noqa: E402
from mjrl_tpu_torch.models.policies import MLP               # noqa: E402
from mjrl_tpu_torch.utils.config import (apply_overrides,    # noqa: E402
                                         load_config, save_config)
from mjrl_tpu_torch.utils.train_agent import train_agent     # noqa: E402


def agent_class_and_kwargs(job_data):
    """-> (algorithm class, keyword arguments) of the agent a config asks
    for, the same as the JAX job script's (TRPO added: kl_dist is half the
    step size, the trust region NPG's normalized step gives)."""
    hp = dict(job_data.get("alg_hyper_params") or {})
    alg = job_data["algorithm"]
    common = dict(seed=job_data["seed"], save_logs=True)
    step = job_data["rl_step_size"]
    if alg == "NPG":
        return NPG, dict(normalized_step_size=step, **common, **hp)
    if alg == "VPG":
        return BatchREINFORCE, dict(learn_rate=step, **common, **hp)
    if alg == "NVPG":
        return BatchREINFORCE, dict(desired_kl=step, **common, **hp)
    if alg == "PPO":
        return PPO, dict(**common, **hp)
    if alg == "TRPO":
        return TRPO, dict(**{"kl_dist": 0.5 * step, **hp}, **common)
    raise ValueError(f"unknown algorithm {alg!r} "
                     "(choose NPG, NVPG, VPG, PPO or TRPO)")


def build_agent(job_data, device=None, horizon=None):
    """GymEnv -> MLP policy -> MLPBaseline -> the agent, on ``device``
    (default: the GPU); ``horizon`` cuts the env's episodes."""
    e = GymEnv(job_data["env"], device=device, horizon=horizon)
    if horizon is not None:
        e.env.horizon = horizon          # the rollout reads the env's own
    policy = MLP(e.spec, hidden_sizes=tuple(job_data["policy_size"]),
                 seed=job_data["seed"],
                 init_log_std=job_data.get("init_log_std", 0.0),
                 device=device)
    baseline = MLPBaseline(
        e.spec, reg_coef=1e-3, batch_size=job_data["vf_batch_size"],
        hidden_sizes=tuple(job_data["vf_hidden_size"]),
        epochs=job_data["vf_epochs"], learn_rate=job_data["vf_learn_rate"],
        device=device)
    cls, kwargs = agent_class_and_kwargs(job_data)
    return cls(e, policy, baseline, device=device, **kwargs)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Policy gradient training with the PyTorch/CUDA port")
    ap.add_argument("--output", type=str, required=True)
    ap.add_argument("--config", type=str, required=True)
    ap.add_argument("--device", default=None,
                    help="cuda / cpu (default: cuda; without a GPU pass cpu)")
    ap.add_argument("--horizon", type=int, default=None,
                    help="control steps per episode (default: the env's)")
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                    help="override config entries")
    args = ap.parse_args(argv)

    job_data = apply_overrides(load_config(args.config), args.set)
    assert job_data["sample_mode"] in ("trajectories", "samples")
    save_config(job_data, args.output)
    agent = build_agent(job_data, device=args.device, horizon=args.horizon)

    ts = timer.time()
    train_agent(job_name=args.output,
                agent=agent,
                seed=job_data["seed"],
                niter=job_data["rl_num_iter"],
                gamma=job_data["rl_gamma"],
                gae_lambda=job_data["rl_gae"],
                num_cpu=job_data.get("num_cpu", 1),
                sample_mode=job_data["sample_mode"],
                num_traj=job_data.get("rl_num_traj", 0),
                num_samples=job_data.get("rl_num_samples", 0),
                save_freq=job_data["save_freq"],
                evaluation_rollouts=job_data.get("eval_rollouts"))
    print(f"time taken = {timer.time() - ts:.2f}")
    return agent


if __name__ == "__main__":
    main()
