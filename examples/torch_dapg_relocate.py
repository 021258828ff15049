"""Adroit relocate by BC warm start + DAPG fine-tune with the PyTorch/CUDA
port (counterpart of ``examples/dapg_relocate.py``): behaviour cloning of
the scripted expert's demos, then demo-augmented NPG.

Demos come from the port's expert (``mjrl_tpu_torch.utils.relocate_demos``):
make them first, or in the same run with ``--make_demos``:

    python -m mjrl_tpu_torch.utils.relocate_demos --episodes 30 \\
        --out relocate_demos.pkl
    python examples/torch_dapg_relocate.py --demos relocate_demos.pkl
    python examples/torch_dapg_relocate.py --device cpu --make_demos 2 \\
        --keep_all_demos --horizon 3 --bc_epochs 2 --dapg_iters 1 \\
        --ntraj 4 --eval_episodes 1                   # a small CPU run

The real-MuJoCo cross-evaluation of the JAX example needs ``mujoco`` and
is not ported: ``--cross_eval_episodes`` above 0 raises.
"""

import argparse
import json
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np                                            # noqa: E402

from mjrl_tpu_torch.algos import BC, DAPG                     # noqa: E402
from mjrl_tpu_torch.baselines import MLPBaseline              # noqa: E402
from mjrl_tpu_torch.envs import GymEnv                        # noqa: E402
from mjrl_tpu_torch.models.policies import MLP                # noqa: E402
from mjrl_tpu_torch.samplers.rollout import sample_paths      # noqa: E402
from mjrl_tpu_torch.utils.relocate_demos import make_demos    # noqa: E402


def evaluate(env, policy, episodes=20, base_seed=7):
    """(mean return, success rate) of ``episodes`` mean-action episodes;
    NaN for 0 episodes."""
    if episodes == 0:
        return float("nan"), float("nan")
    paths = sample_paths(num_traj=episodes, env=env.env, policy=policy,
                         eval_mode=True, base_seed=base_seed,
                         horizon=env.horizon)
    rets = [float(np.sum(p["rewards"])) for p in paths]
    return float(np.mean(rets)), float(env.env.evaluate_success(paths))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--demos", default="relocate_demos.pkl")
    ap.add_argument("--make_demos", type=int, default=0,
                    help="make this many expert episodes here instead of "
                         "loading --demos")
    ap.add_argument("--keep_all_demos", action="store_true",
                    help="keep the made episodes that did not succeed "
                         "(needed at horizons too short to succeed)")
    ap.add_argument("--device", default=None,
                    help="cuda / cpu (default: cuda; without a GPU pass cpu)")
    ap.add_argument("--horizon", type=int, default=None,
                    help="cut the episode horizon (default: the env's 200)")
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--bc_epochs", type=int, default=50)
    ap.add_argument("--dapg_iters", type=int, default=30)
    ap.add_argument("--ntraj", type=int, default=50)
    ap.add_argument("--step_size", type=float, default=0.05)
    ap.add_argument("--lam_0", type=float, default=1e-2)
    ap.add_argument("--lam_1", type=float, default=0.95)
    ap.add_argument("--hidden", type=int, nargs="+", default=[64, 64])
    ap.add_argument("--eval_episodes", type=int, default=20,
                    help="evaluation episodes after BC and after DAPG "
                         "(0 skips them)")
    ap.add_argument("--save", default=None)
    ap.add_argument("--cross_eval_episodes", type=int, default=0,
                    help="real-MuJoCo cross-evaluation episodes (needs "
                         "mujoco; not ported)")
    args = ap.parse_args(argv)
    if args.cross_eval_episodes > 0:
        raise NotImplementedError(
            "the real-MuJoCo cross-evaluation is the JAX package's "
            "benchmarks/parity/cross_eval_relocate.py (mujoco, "
            "gymnasium-robotics and a JAX policy pickle): the port does not "
            "run the benchmark folders")
    emit = lambda rec: print(json.dumps(rec), flush=True)

    e = GymEnv("relocate-v0", device=args.device, horizon=args.horizon)
    e.env.horizon = e.horizon            # the rollout reads the env's own
    if args.make_demos:
        demo_paths, succ = make_demos(
            e.env, args.make_demos, horizon=e.horizon,
            batch=args.make_demos, seed=args.seed,
            successful_only=not args.keep_all_demos)
        emit({"made_demos": args.make_demos, "demo_successes": succ})
    else:
        with open(args.demos, "rb") as f:
            demo_paths = pickle.load(f)
    demo_return = float(np.mean([p["rewards"].sum() for p in demo_paths]))
    emit({"demos": len(demo_paths), "demo_return": demo_return})

    policy = MLP(e.spec, hidden_sizes=tuple(args.hidden), seed=args.seed,
                 init_log_std=-0.5, device=args.device)

    # BC warm start
    bc = BC(demo_paths, policy=policy, epochs=args.bc_epochs, batch_size=32,
            lr=1e-3, set_transforms=True, device=args.device)
    bc.train(suppress_fit_tqdm=True)
    bc_ret, bc_succ = evaluate(e, policy, args.eval_episodes)
    emit({"stage": "bc", "return": bc_ret, "success_rate": bc_succ})

    # DAPG fine-tune
    baseline = MLPBaseline(e.spec, reg_coef=1e-3, batch_size=64, epochs=2,
                           learn_rate=1e-3, device=args.device)
    agent = DAPG(e, policy, baseline, demo_paths=demo_paths,
                 normalized_step_size=args.step_size, lam_0=args.lam_0,
                 lam_1=args.lam_1, seed=args.seed, save_logs=True,
                 device=args.device)
    best, best_params = -1e18, None
    for i in range(args.dapg_iters):
        stats = agent.train_step(N=args.ntraj, sample_mode="trajectories",
                                 horizon=e.horizon, gamma=0.995,
                                 gae_lambda=0.97)
        log = agent.logger.get_current_log()
        if float(stats[0]) > best:
            best = float(stats[0])
            best_params = policy.get_param_values()
        emit({"iter": i, "return": float(stats[0]),
              "success_rate": log.get("success_rate", float("nan"))})
    ft_ret, ft_succ = evaluate(e, policy, args.eval_episodes)
    emit({"stage": "dapg", "return": ft_ret, "success_rate": ft_succ,
          "bc_return": bc_ret, "bc_success_rate": bc_succ})
    if best_params is not None and ft_ret < best:
        policy.set_param_values(best_params)
    if args.save:
        with open(args.save, "wb") as f:
            pickle.dump(policy, f)
        emit({"saved": args.save})
    return dict(bc=bc, dapg=agent, policy=policy, demo_paths=demo_paths,
                demo_return=demo_return, bc_return=bc_ret,
                bc_success_rate=bc_succ, final_return=ft_ret,
                final_success_rate=ft_succ)


if __name__ == "__main__":
    main()
