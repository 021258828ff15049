"""Demo-augmented policy learning on the point mass with the PyTorch/CUDA
port (counterpart of ``examples/dapg_point_mass.py``): train an NPG expert,
collect demonstrations from its best policy, BC warm-start a fresh policy,
then fine-tune it with DAPG, which mixes the demos' gradient into NPG's.

    python examples/torch_dapg_point_mass.py                 # on the GPU
    python examples/torch_dapg_point_mass.py --device cpu --niter 2 \\
        --finetune_niter 2 --num_traj 8 --eval_episodes 1 \\
        --job /tmp/dapg                                       # small CPU run
"""

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np                                           # noqa: E402

from mjrl_tpu_torch.algos import BC, DAPG, NPG               # noqa: E402
from mjrl_tpu_torch.baselines import MLPBaseline             # noqa: E402
from mjrl_tpu_torch.envs import GymEnv                       # noqa: E402
from mjrl_tpu_torch.models.policies import MLP               # noqa: E402
from mjrl_tpu_torch.samplers.rollout import sample_paths     # noqa: E402
from mjrl_tpu_torch.utils.train_agent import train_agent     # noqa: E402

SEED = 123


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--job", default="pm_dapg",
                    help="directory for the expert's and DAPG's outputs")
    ap.add_argument("--device", default=None,
                    help="cuda / cpu (default: cuda; without a GPU pass cpu)")
    ap.add_argument("--niter", type=int, default=30,
                    help="NPG iterations of the expert")
    ap.add_argument("--finetune_niter", type=int, default=20,
                    help="DAPG iterations")
    ap.add_argument("--num_traj", type=int, default=40)
    ap.add_argument("--num_demos", type=int, default=10)
    ap.add_argument("--bc_epochs", type=int, default=20)
    ap.add_argument("--eval_episodes", type=int, default=10)
    args = ap.parse_args(argv)
    dev = args.device
    expert_job = os.path.join(args.job, "pm_dapg_expert")
    finetune_job = os.path.join(args.job, "pm_dapg_finetune")

    # expert
    e = GymEnv("mjrl_point_mass-v0", device=dev)
    expert = MLP(e.spec, hidden_sizes=(32, 32), seed=SEED, device=dev)
    baseline = MLPBaseline(e.spec, reg_coef=1e-3, batch_size=64, epochs=2,
                           learn_rate=1e-3, device=dev)
    agent = NPG(e, expert, baseline, normalized_step_size=0.1, seed=SEED,
                save_logs=True, device=dev)
    train_agent(job_name=expert_job, agent=agent, seed=SEED,
                niter=args.niter, gamma=0.95, gae_lambda=0.97,
                num_traj=args.num_traj, save_freq=10)
    with open(os.path.join(expert_job, "iterations", "best_policy.pickle"),
              "rb") as f:
        expert = pickle.load(f)

    # demos
    demo_paths = sample_paths(num_traj=args.num_demos, env=e.env,
                              policy=expert, eval_mode=True, base_seed=SEED)
    demo_return = float(np.mean([p["rewards"].sum() for p in demo_paths]))
    print(f"demo mean return: {demo_return:.2f}")

    # BC warm start
    policy = MLP(e.spec, hidden_sizes=(32, 32), seed=SEED + 1, device=dev)
    bc = BC(demo_paths, policy=policy, epochs=args.bc_epochs, batch_size=64,
            lr=1e-3, set_transforms=True, device=dev)
    bc.train(suppress_fit_tqdm=True)
    bc_score = e.evaluate_policy(policy, num_episodes=args.eval_episodes,
                                 mean_action=True)
    print(f"BC policy score: {bc_score[0][0]:.2f}")

    # DAPG fine-tune
    baseline2 = MLPBaseline(e.spec, reg_coef=1e-3, batch_size=64, epochs=2,
                            learn_rate=1e-3, device=dev)
    dapg = DAPG(e, policy, baseline2, demo_paths=demo_paths,
                normalized_step_size=0.05, lam_0=1.0, lam_1=0.95, seed=SEED,
                save_logs=True, device=dev)
    train_agent(job_name=finetune_job, agent=dapg, seed=SEED,
                niter=args.finetune_niter, gamma=0.95, gae_lambda=0.97,
                num_traj=args.num_traj, save_freq=10)
    final = e.evaluate_policy(policy, num_episodes=args.eval_episodes,
                              mean_action=True)
    print(f"DAPG fine-tuned score: {final[0][0]:.2f}")
    return dict(expert=agent, bc=bc, dapg=dapg, demo_paths=demo_paths,
                demo_return=demo_return, bc_score=float(bc_score[0][0]),
                final_score=float(final[0][0]))


if __name__ == "__main__":
    main()
