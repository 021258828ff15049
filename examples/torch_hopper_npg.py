"""NPG on Hopper-v3 with the PyTorch/CUDA port (step 0.05, gamma 0.995,
GAE lambda 0.97: the settings of the repo's Hopper-v3 NPG baseline row).

    python examples/torch_hopper_npg.py                   # GPU when present
    python examples/torch_hopper_npg.py --device cpu --num_traj 8 \
        --niter 2 --hidden 16 16 --horizon 20             # small CPU run

GymEnv -> MLP gaussian policy -> linear baseline -> NPG -> train_agent: every
iteration rolls ``num_traj`` hoppers for up to 1000 control steps on the
device; episodes end when the hopper falls and stay frozen behind a mask.
On a GPU each control step of the whole batch is one launch of the
hand-written contact / RK4 kernel, built with nvcc at first use; on the CPU
the plain PyTorch version steps the batch (seconds per control step at any
size: keep the run small).  ``--env`` takes Walker2d-v3 and HalfCheetah-v3
too.  Logs, plots and checkpoints go to ``--job``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mjrl_tpu_torch.algos import NPG                        # noqa: E402
from mjrl_tpu_torch.baselines import LinearBaseline          # noqa: E402
from mjrl_tpu_torch.envs import GymEnv                       # noqa: E402
from mjrl_tpu_torch.models.policies import MLP               # noqa: E402
from mjrl_tpu_torch.utils.train_agent import train_agent     # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--job", default="torch_hopper_exp1")
    ap.add_argument("--env", default="Hopper-v3")
    ap.add_argument("--device", default=None,
                    help="cuda / cpu (default: cuda; without a GPU pass cpu)")
    ap.add_argument("--num_traj", type=int, default=4096)
    ap.add_argument("--niter", type=int, default=50)
    ap.add_argument("--horizon", type=int, default=None,
                    help="control steps per trajectory (default: the "
                         "env's 1000)")
    ap.add_argument("--hidden", type=int, nargs="*", default=[64, 64])
    ap.add_argument("--step_size", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=123)
    args = ap.parse_args(argv)

    e = GymEnv(args.env, device=args.device, horizon=args.horizon)
    if args.horizon is not None:
        e.env.horizon = args.horizon     # the rollout reads the env's own
    policy = MLP(e.spec, hidden_sizes=tuple(args.hidden), seed=args.seed,
                 device=args.device)
    baseline = LinearBaseline(e.spec, device=args.device)
    agent = NPG(e, policy, baseline, normalized_step_size=args.step_size,
                seed=args.seed, save_logs=True, device=args.device)
    train_agent(job_name=args.job, agent=agent, seed=args.seed,
                niter=args.niter, gamma=0.995, gae_lambda=0.97,
                num_traj=args.num_traj, save_freq=10)
    return agent


if __name__ == "__main__":
    main()
