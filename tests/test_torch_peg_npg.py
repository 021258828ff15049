"""The contact slice as a whole, on the CPU: NPG on mjrl_peg_insertion-v0
through the entry points a user calls (GymEnv -> MLP -> MLPBaseline ->
NPG -> train_agent), with tools/train_gym.py's hyperparameters (64-64,
init_log_std -0.5, step 0.05, gamma 0.995, GAE 0.97; MLPBaseline reg
1e-3, batch 64, 2 epochs) at 4 paths x 3 steps, 1 iteration: the job's
files written, every logged statistic finite, the KL within the guard.
"""

import os

import numpy as np
import torch

from mjrl_tpu_torch.algos import NPG
from mjrl_tpu_torch.baselines import MLPBaseline
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.models.policies import MLP
from mjrl_tpu_torch.utils.train_agent import train_agent


def test_peg_npg_iteration_through_train_agent(tmp_path):
    e = GymEnv("mjrl_peg_insertion-v0", device="cpu", horizon=3)
    e.env.horizon = 3                    # the rollout reads the env's own
    assert e.env.model.row_freeze_step and e.env.model.contact_topk == 64
    policy = MLP(e.spec, hidden_sizes=(64, 64), init_log_std=-0.5, seed=0,
                 device="cpu")
    baseline = MLPBaseline(e.spec, reg_coef=1e-3, batch_size=64, epochs=2,
                           learn_rate=1e-3, device="cpu")
    agent = NPG(e, policy, baseline, normalized_step_size=0.05, seed=0,
                save_logs=True, device="cpu")
    before = policy.get_param_values().copy()
    job = str(tmp_path / "peg")
    train_agent(job, agent, seed=0, niter=1, num_traj=4, gamma=0.995,
                gae_lambda=0.97, save_freq=10)
    for f in ("results.txt", os.path.join("logs", "log.csv"),
              os.path.join("iterations", "policy_final.pickle")):
        assert os.path.exists(os.path.join(job, f)), f
    log = agent.logger.log
    assert log["num_samples"] == [12]
    for k, vals in log.items():
        assert len(vals) == 1 and np.all(np.isfinite(vals)), k
    assert 0 < log["kl_dist"][0] <= agent.kl_guard * agent.n_step_size / 2
    after = policy.get_param_values()
    assert np.all(np.isfinite(after)) and np.abs(after - before).max() > 0
    assert policy.device == torch.device("cpu")
