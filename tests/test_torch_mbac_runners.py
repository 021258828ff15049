"""The model-based branch end to end on the CPU at tiny sizes: MBAC's
labels and FIFO buffer, both ``run_experiments`` runners (their log keys
against the JAX runner's at the same tiny configuration), the DAPG
example, the copied configs, and the import rule of the new modules."""

import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from mjrl_tpu_torch.algos import MBAC
from mjrl_tpu_torch.algos.model_accel.run_experiments import (
    run_model_accel_npg, run_model_learning_mpc)
from mjrl_tpu_torch.models.mpc_actor import MPCActor
from mjrl_tpu_torch.models.policies import GaussianMLP, Policy

from test_torch_kernel_host import _FORBIDDEN, _port_sources

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CONFIGS = "algos/model_accel/run_experiments/configs"
M10 = ["algos/dapg.py", "algos/mbac.py", "models/mpc_actor.py",
       "algos/model_accel/nn_dynamics.py", "algos/model_accel/sampling.py",
       "algos/model_accel/model_accel_npg.py",
       "algos/model_accel/model_learning_mpc.py",
       "algos/model_accel/reward_functions.py",
       "algos/model_accel/run_experiments/run_model_accel_npg.py",
       "algos/model_accel/run_experiments/run_model_learning_mpc.py"]


def tiny_mbac(buffer_size=2, mpc_params=None):
    pol = Policy(GaussianMLP(6, 2, hidden_sizes=(8,), device="cpu"), seed=0)
    agent = MBAC("mjrl_point_mass-v0", pol, epochs=2, batch_size=4,
                 buffer_size=buffer_size, seed=7, device="cpu",
                 mpc_params=mpc_params or dict(H=3, paths_per_cpu=4,
                                               num_cpu=1, kappa=5.0,
                                               gamma=0.95))
    agent.env._horizon = 4
    return agent


def test_mbac_labels_every_state_with_the_mpc_action_and_keeps_a_fifo():
    agent = tiny_mbac()
    perfs = [agent.train_step(num_traj=1) for _ in range(3)]
    assert np.all(np.isfinite(perfs))
    assert len(agent.expert_paths) == 2
    assert agent.logger.log["buffer_size"] == [1, 2, 2]
    for path in agent.expert_paths:
        assert path["observations"].shape == (4, 6)
        assert path["expert_actions"].shape == path["actions"].shape \
            == (4, 2)
    # BC on the buffer: epochs x max(n // batch, 1) Adam steps per fit
    assert agent.opt_state["count"] == 2 * (1 + 2 + 2)

    # a twin actor, replayed on the recorded states, gives the labels
    agent = tiny_mbac(buffer_size=5)
    twin = MPCActor(**agent.mpc_params)
    replayed = []
    for p in agent.collect_paths(num_traj=2):
        for s, label in zip(p["states"], p["expert_actions"]):
            replayed.append(np.abs(twin.get_action(s) - label).max())
        np.testing.assert_allclose(
            p["observations"][:, 2:4], np.array([s["qv"] for s in
                                                 p["states"]]), atol=1e-6)
    assert max(replayed) == 0.0 and len(replayed) == 8


def test_mbac_defaults_and_refusals():
    pol = Policy(GaussianMLP(6, 2, hidden_sizes=(8,), device="cpu"), seed=0)
    agent = MBAC("mjrl_point_mass-v0", pol, device="cpu")
    actor = agent.mpc_policy
    assert (actor.H, actor.num_candidates, actor.kappa, actor.gamma) == \
        (10, 25, 10.0, 1.0)
    sigma, b0, b1, b2 = actor.filter_coefs
    assert np.all(sigma == 1.0) and (b0, b1, b2) == (0.05, 0.0, 0.0)
    # a custom optimizer: a factory, as BC takes it (held to the JAX BC
    # with optax.sgd in test_torch_optimize_model.py)
    custom = MBAC("mjrl_point_mass-v0", pol, device="cpu",
                  optimizer=lambda ps: torch.optim.SGD(ps, lr=1e-2))
    assert isinstance(custom._torch_opt, torch.optim.SGD)
    assert not hasattr(custom, "opt_state")


def tiny_model_accel_job(env="point_mass"):
    with open(os.path.join(REPO, "mjrl_tpu_torch", CONFIGS,
                           f"{env}.json")) as f:
        job = json.load(f)
    job.update(num_iter=2, eval_rollouts=1, init_samples=40,
               iter_samples=20, hidden_size=[16, 16], policy_size=[8],
               update_paths=6, inner_steps=1, fit_epochs=2, fit_mb_size=16,
               save_freq=1, horizon=5)
    return job


@pytest.fixture(scope="module")
def jax_runner_log(tmp_path_factory):
    from mjrl_tpu.algos.model_accel.run_experiments.run_model_accel_npg \
        import run
    _, logger = run(str(tmp_path_factory.mktemp("jax_mb")),
                    {**tiny_model_accel_job(), "num_iter": 1})
    return logger.log


def test_model_accel_runner_on_the_point_mass_logs_as_the_jax_runner(
        tmp_path, jax_runner_log):
    out = str(tmp_path / "mb")
    agent, logger = run_model_accel_npg.run(out, tiny_model_accel_job(),
                                            device="cpu")
    log = logger.log
    assert sorted(log) == sorted(jax_runner_log)
    assert {"dyn_loss_3", "rollout_metric", "eval_score"} <= set(log)
    for k, v in log.items():
        assert len(v) == 2 and np.all(np.isfinite(v)), k
    assert log["num_samples"] == [50, 25]      # 2 and 1 paths of 25
    assert agent.logger.log["num_samples"] == [4 * 6 * 5] * 2
    for name in ("agent_final", "policy_final", "best_policy", "agent_1",
                 "policy_1"):
        assert os.path.exists(os.path.join(out, "iterations",
                                           f"{name}.pickle"))
    assert os.path.exists(os.path.join(out, "logs", "log.csv"))
    with open(os.path.join(out, "iterations", "agent_final.pickle"),
              "rb") as f:
        again = pickle.load(f)
    s = np.zeros((3, 6))
    a = np.ones((3, 2))
    np.testing.assert_array_equal(again.learned_model[2].predict(s, a),
                                  agent.learned_model[2].predict(s, a))


def test_model_accel_runner_on_the_reacher_and_cli(tmp_path):
    job = tiny_model_accel_job("reacher")
    job.update(num_iter=1, init_samples=50, inner_steps=1)
    cfg = tmp_path / "reacher.json"
    cfg.write_text(json.dumps(job))
    agent, logger = run_model_accel_npg.main(
        ["--output", str(tmp_path / "r"), "--config", str(cfg),
         "--device", "cpu"])
    assert agent.fenv.observation_dim == 20
    assert logger.log["num_samples"] == [50]
    assert "rollout_metric" not in logger.log
    assert np.isfinite(logger.log["eval_score"][0])
    # env_factory names a module to import (test_torch_external_env.py
    # runs the runner through one)
    with pytest.raises(ModuleNotFoundError, match="'a'"):
        run_model_accel_npg.run(str(tmp_path / "x"),
                                {**job, "env_factory": "a:b"}, device="cpu")


def test_model_learning_mpc_runner(tmp_path):
    model, mpc, logger = run_model_learning_mpc.run(
        str(tmp_path / "mpc"),
        dict(env_name="mjrl_point_mass-v0", num_models=2, num_iter=2,
             samples_per_iter=1, hidden_size=(8, 8), warmup_paths=2,
             fit_epochs=1, fit_mb_size=16, plan_paths=4, plan_horizon=3),
        device="cpu")
    assert sorted(logger.log) == ["dyn_loss", "iteration", "rollout_score"]
    assert logger.log["iteration"] == [0, 1]
    assert np.all(np.isfinite(logger.log["rollout_score"]))
    assert len(mpc.fitted_model) == 2
    assert os.path.exists(tmp_path / "mpc" / "model_final.pickle")


def test_dapg_example_runs_small(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import torch_dapg_point_mass as example
    finally:
        sys.path.pop(0)
    out = example.main(["--device", "cpu", "--niter", "1",
                        "--finetune_niter", "1", "--num_traj", "4",
                        "--num_demos", "2", "--bc_epochs", "1",
                        "--eval_episodes", "1", "--job", str(tmp_path)])
    assert out["dapg"].iter_count == 1.0
    assert len(out["demo_paths"]) == 2
    assert np.isfinite([out["demo_return"], out["bc_score"],
                        out["final_score"]]).all()
    for job in ("pm_dapg_expert", "pm_dapg_finetune"):
        assert os.path.exists(tmp_path / job / "iterations" /
                              "policy_final.pickle")


@pytest.mark.parametrize("name", ["point_mass", "reacher"])
def test_copied_configs_equal_the_jax_packages(name):
    ours = os.path.join(REPO, "mjrl_tpu_torch", CONFIGS, f"{name}.json")
    theirs = os.path.join(REPO, "mjrl_tpu", CONFIGS, f"{name}.json")
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_m10_modules_are_checked_and_import_no_jax():
    sources = {os.path.relpath(p, REPO): p for p in _port_sources()}
    for rel in M10:
        path = sources[f"mjrl_tpu_torch/{rel}"]
        with open(path) as f:
            assert not _FORBIDDEN.search(f.read()), rel
    assert "examples/torch_dapg_point_mass.py" in sources
