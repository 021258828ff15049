"""The slice as a whole on the CPU: GymEnv -> MLP -> LinearBaseline -> NPG ->
train_agent at a small size (8 trajectories, horizon 20, a 16-16 policy),
plus the host-side pieces around it (GymEnv API, checkpoints and resume,
path-list entry points, logger, the example script).

Tolerances: the training runs are checked for finiteness, bookkeeping and
exact reproducibility from a seed (0.0); the one cross-package comparison
here (host-side GAE on path lists) is at 1e-10.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from mjrl_tpu.utils import process_samples as jps
from mjrl_tpu_torch.algos import NPG, BatchREINFORCE
from mjrl_tpu_torch.baselines import LinearBaseline, ZeroBaseline
from mjrl_tpu_torch.device import default_device, make_generator, \
    resolve_device
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.envs.gym_suite import HopperEnv
from mjrl_tpu_torch.envs.swimmer import SwimmerEnv
from mjrl_tpu_torch.models.policies import MLP
from mjrl_tpu_torch.parallel import make_mesh
from mjrl_tpu_torch.samplers.rollout import sample_paths
from mjrl_tpu_torch.utils import process_samples as tps
from mjrl_tpu_torch.utils.logger import DataLog
from mjrl_tpu_torch.utils.make_train_plots import make_train_plots
from mjrl_tpu_torch.utils.train_agent import train_agent

HORIZON, NUM_TRAJ, HID = 20, 8, (16, 16)


def small_gym_env():
    env = SwimmerEnv(device="cpu")
    env.horizon = HORIZON             # depth cut for the test; widths stay
    return GymEnv(env)


def make_agent(seed=7, **kw):
    e = small_gym_env()
    policy = MLP(e.spec, hidden_sizes=HID, seed=seed, device="cpu")
    baseline = LinearBaseline(e.spec, device="cpu")
    return NPG(e, policy, baseline, normalized_step_size=0.1, seed=seed,
               save_logs=True, device="cpu", **kw)


def run(job, agent, niter=3, **kw):
    return train_agent(job, agent, seed=0, niter=niter, num_traj=NUM_TRAJ,
                       gamma=0.995, gae_lambda=0.97, save_freq=1, **kw)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    job = str(tmp_path_factory.mktemp("train") / "swimmer_npg")
    agent = run(job, make_agent(), evaluation_rollouts=2)
    return job, agent


def test_train_agent_finishes_finite_and_writes_its_log(trained):
    job, agent = trained
    log = agent.logger.log
    for key in ("stoc_pol_mean", "stoc_pol_std", "stoc_pol_min",
                "stoc_pol_max", "running_score", "alpha", "delta", "kl_dist",
                "surr_improvement", "time_sampling", "time_npg", "time_vpg",
                "time_VF", "VF_error_before", "VF_error_after",
                "num_samples", "eval_score"):
        assert len(log[key]) == 3, key
        assert np.all(np.isfinite(log[key])), (key, log[key])
    assert log["num_samples"] == [NUM_TRAJ * HORIZON] * 3
    assert all(s > 0 for s in log["surr_improvement"])
    assert all(kl <= agent.kl_guard * agent.n_step_size / 2 + 1e-9
               for kl in log["kl_dist"])
    assert np.all(np.isfinite(agent.policy.get_param_values()))
    with open(os.path.join(job, "results.txt")) as f:
        lines = f.read().strip().splitlines()
    assert lines[0].startswith("Iter") and len(lines) == 4
    for f in ("logs/log.csv", "logs/log.pickle",
              "iterations/policy_final.pickle",
              "iterations/baseline_final.pickle",
              "iterations/checkpoint_final.pickle",
              "iterations/best_policy.pickle", "iterations/policy_2.pickle"):
        assert os.path.exists(os.path.join(job, f)), f
    assert DataLog().read_log(os.path.join(job, "logs", "log.csv"))[
        "stoc_pol_mean"] == pytest.approx(log["stoc_pol_mean"])


def test_policy_moved_and_old_copy_follows(trained):
    _, agent = trained
    fresh = MLP(agent.env.spec, hidden_sizes=HID, seed=7, device="cpu")
    assert np.abs(agent.policy.get_param_values()
                  - fresh.get_param_values()).max() > 1e-3
    for k, v in agent.policy.params.items():
        assert torch.equal(v, agent.policy.old_params[k])
    assert float(agent.baseline.state.abs().sum()) > 0


def test_training_is_reproducible_from_the_seed(trained, tmp_path):
    _, agent = trained
    again = run(str(tmp_path / "again"), make_agent(), evaluation_rollouts=2)
    np.testing.assert_array_equal(again.policy.get_param_values(),
                                  agent.policy.get_param_values())
    assert again.logger.log["stoc_pol_mean"] == \
        agent.logger.log["stoc_pol_mean"]


def test_checkpoints_hold_cpu_tensors_and_reload(trained):
    job, agent = trained
    with open(os.path.join(job, "iterations", "policy_final.pickle"),
              "rb") as f:
        policy = pickle.load(f)
    with open(os.path.join(job, "iterations", "baseline_final.pickle"),
              "rb") as f:
        baseline = pickle.load(f)
    np.testing.assert_array_equal(policy.get_param_values(),
                                  agent.policy.get_param_values())
    assert policy.device.type == "cpu" and baseline.state.device.type == "cpu"
    assert torch.equal(baseline.state, agent.baseline.state)
    clone = pickle.loads(pickle.dumps(agent))
    assert clone.device.type == "cpu"
    assert torch.equal(clone.generator.get_state(),
                       agent.generator.get_state())


def test_resume_continues_where_the_run_stopped(tmp_path):
    """2 iterations, then a fresh agent resumes the same job to 3: it runs
    one more iteration from the restored policy, baseline and generator, and
    lands exactly where an uninterrupted 3-iteration run lands."""
    job = str(tmp_path / "resume")
    run(job, make_agent(), niter=2)
    resumed = run(job, make_agent(), niter=3)
    straight = run(str(tmp_path / "straight"), make_agent(), niter=3)
    assert len(resumed.logger.log["stoc_pol_mean"]) == 3
    assert resumed.logger.log["stoc_pol_mean"][:2] == pytest.approx(
        straight.logger.log["stoc_pol_mean"][:2])
    np.testing.assert_allclose(resumed.policy.get_param_values(),
                               straight.policy.get_param_values(),
                               rtol=0, atol=0)


def test_samples_mode_and_input_normalization(tmp_path):
    agent = make_agent(input_normalization=0.5)
    train_agent(str(tmp_path / "samples"), agent, niter=1,
                sample_mode="samples", num_samples=70, gamma=0.995,
                gae_lambda=0.97)
    # 70 samples at horizon 20 -> 4 trajectories
    assert agent.logger.log["num_samples"] == [80]
    tr = agent.policy.transforms
    assert float((tr.in_shift.abs()).sum()) > 0
    assert not torch.equal(tr.in_scale, torch.ones(12))
    with pytest.raises(ValueError, match="sample_mode"):
        train_agent(str(tmp_path / "bad"), agent, niter=1, sample_mode="x")


def test_train_from_paths_and_batch_reinforce(tmp_path):
    e = small_gym_env()
    policy = MLP(e.spec, hidden_sizes=HID, seed=1, device="cpu")
    agent = BatchREINFORCE(e, policy, ZeroBaseline(e.spec, device="cpu"),
                           learn_rate=0.05, save_logs=True, device="cpu")
    before = policy.get_param_values()
    paths = sample_paths(5, e, policy, horizon=HORIZON, base_seed=2)
    stats = agent.train_from_paths(paths)
    assert len(stats) == 4 and np.all(np.isfinite(stats))
    assert stats[0] == pytest.approx(
        np.mean([p["rewards"].sum() for p in paths]), abs=1e-5)
    assert np.abs(policy.get_param_values() - before).max() > 0
    agent.log_rollout_statistics(paths)
    out = agent.train_step(4, gamma=0.99, gae_lambda=None)
    assert out[-1] == 4 and np.all(np.isfinite(out))


def test_agent_rejects_mixed_devices_and_unported_options():
    e = small_gym_env()
    policy = MLP(e.spec, hidden_sizes=HID, device="cpu")
    baseline = LinearBaseline(e.spec, device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        NPG(e, policy, baseline, device="meta")
    # the mesh (M11) is ported: the agent keeps it for train_step
    mesh = make_mesh(device="cpu")
    assert NPG(e, policy, baseline, device="cpu", mesh=mesh).mesh is mesh
    # autoreset (queue 1) is ported: the agent takes it
    assert NPG(e, policy, baseline, device="cpu", autoreset=True).autoreset
    assert not NPG(e, policy, baseline, device="cpu").autoreset


def test_device_helpers(monkeypatch):
    """The default device is the GPU; without one it raises, naming the
    missing card, and the CPU is used only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (default_device, resolve_device, lambda: make_generator(5)):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            fn()
    assert resolve_device("cpu") == torch.device("cpu")
    g = make_generator(5, "cpu")
    assert g.device.type == "cpu" and g.initial_seed() == 5
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == resolve_device(None) == torch.device("cuda")


ENTRY_POINTS = {
    "SwimmerEnv": lambda: SwimmerEnv(),
    "HopperEnv": lambda: HopperEnv(),
    "GymEnv": lambda: GymEnv("mjrl_swimmer-v0"),
    "MLP": lambda: MLP(small_gym_env().spec, hidden_sizes=HID),
    "LinearBaseline": lambda: LinearBaseline(small_gym_env().spec),
    "NPG": lambda: NPG(small_gym_env(), MLP(small_gym_env().spec,
                                            hidden_sizes=HID, device="cpu"),
                       LinearBaseline(small_gym_env().spec, device="cpu")),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_without_a_card_raises(monkeypatch, name):
    """An entry point given no device does not carry on quietly on the CPU
    when there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ENTRY_POINTS[name]()


def test_gym_env_api(tmp_path):
    e = GymEnv("mjrl_swimmer-v0", device="cpu", act_repeat=2)
    assert (e.observation_dim, e.action_dim, e.horizon) == (12, 4, 250)
    assert e.spec.horizon == 250 and e.env_id == "mjrl_swimmer-v0"
    np.testing.assert_array_equal(e.action_space.low, -np.ones(4))
    o = e.reset(seed=3)
    assert o.shape == (12,) and np.abs(o[0]) <= np.pi and not o[1:].any()
    np.testing.assert_array_equal(e.reset(seed=3), o)
    o2, r, done, info = e.step(np.array([5.0, -5.0, 0.3, 0.0]))  # clipped
    assert o2.shape == (12,) and np.isfinite(r) and done is False
    state = e.get_env_state()
    assert set(state) == {"qp", "qv"} and state["qp"].shape == (7,)
    np.testing.assert_array_equal(info["state"]["qv"], state["qv"])
    # act_repeat 2 = two env steps with the clipped action, rewards summed
    f = GymEnv("mjrl_swimmer-v0", device="cpu")
    f.reset(seed=3)
    r1 = f.step(np.array([1.0, -1.0, 0.3, 0.0]))[1]
    o_f, r2, _, _ = f.step(np.array([1.0, -1.0, 0.3, 0.0]))
    np.testing.assert_allclose(o2, o_f, rtol=0, atol=0)
    assert r == pytest.approx(r1 + r2, abs=1e-7)
    # set_env_state puts the wrapper back where it was
    f.reset(seed=9)
    f.set_env_state(state)
    np.testing.assert_allclose(f.get_obs(), o2, rtol=0, atol=0)
    masked = GymEnv("mjrl_swimmer-v0", device="cpu",
                    obs_mask=np.r_[np.zeros(5), np.ones(7)])
    assert not masked.reset(seed=3)[:5].any()
    clone = pickle.loads(pickle.dumps(e))
    assert clone.reset(seed=3).shape == (12,)
    # offscreen rendering: an episode of 4 steps of the mean action (its
    # qpos sequence, and its GIF and one frame of the current state where
    # matplotlib and PIL are present)
    from mjrl_tpu_torch.utils.render import (drawing_available,
                                            visualize_policy)
    policy = MLP(e.spec, hidden_sizes=HID, device="cpu")
    vis = tmp_path / "vis"
    drawn, _ = drawing_available()
    assert visualize_policy(e, policy, horizon=4, save_dir=str(vis),
                            video_format="gif") == (5 if drawn else 0)
    assert np.load(vis / "episode_0_qpos.npy").shape == (5, 7)
    if drawn:
        img = e.render()
        assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3


def test_evaluate_policy():
    e = GymEnv("mjrl_swimmer-v0", device="cpu")
    policy = MLP(e.spec, hidden_sizes=HID, device="cpu")
    base, pct, full = e.evaluate_policy(policy, num_episodes=3, horizon=6,
                                        mean_action=True, percentile=[50],
                                        get_full_dist=True)
    assert len(base) == 4 and len(pct) == 1 and full.shape == (3,)
    assert base[0] == pytest.approx(full.mean()) and base[2] <= base[3]
    again = e.evaluate_policy(policy, num_episodes=3, horizon=6,
                              mean_action=True, get_full_dist=True)[2]
    np.testing.assert_array_equal(again, full)


def test_host_side_advantages_match_jax():
    """utils.process_samples on path lists (numpy) against the JAX
    package's copy, with a stub baseline (1e-10)."""
    class Stub:
        def predict(self, path):
            return path["observations"][:, 0] * 0.5

    def paths():
        r = np.random.RandomState(1)
        return [dict(observations=r.normal(size=(n, 3)),
                     rewards=r.normal(size=n), terminated=term)
                for n, term in ((7, False), (4, True), (9, False))]

    for lam, norm in ((None, False), (0.9, False), (0.97, True)):
        pj, pt = paths(), paths()
        jps.compute_returns(pj, 0.98)
        tps.compute_returns(pt, 0.98)
        jps.compute_advantages(pj, Stub(), 0.98, lam, normalize=norm)
        tps.compute_advantages(pt, Stub(), 0.98, lam, normalize=norm)
        for a, b in zip(pt, pj):
            np.testing.assert_allclose(a["returns"], b["returns"],
                                       rtol=1e-10, atol=1e-10)
            np.testing.assert_allclose(a["advantages"], b["advantages"],
                                       rtol=1e-10, atol=1e-10)


def test_logger_round_trip_and_shrink(tmp_path):
    log = DataLog()
    for i in range(4):
        log.log_kv("iteration", i)
        log.log_kv("score", 0.5 * i)
    log.log_kv("late", "x")
    log.save_log(str(tmp_path))
    back = DataLog()
    data = back.read_log(str(tmp_path / "log.csv"))
    assert data["iteration"] == [0, 1, 2, 3] and data["late"] == ["x"]
    assert back.max_len == 4
    back.shrink_to(2)
    assert back.log["score"] == [0.0, 0.5] and back.max_len == 2
    assert back.get_current_log()["score"] == 0.5
    make_train_plots(log=log.log, keys=["score"], save_loc=str(tmp_path))


def test_example_script_runs_on_the_cpu(tmp_path):
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "torch_swimmer_npg.py")
    spec = importlib.util.spec_from_file_location("torch_swimmer_npg", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    agent = mod.main(["--device", "cpu", "--num_traj", "2", "--niter", "1",
                      "--hidden", "8", "8", "--horizon", "10",
                      "--job", str(tmp_path / "example")])
    assert np.isfinite(agent.logger.log["stoc_pol_mean"][0])
    assert os.path.exists(tmp_path / "example" / "results.txt")
