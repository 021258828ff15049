"""External host-API envs behind the port's GymEnv (CPU): every case of
``tests/test_external_env.py`` on the port, held to the JAX package's
``GymEnv`` where both return numbers, plus the host-side sampler and the
model-accelerated runner's ``env_factory`` hook."""

import json
import os

import numpy as np
import pytest

from mjrl_tpu.envs.gym_env import GymEnv as JaxGymEnv
from mjrl_tpu_torch.algos.model_accel.run_experiments import \
    run_model_accel_npg
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.models.policies import GaussianMLP, Policy
from mjrl_tpu_torch.samplers.rollout import sample_data_batch, sample_paths

from test_external_env import ToyHostEnv, make_toy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Gym4TupleEnv(ToyHostEnv):
    """The gym API: ``step`` -> (obs, reward, done, info), ``reset`` ->
    obs."""

    def reset(self, seed=None):
        return super().reset(seed)[0]

    def step(self, a):
        obs, r, term, trunc, info = super().step(a)
        return obs, r, term or trunc, info


def make_gym4():
    return Gym4TupleEnv()


class HostPointMass(ToyHostEnv):
    """A point mass on the host with the mjrl point mass's observation
    layout [agent xy, velocity, target xy], so that the registry's point
    mass reward applies to its paths."""

    class _Spec:
        max_episode_steps = 25

    def __init__(self):
        super().__init__()
        self.observation_space = self._Space(6)
        self.spec = self._Spec()

    def reset(self, seed=None):
        rng = np.random.RandomState(seed)
        self._x, self._v = rng.uniform(-1, 1, 2), np.zeros(2)
        self._g = rng.uniform(-1, 1, 2)
        self._t = 0
        return self._obs(), {}

    def _obs(self):
        return np.concatenate([self._x, self._v, self._g])

    def step(self, a):
        self._v = self._v + 0.05 * np.asarray(a)
        self._x = self._x + 0.05 * self._v
        self._t += 1
        d = self._x - self._g
        r = -np.abs(d).sum() - 0.5 * np.linalg.norm(d)
        return self._obs(), float(r), False, self._t >= 25, {}


def make_host_point_mass():
    return HostPointMass()


def test_external_env_basic():
    e, j = GymEnv(make_toy, device="cpu"), JaxGymEnv(make_toy)
    assert e._external and (e.observation_dim, e.action_dim, e.horizon) == \
        (3, 2, 40)
    assert e.spec.observation_dim == 3 and e.spec.horizon == 40
    o, jo = e.reset(seed=0), j.reset(seed=0)
    assert o.shape == (3,)
    np.testing.assert_array_equal(o, jo)
    out, jout = e.step([0.5, -0.5]), j.step([0.5, -0.5])
    np.testing.assert_array_equal(out[0], jout[0])
    assert out[1:3] == jout[1:3] and np.isfinite(out[1]) and not out[2]
    assert e.get_env_infos() == {}
    with pytest.raises(NotImplementedError):
        e.get_env_state()


@pytest.mark.parametrize("factory", [make_toy, make_gym4],
                         ids=["gymnasium-5-tuple", "gym-4-tuple"])
def test_external_env_act_repeat_and_truncation(factory):
    e = GymEnv(factory, act_repeat=2, device="cpu")
    j = JaxGymEnv(factory, act_repeat=2)
    assert e.horizon == j.horizon == 20
    e.reset(seed=1)
    j.reset(seed=1)
    done, steps, total, jtotal = False, 0, 0.0, 0.0
    while not done and steps < 50:
        _, r, done, _ = e.step([1.0, 0.0])
        total += r
        jtotal += j.step([1.0, 0.0])[1]
        steps += 1
    assert done and steps == 20       # truncation at 40 raw steps
    assert total == jtotal


def test_external_env_seed_reproducible():
    e = GymEnv(make_toy, device="cpu")
    np.testing.assert_array_equal(e.reset(seed=7), e.reset(seed=7))
    # a seed is used once: the next plain reset draws afresh, as in JAX
    e.reset(seed=7)
    o = e.reset()
    j = JaxGymEnv(make_toy)
    j.reset(seed=7)
    assert o.shape == j.reset().shape == (3,)


def test_runner_env_factory_hook():
    """The runner's ``pkg.module:callable`` resolves to a factory that
    GymEnv's external backend builds."""
    import importlib
    mod, _, fn = "test_external_env:make_toy".partition(":")
    factory = getattr(importlib.import_module(mod), fn)
    e = GymEnv(factory, act_repeat=1, device="cpu")
    assert e._external and e.horizon == 40


def test_gymnasium_env_if_available():
    gymnasium = pytest.importorskip("gymnasium")
    e = GymEnv(lambda: gymnasium.make("Pendulum-v1"), device="cpu")
    j = JaxGymEnv(lambda: gymnasium.make("Pendulum-v1"))
    assert e.observation_dim == 3 and e.action_dim == 1
    assert e.horizon == j.horizon == 200
    np.testing.assert_array_equal(e.reset(seed=0), j.reset(seed=0))
    o, r, d, _ = e.step([0.1])
    jo, jr, jd, _ = j.step([0.1])
    assert o.shape == (3,) and np.isfinite(r)
    np.testing.assert_array_equal(o, jo)
    assert (r, d) == (jr, jd)


class TerminatingHostEnv(ToyHostEnv):
    """A host env that ends by termination when its first coordinate
    leaves [-1.2, 1.2] and by its time limit (40 steps) otherwise;
    ``last_term`` records the termination flag of its last step.  With
    ``four_tuple`` it speaks the gym API and marks a truncation in
    ``info["TimeLimit.truncated"]``."""

    def __init__(self, four_tuple=False):
        super().__init__()
        self.four_tuple = four_tuple
        self.last_term = False

    def reset(self, seed=None):
        obs, info = super().reset(seed)
        self.last_term = False
        return obs if self.four_tuple else (obs, info)

    def step(self, a):
        self._x[:2] += 0.3 * np.asarray(a)
        self._t += 1
        r = -float(np.linalg.norm(self._x))
        term = bool(abs(self._x[0]) > 1.2)
        trunc = self._t >= 40 and not term
        self.last_term = term
        if self.four_tuple:
            info = {"TimeLimit.truncated": True} if trunc else {}
            return self._x.copy(), r, term or trunc, info
        return self._x.copy(), r, term, trunc, {}


def make_terminating():
    return TerminatingHostEnv()


def make_terminating_gym4():
    return TerminatingHostEnv(four_tuple=True)


def replay_on_jax(factory, paths, base_seed, horizon):
    """Each path's actions stepped through the JAX package's GymEnv from
    the same reset seed: observations, rewards, the length and the
    termination flag must be the path's, exactly."""
    for k, p in enumerate(paths):
        j = JaxGymEnv(factory)
        obs = [j.reset(seed=base_seed + k)]
        rews, done = [], False
        for a in p["actions"]:
            assert not done and len(rews) < horizon
            o, r, done, _ = j.step(a)
            obs.append(o)
            rews.append(r)
        assert done or len(rews) == horizon
        np.testing.assert_array_equal(p["observations"], np.array(obs[:-1]))
        np.testing.assert_array_equal(p["rewards"], np.array(rews))
        assert p["terminated"] == (done and j.env.last_term
                                   if hasattr(j.env, "last_term") else False)


def test_host_sampler_and_evaluation_with_the_policy_elsewhere():
    """Host paths: the env steps on the host, the policy's forward runs
    on its own device; each path is the JAX package's GymEnv stepped from
    the same seed with the path's actions, and eval_mode takes the mean
    actions."""
    e = GymEnv(make_host_point_mass, device="cpu")
    pol = Policy(GaussianMLP(6, 2, hidden_sizes=(8,), device="cpu"), seed=2)
    paths = sample_paths(3, e, pol, eval_mode=True, base_seed=10)
    assert [len(p["rewards"]) for p in paths] == [25] * 3
    assert not any(p["terminated"] for p in paths)
    replay_on_jax(make_host_point_mass, paths, 10, 25)
    for p in paths:
        np.testing.assert_array_equal(p["actions"],
                                      p["agent_infos"]["evaluation"])
    batch = sample_data_batch(60, e, pol, base_seed=1)
    assert sum(len(p["rewards"]) for p in batch) >= 60
    base, _, _ = e.evaluate_policy(pol, num_episodes=2, mean_action=True)
    assert np.isfinite(base).all()


@pytest.mark.parametrize("horizon", [10, 40, 100])
@pytest.mark.parametrize("factory", [make_terminating,
                                     make_terminating_gym4],
                         ids=["gymnasium-5-tuple", "gym-4-tuple"])
def test_host_paths_keep_truncation_apart_from_termination(factory,
                                                           horizon):
    """Sampled host paths against the JAX GymEnv's external backend; a
    path cut by the env's 40-step limit (horizon 100) or by the horizon is
    not terminated, one ended by the env's termination is."""
    e = GymEnv(factory, device="cpu")
    pol = Policy(GaussianMLP(3, 2, hidden_sizes=(8,), init_log_std=0.0,
                             device="cpu"), seed=4)
    paths = sample_paths(12, e, pol, horizon=horizon, base_seed=20)
    replay_on_jax(factory, paths, 20, horizon)
    lengths = [len(p["rewards"]) for p in paths]
    ended = [p["terminated"] for p in paths]
    assert all(n <= min(horizon, 40) for n, t in zip(lengths, ended) if t)
    assert all(n == min(horizon, 40) for n, t in zip(lengths, ended)
               if not t)
    if horizon == 100:        # both ends occur beyond the env's limit
        assert any(ended) and not all(ended)
        assert 40 in lengths


def test_model_accel_runner_with_an_env_factory(tmp_path):
    with open(os.path.join(REPO, "mjrl_tpu_torch", "algos", "model_accel",
                           "run_experiments", "configs",
                           "point_mass.json")) as f:
        job = json.load(f)
    job.update(num_iter=1, eval_rollouts=1, init_samples=50,
               hidden_size=[16, 16], policy_size=[8], update_paths=6,
               inner_steps=1, fit_epochs=1, fit_mb_size=16,
               env_factory="test_torch_external_env:make_host_point_mass")
    agent, logger = run_model_accel_npg.run(str(tmp_path / "mb"), job,
                                            device="cpu")
    assert agent.env._external
    assert logger.log["num_samples"] == [50]
    for k in ("rollout_score", "eval_score", "dyn_loss_0", "dyn_loss_gen_0"):
        assert np.isfinite(logger.log[k]).all(), k


def test_the_jax_runner_cannot_sample_an_external_env(tmp_path):
    """The JAX runner builds the external env through GymEnv, whose
    ``spec`` then reads the host env's ``observation_dim``, which a host
    env does not have (and its rollout would next read ``env.horizon``):
    the runner stops before its first sample.  The port's ``spec`` takes
    the wrapper's own dimensions and samples such an env on the host
    (previous test)."""
    from mjrl_tpu.algos.model_accel.run_experiments.run_model_accel_npg \
        import run as jax_run
    job = dict(env_name="mjrl_point_mass-v0", seed=1, num_iter=1,
               num_models=1, hidden_size=[8], fit_lr=1e-3, fit_mb_size=16,
               fit_epochs=1, buffer_size=1000, init_samples=50,
               iter_samples=50, policy_size=[8], init_log_std=-0.5,
               min_log_std=-2.5, inner_steps=1, step_size=0.05,
               update_paths=4, horizon=25,
               env_factory="test_torch_external_env:make_host_point_mass")
    with pytest.raises(AttributeError, match="observation_dim"):
        jax_run(str(tmp_path / "jax_mb"), job)
