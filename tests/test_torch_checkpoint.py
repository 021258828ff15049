"""Full-state checkpoints and whole-agent pickles (CPU).

The port's ``utils/checkpoint.py`` against the JAX package's: the same
fields (the generator's state in place of ``rng_key``), the round trip of
``tests/test_checkpoint.py::test_orbax_roundtrip``, and a resumed run that
equals the uninterrupted one bit for bit: two NPG iterations, against one,
a checkpoint, a restore into an agent built with another seed, and one
more.
"""

import pickle

import numpy as np
import pytest
import torch

from mjrl_tpu.algos import NPG as JaxNPG, PPO as JaxPPO
from mjrl_tpu.baselines import LinearBaseline as JaxLinearBaseline
from mjrl_tpu.envs import GymEnv as JaxGymEnv
from mjrl_tpu.models import GaussianMLP as JaxGaussianMLP
from mjrl_tpu.models import Policy as JaxPolicy
from mjrl_tpu.utils.checkpoint import _agent_state as jax_agent_state
from mjrl_tpu_torch.algos import NPG, PPO
from mjrl_tpu_torch.baselines import LinearBaseline, MLPBaseline
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.models.policies import GaussianMLP, Policy
from mjrl_tpu_torch.utils.checkpoint import (_agent_state,
                                             enable_compilation_cache,
                                             latest_checkpoint,
                                             restore_agent_checkpoint,
                                             save_agent_checkpoint)

STEP = dict(N=4, gamma=0.95, gae_lambda=0.97, horizon=5)


def agent(seed=3, baseline=LinearBaseline, cls=NPG):
    e = GymEnv("mjrl_point_mass-v0", device="cpu")
    pol = Policy(GaussianMLP(6, 2, hidden_sizes=(8,), device="cpu"),
                 seed=seed)
    bl = baseline(e.spec, device="cpu")
    kw = dict(normalized_step_size=0.05) if cls is NPG else {}
    return cls(e, pol, bl, seed=seed, save_logs=False, device="cpu", **kw)


def test_roundtrip(tmp_path):
    a = agent()
    a.train_step(**STEP)
    params_after = a.policy.get_param_values()
    save_agent_checkpoint(str(tmp_path), a, 7)
    assert latest_checkpoint(str(tmp_path)) == 7
    assert latest_checkpoint(str(tmp_path / "none")) is None

    b = agent(seed=99)                      # another initialization
    assert restore_agent_checkpoint(str(tmp_path), b) == 7
    np.testing.assert_array_equal(b.policy.get_param_values(), params_after)
    np.testing.assert_array_equal(b.baseline.state.numpy(),
                                  a.baseline.state.numpy())
    assert b.running_score == a.running_score
    for x, y in zip(b.policy.transforms, a.policy.transforms):
        assert torch.equal(x, y)
    stats = b.train_step(**STEP)
    assert np.isfinite(stats[0])
    assert restore_agent_checkpoint(str(tmp_path / "none"), b) is None
    assert enable_compilation_cache().endswith("_build")


@pytest.mark.parametrize("baseline,cls", [(LinearBaseline, NPG),
                                          (MLPBaseline, NPG),
                                          (LinearBaseline, PPO)],
                         ids=["npg-linear", "npg-mlp", "ppo"])
def test_resumed_run_equals_the_uninterrupted_one(tmp_path, baseline, cls):
    """Bit for bit on the CPU: every random draw of an iteration comes
    from a generator whose state the checkpoint holds (the agent's, and
    the MLP baseline's own), and PPO's Adam state travels with it."""
    a = agent(baseline=baseline, cls=cls)
    a.train_step(**STEP)
    a.train_step(**STEP)
    b = agent(baseline=baseline, cls=cls)
    b.train_step(**STEP)
    save_agent_checkpoint(str(tmp_path), b, 1)
    c = agent(seed=41, baseline=baseline, cls=cls)
    assert restore_agent_checkpoint(str(tmp_path), c) == 1
    c.train_step(**STEP)
    np.testing.assert_array_equal(c.policy.get_param_values(),
                                  a.policy.get_param_values())
    assert c.running_score == a.running_score


def jax_agent(cls):
    e = JaxGymEnv("mjrl_point_mass-v0")
    pol = JaxPolicy(JaxGaussianMLP(6, 2, hidden_sizes=(8,)), seed=3)
    bl = JaxLinearBaseline(e.spec)
    kw = dict(normalized_step_size=0.05) if cls is JaxNPG else {}
    return cls(e, pol, bl, seed=3, save_logs=False, **kw)


@pytest.mark.parametrize("jcls,tcls", [(JaxNPG, NPG), (JaxPPO, PPO)],
                         ids=["npg", "ppo"])
def test_fields_match_the_jax_checkpoint(jcls, tcls):
    want = set(jax_agent_state(jax_agent(jcls), 0))
    got = set(_agent_state(agent(cls=tcls), 0))
    assert "rng_key" in want and "generator_state" in got
    assert got - {"generator_state"} == want - {"rng_key"}
    # an MLP baseline adds its own generator's state
    extra = set(_agent_state(agent(baseline=MLPBaseline, cls=tcls), 0))
    assert extra - got == {"baseline_generator_state"}


def test_checkpoint_holds_cpu_tensors_only(tmp_path):
    save_agent_checkpoint(str(tmp_path), agent(baseline=MLPBaseline), 0)
    state = torch.load(str(tmp_path / "state_0.pt"), weights_only=True)
    tensors = []

    def walk(x):
        if torch.is_tensor(x):
            tensors.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(state)
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    assert np.isnan(state["running_score"]) and state["iteration"] == 0


def test_agent_pickle_roundtrip():
    """The whole agent (env, policy, baseline, generator) through pickle:
    the copy continues exactly as the original does."""
    a = agent(baseline=MLPBaseline)
    a.train_step(**STEP)
    b = pickle.loads(pickle.dumps(a))
    np.testing.assert_array_equal(b.policy.get_param_values(),
                                  a.policy.get_param_values())
    sa, sb = a.train_step(**STEP), b.train_step(**STEP)
    assert np.isfinite(sb[0]) and sa[0] == sb[0]
    np.testing.assert_array_equal(b.policy.get_param_values(),
                                  a.policy.get_param_values())


# -- the device a pickle loads onto -----------------------------------------------

CUDA_GENERATOR_STATE = torch.zeros(16, dtype=torch.uint8)   # seed, offset


def _pickled_objects():
    """One object of each class of the port that pickles its device."""
    from mjrl_tpu_torch.algos import BC
    from mjrl_tpu_torch.algos.model_accel.nn_dynamics import (
        WorldModel, WorldModelEnsemble)
    a = agent(baseline=MLPBaseline)
    paths = [{"observations": np.zeros((4, 6)), "actions": np.zeros((4, 2))}]
    return {
        "policy": a.policy, "baseline": a.baseline, "agent": a,
        "bc": BC(paths, a.policy, epochs=1, batch_size=2, device="cpu"),
        "world_model": WorldModel(3, 2, hidden_size=(4,), device="cpu"),
        "ensemble": WorldModelEnsemble(2, 3, 2, hidden_size=(4,),
                                       device="cpu")}


class _Saved:
    """Pickles as ``obj`` would, with ``changes`` made to its state."""

    def __init__(self, obj, **changes):
        self.cls, self.state = type(obj), {**obj.__getstate__(), **changes}

    def __reduce__(self):
        return object.__new__, (self.cls,), self.state


def _as_saved_on(obj, device, **changes):
    key = "_device" if "_device" in obj.__getstate__() else "device"
    return pickle.dumps(_Saved(obj, **{key: device}, **changes))


@pytest.mark.parametrize("name", ["policy", "baseline", "agent", "bc",
                                  "world_model", "ensemble"])
def test_card_pickle_needs_a_card_or_device_cpu(monkeypatch, name, tmp_path):
    """A pickle made on a card, loaded where there is none, raises naming
    device="cpu"; asked for the CPU, it loads there."""
    from mjrl_tpu_torch.device import load_pickle, unpickling_onto
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    obj = _pickled_objects()[name]
    blob = _as_saved_on(obj, "cuda:0")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pickle.loads(blob)
    with unpickling_onto("cpu"):
        copy = pickle.loads(blob)
    assert copy.device.type == "cpu"
    (tmp_path / "obj.pickle").write_bytes(blob)
    assert load_pickle(tmp_path / "obj.pickle", "cpu").device.type == "cpu"


@pytest.mark.parametrize("name", ["policy", "baseline", "agent", "bc",
                                  "world_model"])
def test_generator_state_of_another_kind_raises(name):
    """A generator's state of another device kind is not reseeded in
    silence: it raises, unless the loader itself moved the object to
    another kind of device, and then the restart is announced."""
    from mjrl_tpu_torch.device import unpickling_onto
    obj = _pickled_objects()[name]
    with pytest.raises(ValueError, match="another kind of device"):
        pickle.loads(_as_saved_on(obj, "cpu",
                                  generator=CUDA_GENERATOR_STATE))
    with unpickling_onto("cpu"), pytest.warns(RuntimeWarning,
                                              match="restarts from seed"):
        copy = pickle.loads(_as_saved_on(obj, "cuda:0",
                                         generator=CUDA_GENERATOR_STATE))
    assert copy.generator.initial_seed() == obj.seed


def test_restore_of_another_kinds_generator_raises(tmp_path):
    a = agent()
    save_agent_checkpoint(str(tmp_path), a, 1)
    state = torch.load(tmp_path / "state_1.pt", weights_only=True)
    state["generator_state"] = CUDA_GENERATOR_STATE
    torch.save(state, tmp_path / "state_2.pt")
    with pytest.raises(ValueError, match="another kind of device"):
        restore_agent_checkpoint(str(tmp_path), agent(), 2)
