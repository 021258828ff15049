"""The repo's job-script configurations in the port (CPU, float64).

- ``build_agent`` of ``examples/torch_policy_opt_job_script.py`` on each of
  the four ``examples/example_configs/*.json`` gives the classes and
  hyper-parameters the JAX script's ``build_agent`` gives; TRPO, which the
  JAX script lacks, against the JAX package's ``TRPO`` with the same
  arguments.
- The slice as a whole: one whole iteration of NPG + ``MLPBaseline`` on an
  autoreset Hopper batch in both packages, from the same weights and draws
  (the baseline fit's permutations are the JAX package's own): returns and
  advantages at 1e-10, the new policy and baseline parameters at 1e-8 (ten
  CG iterations, a chain of Adam steps).
- Small CPU runs of both example scripts, and a PPO + ``MLPBaseline``
  checkpoint that round-trips.
"""

import importlib.util
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import baselines as jhost
from mjrl_tpu.algos.npg_cg import NPG as JaxNPG
from mjrl_tpu.algos.trpo import TRPO as JaxTRPO
from mjrl_tpu.envs import gym_suite as jsuite
from mjrl_tpu.models import policies as jpol
from mjrl_tpu_torch import baselines as thost
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos import NPG, TRPO
from mjrl_tpu_torch.envs import gym_suite as tsuite
from mjrl_tpu_torch.models import policies as tpol
from mjrl_tpu_torch.samplers import rollout as trollout
from mjrl_tpu_torch.utils.config import load_config

from test_torch_autoreset import hopper_resets, mlp_baseline_layers
from test_torch_baselines import jax_perms
from test_torch_gym_suite import _start_table
from test_torch_npg import close, close_tree
from test_torch_policy import numpy_params, to_jax

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, "..", "examples")
CONFIGS = ["hopper_npg", "swimmer_npg", "swimmer_ppo", "point_mass_npg"]
B, T, HID = 16, 8, (8, 8)
GAMMA, LAM = 0.995, 0.97


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return (load_script("policy_opt_job_script"),
            load_script("torch_policy_opt_job_script"))


def config(name):
    return load_config(os.path.join(EXAMPLES, "example_configs",
                                    name + ".json"))


AGENT_ATTRS = ("alpha", "seed", "save_logs", "desired_kl", "n_step_size",
               "FIM_invert_args", "hvp_subsample", "kl_guard",
               "input_normalization", "clip_coef", "epochs", "mb_size",
               "learn_rate", "kl_dist", "autoreset")


def same_agent_settings(jagent, tcls, tkw):
    """The port's (class, kwargs) build the JAX agent's settings."""
    assert tcls.__name__ == type(jagent).__name__
    tenv = tsuite.HopperEnv(dtype=torch.float64, device="cpu")
    tpolicy = tpol.MLP(tenv.spec, device="cpu")
    tagent = tcls(tenv, tpolicy, thost.ZeroBaseline(tenv.spec, device="cpu"),
                  device="cpu", **tkw)
    for a in AGENT_ATTRS:
        assert getattr(tagent, a, None) == getattr(jagent, a, None), a


@pytest.mark.parametrize("name", CONFIGS)
def test_build_agent_matches_the_jax_script(scripts, name):
    jscript, tscript = scripts
    job = config(name)
    jagent = jscript.build_agent(job)
    cls, kw = tscript.agent_class_and_kwargs(job)
    same_agent_settings(jagent, cls, kw)
    tagent = tscript.build_agent(job, device="cpu")
    assert type(tagent) is cls and tagent.device.type == "cpu"
    for a in AGENT_ATTRS:
        assert getattr(tagent, a, None) == getattr(jagent, a, None), a
    jp, tp = jagent.policy.config, tagent.policy.config
    assert (tp.obs_dim, tp.act_dim, tp.hidden_sizes, tp.init_log_std,
            tp.min_log_std) == (jp.obs_dim, jp.act_dim, jp.hidden_sizes,
                                jp.init_log_std, jp.min_log_std)
    jb, tb = jagent.baseline, tagent.baseline
    assert type(tb).__name__ == type(jb).__name__ == "MLPBaseline"
    assert tb.needs_key and jb.needs_key
    assert tb.cfg.__dict__ == jb.cfg.__dict__
    assert tagent.fenv.horizon == jagent.fenv.horizon


def test_trpo_from_a_config_matches_jax_trpo(scripts):
    """TRPO is not in the JAX script; the port builds the JAX package's
    TRPO with kl_dist = step / 2 (the trust region of NPG's step), and
    alg_hyper_params reach it, autoreset included."""
    _, tscript = scripts
    job = config("hopper_npg")
    job["algorithm"] = "TRPO"
    job["alg_hyper_params"] = {"autoreset": True}
    cls, kw = tscript.agent_class_and_kwargs(job)
    assert cls is TRPO
    jenv = jsuite.HopperEnv(dtype=jnp.float64)
    jpolicy = jpol.MLP(jenv.spec)
    jagent = JaxTRPO(jenv, jpolicy, None, kl_dist=0.025, seed=123,
                     save_logs=True, autoreset=True)
    same_agent_settings(jagent, cls, kw)
    job["alg_hyper_params"] = {"kl_dist": 0.01}
    assert tscript.agent_class_and_kwargs(job)[1]["kl_dist"] == 0.01


def test_alg_hyper_params_reach_the_agent(scripts):
    _, tscript = scripts
    job = config("hopper_npg")
    job["alg_hyper_params"] = {"autoreset": True}
    agent = tscript.build_agent(job, device="cpu", horizon=6)
    assert agent.autoreset and agent.fenv.horizon == 6
    assert agent.n_step_size == 0.05 and agent.policy.device.type == "cpu"


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

def test_one_npg_iteration_with_mlp_baseline_on_autoreset_hopper():
    tenv = tsuite.HopperEnv(dtype=torch.float64, device="cpu")
    jenv = jsuite.HopperEnv(dtype=jnp.float64)
    p_np = numpy_params(51, HID, obs=11, act=3)
    p_np["log_std"] = np.full(3, -1.0)
    for k in ("w", "b"):
        p_np["layers"][-1][k] = 0.1 * p_np["layers"][-1][k]
    layers = mlp_baseline_layers(52)
    bl_kw = dict(hidden_sizes=(16, 16), reg_coef=1e-3, batch_size=32,
                 epochs=2)

    jpolicy = jpol.MLP(jenv.spec, hidden_sizes=HID)
    jpolicy.params = jpolicy.old_params = to_jax(p_np)
    jbl = jhost.MLPBaseline(jenv.spec, **bl_kw)
    jp = jax.tree_util.tree_map(jnp.asarray, layers)
    jbl.state = (jp, jbl.cfg._optimizer().init(jp))
    jagent = JaxNPG(jenv, jpolicy, jbl, normalized_step_size=0.05,
                    autoreset=True)

    tpolicy = tpol.MLP(tenv.spec, hidden_sizes=HID, dtype=torch.float64,
                       device="cpu")
    convert.policy_params_from_numpy(tpolicy, p_np)
    tbl = thost.MLPBaseline(tenv.spec, dtype=torch.float64, device="cpu",
                            **bl_kw)
    convert.mlp_baseline_from_numpy(tbl, layers)
    tagent = NPG(tenv, tpolicy, tbl, normalized_step_size=0.05,
                 autoreset=True, device="cpu")

    # the port's autoreset batch, injected noise and fresh states
    q0, v0 = (np.tile(a, (B // 8, 1)) for a in _start_table())
    noise = torch.tensor(np.random.RandomState(53).normal(size=(T, B, 3)))
    batch = trollout.rollout_batch(
        tenv, tpolicy.config, tpolicy.params, tpolicy.transforms, None, B,
        horizon=T, autoreset=True, state0=tenv.state_from_qpos_qvel(q0, v0),
        noise=noise, resets=hopper_resets())
    assert int(batch["dones"].sum()) > 0 and float(batch["mask"].min()) == 1
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()
              if torch.is_tensor(v)}

    _, jprocess, jupdate, jfit = jagent._get_phases(B, T, GAMMA, LAM)
    _, tprocess, tupdate, _ = tagent._get_phases(B, T, GAMMA, LAM)
    jret, jadv, _ = jprocess(jbl.state, jbatch)
    tret, tadv, _ = tprocess(tbl.state, batch)
    close(tret, jret, 1e-10)
    close(tadv, jadv, 1e-10)

    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    jnew, jst = jupdate(jpolicy.params, jpolicy.transforms,
                        flat(jbatch["observations"]), flat(jbatch["actions"]),
                        jadv, flat(jbatch["mask"]), jax.random.PRNGKey(0))
    tnew, tst = tupdate(tpolicy.params, tpolicy.transforms,
                        flat(batch["observations"]), flat(batch["actions"]),
                        tadv, flat(batch["mask"]),
                        torch.Generator().manual_seed(0))
    close_tree(tnew, jnew, 1e-8)
    for k in ("alpha", "kl_dist", "surr_before", "surr_after"):
        close(tst[k], jst[k], 1e-8)

    key = jax.random.PRNGKey(54)
    jstate, je0, je1 = jfit(jbl.state, jbatch["observations"], jret,
                            jbatch["mask"], key)
    tstate, te0, te1 = tbl.cfg.fit(tbl.state, batch["observations"], tret,
                                   batch["mask"],
                                   perms=jax_perms(key, 2, B * T))
    for lt, lj in zip(convert.layers_to_numpy(tstate[0]), jstate[0]):
        close(lt["w"], lj["w"], 1e-8)
        close(lt["b"], lj["b"], 1e-8)
    close(te0, je0, 1e-8)
    close(te1, je1, 1e-8)
    assert tstate[1]["count"] == 2 * (B * T // 32)


# ---------------------------------------------------------------------------
# the example scripts, small, on the CPU
# ---------------------------------------------------------------------------

def test_job_script_runs_ppo_and_its_checkpoint_round_trips(scripts,
                                                            tmp_path):
    _, tscript = scripts
    out = str(tmp_path / "ppo")
    agent = tscript.main([
        "--device", "cpu", "--output", out, "--horizon", "10",
        "--config", os.path.join(EXAMPLES, "example_configs",
                                 "swimmer_ppo.json"),
        "--set", "rl_num_iter=2", "rl_num_traj=3", "policy_size=[8,8]",
        "vf_hidden_size=[8,8]"])
    assert type(agent).__name__ == "PPO" and agent.opt_state["count"] > 0
    with open(os.path.join(out, "job_config.json")) as f:
        assert json.load(f)["rl_num_iter"] == 2
    it = os.path.join(out, "iterations")
    with open(os.path.join(it, "checkpoint_final.pickle"), "rb") as f:
        extra = pickle.load(f)
    assert extra["opt_state"]["count"] == agent.opt_state["count"]
    for k, v in agent.opt_state["mu"].items():
        assert extra["opt_state"]["mu"][k].device.type == "cpu"
        assert torch.equal(extra["opt_state"]["mu"][k], v)
    with open(os.path.join(it, "baseline_final.pickle"), "rb") as f:
        bl = pickle.load(f)
    assert bl.state[1]["count"] == agent.baseline.state[1]["count"] > 0
    assert torch.equal(bl.generator.get_state(),
                       agent.baseline.generator.get_state())
    obs = np.zeros((4, 12))
    close(bl.predict({"observations": obs}),
          agent.baseline.predict({"observations": obs}), 0.0)


def test_behavior_clone_example_runs(tmp_path):
    bc = load_script("torch_behavior_clone").main([
        "--device", "cpu", "--niter", "1", "--num_traj", "2", "--horizon",
        "20", "--num_demos", "2", "--bc_epochs", "2",
        "--job", str(tmp_path / "bc")])
    log = bc.logger.log
    assert np.isfinite(log["loss_after"][-1])
    assert log["loss_after"][-1] < log["loss_before"][-1]
