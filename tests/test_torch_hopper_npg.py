"""The Hopper slice as a whole, port vs JAX package (CPU, float64).

A small Hopper batch (32 episodes x 10 control steps, some of which end early)
is rolled out by the port with injected action noise from a table of start
states.  The same batch then goes through one whole NPG iteration's
processing in both packages, with the policy weights carried across by
``convert``: masked returns, GAE advantages with the termination bootstrap
and whitening at 1e-10 (closed-form recurrences); the NPG update (gradient,
CG over Fisher-vector products, KL-guarded step, new parameters) and the
linear baseline's least-squares fit at 1e-8, where ten CG iterations or a
linear solve amplify last-digit differences.  A two-iteration ``train_agent``
run on the CPU writes its files.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import baselines as jhost
from mjrl_tpu.algos.npg_cg import NPG as JaxNPG
from mjrl_tpu.envs import gym_suite as jsuite
from mjrl_tpu.models import policies as jpol
from mjrl_tpu.models.fc_network import \
    identity_transforms as jax_identity_transforms
from mjrl_tpu_torch import baselines as thost
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos import NPG
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.envs import gym_suite as tsuite
from mjrl_tpu_torch.models import policies as tpol
from mjrl_tpu_torch.samplers import rollout as trollout
from mjrl_tpu_torch.utils.train_agent import train_agent

from test_torch_gym_suite import _start_table
from test_torch_npg import close, close_tree
from test_torch_policy import numpy_params, to_jax

B, T, HID = 32, 10, (8, 8)
GAMMA, LAM = 0.995, 0.97


@pytest.fixture(scope="module")
def setup():
    """Agents of both packages around the same 8-8 policy for an 11-dim
    observation, and the port's Hopper batch."""
    tenv = tsuite.HopperEnv(dtype=torch.float64, device="cpu")
    jenv = jsuite.HopperEnv(dtype=jnp.float64)
    p_np = numpy_params(17, HID, obs=11, act=3)
    p_np["log_std"] = np.full(3, -1.5)
    for k in ("w", "b"):                # gentle actions: standing starts last
        p_np["layers"][-1][k] = 0.1 * p_np["layers"][-1][k]
    jpolicy = jpol.MLP(jenv.spec, hidden_sizes=HID)
    jpolicy.params = jpolicy.old_params = to_jax(p_np)
    jpolicy.transforms = jax_identity_transforms(11, 3, jnp.float64)
    tpolicy = tpol.MLP(tenv.spec, hidden_sizes=HID, dtype=torch.float64,
                       device="cpu")
    convert.policy_params_from_numpy(tpolicy, p_np)
    jagent = JaxNPG(jenv, jpolicy, jhost.LinearBaseline(jenv.spec),
                    normalized_step_size=0.05)
    tagent = NPG(tenv, tpolicy,
                 thost.LinearBaseline(tenv.spec, dtype=torch.float64,
                                      device="cpu"),
                 normalized_step_size=0.05, device="cpu")
    q0, v0 = (np.tile(a, (B // 8, 1)) for a in _start_table())
    noise = torch.tensor(np.random.RandomState(9).normal(size=(T, B, 3)))
    batch = trollout.rollout_batch(
        tenv, tpolicy.config, tpolicy.params, tpolicy.transforms, None, B,
        horizon=T, state0=tenv.state_from_qpos_qvel(q0, v0), noise=noise)
    return jagent, tagent, batch


def test_policy_for_an_11_dim_observation_crosses(setup):
    jagent, tagent, batch = setup
    obs = batch["observations"].reshape(-1, 11)
    tm, tl = tagent.policy.config.dist_info(
        tagent.policy.params, tagent.policy.transforms, obs)
    jm, jl = jagent.policy.config.dist_info(
        jagent.policy.params, jagent.policy.transforms,
        jnp.asarray(obs.numpy()))
    close(tm, jm, 1e-12)
    close(tl, jl, 0.0)
    back, _ = convert.policy_params_to_numpy(tagent.policy)
    close(back["layers"][0]["w"], jagent.policy.params["layers"][0]["w"], 0.0)


def test_batch_has_terminated_and_full_episodes(setup):
    _, _, batch = setup
    lengths = batch["mask"].sum(1)
    assert 0 < int(batch["terminated"].sum()) < B
    assert float(lengths.min()) < T and float(lengths.max()) == T


def test_one_npg_iteration_on_hopper_matches_jax(setup):
    jagent, tagent, batch = setup
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()
              if torch.is_tensor(v)}
    _, jprocess, jupdate, jfit = jagent._get_phases(B, T, GAMMA, LAM)
    _, tprocess, tupdate, tfit = tagent._get_phases(B, T, GAMMA, LAM)

    jret, jadv, jpr = jprocess(jagent.baseline.state, jbatch)
    tret, tadv, tpr = tprocess(tagent.baseline.state, batch)
    close(tret, jret, 1e-10)
    close(tadv, jadv, 1e-10)
    close(tpr, jpr, 1e-10)
    assert float((tadv.reshape(B, T) * (1 - batch["mask"])).abs().sum()) == 0

    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    jnew, jst = jupdate(jagent.policy.params, jagent.policy.transforms,
                        flat(jbatch["observations"]), flat(jbatch["actions"]),
                        jadv, flat(jbatch["mask"]), jax.random.PRNGKey(0))
    tnew, tst = tupdate(tagent.policy.params, tagent.policy.transforms,
                        flat(batch["observations"]), flat(batch["actions"]),
                        tadv, flat(batch["mask"]),
                        torch.Generator().manual_seed(0))
    for k in ("alpha", "surr_before", "surr_after", "kl_dist"):
        close(tst[k], jst[k], 1e-8)
    close_tree(tnew, jnew, 1e-8)
    assert float(tst["surr_after"]) > float(tst["surr_before"])

    jstate, je0, je1 = jfit(jagent.baseline.state, jbatch["observations"],
                            jret, jbatch["mask"], jax.random.PRNGKey(1))
    tstate, te0, te1 = tfit(tagent.baseline.state, batch["observations"],
                            tret, batch["mask"])
    close(tstate, jstate, 1e-8)
    close(te0, je0, 1e-8)
    close(te1, je1, 1e-8)


def test_train_agent_runs_hopper_on_the_cpu(tmp_path):
    """GymEnv("Hopper-v3") -> MLP -> LinearBaseline -> NPG -> train_agent,
    two iterations at a tiny size: files written, finite log, episodes
    counted by their valid steps."""
    e = GymEnv("Hopper-v3", device="cpu", horizon=5)
    e.env.horizon = 5
    policy = tpol.MLP(e.spec, hidden_sizes=(8, 8), seed=3, device="cpu")
    agent = NPG(e, policy, thost.LinearBaseline(e.spec, device="cpu"),
                normalized_step_size=0.05, seed=3, save_logs=True,
                device="cpu")
    job = str(tmp_path / "hopper")
    train_agent(job, agent, seed=3, niter=2, num_traj=4, gamma=GAMMA,
                gae_lambda=LAM, save_freq=1, evaluation_rollouts=None)
    for f in ("results.txt", os.path.join("iterations", "policy_final.pickle"),
              os.path.join("logs", "log.csv")):
        assert os.path.exists(os.path.join(job, f)), f
    log = agent.logger.log
    assert len(log["stoc_pol_mean"]) == 2
    assert all(np.all(np.isfinite(v)) for v in log.values())
    assert all(0 < n <= 20 for n in log["num_samples"])
    assert np.all(np.isfinite(policy.get_param_values()))
