"""Port vs JAX package: the TRPO and PPO updates (CPU, float64).

Agents of both packages around the same 16-16 policy weights and transforms
take ``_update_core`` on the same fixed batch.  TRPO: the NPG direction,
then the backtracking line search (x0.9 while KL >= kl_dist, at most 100
times, alpha 0 when the count reaches 100), at 1e-8 (ten CG iterations).
PPO: the minibatch indices are the JAX package's own draw,
``jax.random.randint(key, (total, mb_size), 0, n)``, handed to the port as
``idxs``; two updates in a row carry the Adam state; 1e-9 relative, where
torch's and optax's Adam evaluate the same formula in a different order
over 14 steps.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.algos.ppo_clip import PPO as JaxPPO
from mjrl_tpu.algos.trpo import TRPO as JaxTRPO
from mjrl_tpu.models import policies as jpol
from mjrl_tpu.models.fc_network import Transforms as JTransforms
from mjrl_tpu_torch import baselines as thost
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos import PPO, TRPO
from mjrl_tpu_torch.algos import functional as tF
from mjrl_tpu_torch.envs.base import EnvSpec
from mjrl_tpu_torch.envs.swimmer import SwimmerEnv
from mjrl_tpu_torch.models import policies as tpol

from test_torch_npg import close, close_tree
from test_torch_policy import numpy_params, numpy_transforms, to_jax

OBS, ACT, HID = 12, 4, (16, 16)
SOLVE_TOL, PPO_TOL = 1e-8, 1e-9
T64 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64)


def policies(log_std):
    spec = EnvSpec(OBS, ACT, 20)
    p_np, t_np = numpy_params(7), numpy_transforms(8)
    p_np["log_std"] = np.asarray(log_std, np.float64)
    jpolicy = jpol.MLP(spec, hidden_sizes=HID)
    jpolicy.params = jpolicy.old_params = to_jax(p_np)
    jpolicy.transforms = JTransforms(*to_jax(list(t_np)))
    tpolicy = tpol.MLP(spec, hidden_sizes=HID, dtype=torch.float64,
                       device="cpu")
    convert.policy_params_from_numpy(tpolicy, p_np, t_np)
    return spec, jpolicy, tpolicy


@pytest.fixture(scope="module")
def env():
    return SwimmerEnv(dtype=torch.float64, device="cpu")


def on_policy_batch(tpolicy, seed, n=240, sharpen=False):
    """(obs, act, adv, mask): actions drawn from the policy itself, a few
    steps masked.  ``sharpen``: actions at 1 % of the policy's spread, all
    advantages positive, so the update narrows the distribution."""
    rng = np.random.RandomState(seed)
    mask = np.ones(n)
    mask[rng.choice(n, 30, replace=False)] = 0.0
    obs = rng.normal(size=(n, OBS))
    mean, log_std = tpolicy.config.dist_info(tpolicy.params,
                                             tpolicy.transforms, T64(obs))
    act = mean.detach().numpy() + np.exp(log_std.detach().numpy()) \
        * rng.normal(size=(n, ACT)) * (0.01 if sharpen else 1.0)
    adv = rng.normal(size=n)
    return obs, act, np.abs(adv) if sharpen else adv, mask


# ---------------------------------------------------------------------------
# TRPO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["loose", "tight", "exhausted"])
def test_trpo_update_core_matches_jax(env, case):
    """loose: kl_dist 0.05 from a step sized for it (at most a step or two
    back); tight: the step sized for KL 0.05, the bound 0.002 (about 15
    steps back); exhausted: a step sized for KL 1e6 against a bound of 1e-9,
    which 100 steps of x0.9 do not reach, so alpha is 0 and the parameters
    stay."""
    spec, jp, tp = policies([-0.3, 0.1, -1.0, 0.0])
    n_step, kl_dist = {"loose": (0.1, 0.05), "tight": (0.1, 0.002),
                       "exhausted": (2e6, 1e-9)}[case]
    jagent = JaxTRPO(None, jp, None, kl_dist=0.05)
    tagent = TRPO(env, tp, thost.ZeroBaseline(spec, device="cpu"),
                  kl_dist=0.05, device="cpu")
    assert tagent.kl_dist == jagent.kl_dist == 0.05
    assert tagent.n_step_size == jagent.n_step_size == 0.1
    for a in (jagent, tagent):
        a.n_step_size, a.kl_dist = n_step, kl_dist
    obs, act, adv, mask = on_policy_batch(tp, 9)
    J = jnp.asarray
    new_j, st_j = jax.jit(jagent._update_core)(
        jp.params, jp.transforms, J(obs), J(act), J(adv), J(mask),
        jax.random.PRNGKey(0))
    new_t, st_t = tagent._update_core(
        tp.params, tp.transforms, T64(obs), T64(act), T64(adv), T64(mask),
        torch.Generator().manual_seed(0))
    for k in ("alpha", "delta", "surr_before", "surr_after", "kl_dist"):
        close(st_t[k], st_j[k], SOLVE_TOL)
    close_tree(new_t, new_j, SOLVE_TOL)
    steps = st_t["line_search_steps"]
    if case == "exhausted":
        assert steps == 100 and float(st_t["alpha"]) == 0.0
        close_tree(new_t, jp.params, 0.0)
        return
    # the accepted step: KL under the bound, the one before it not
    assert float(st_t["kl_dist"]) < kl_dist
    alpha0 = float(st_t["alpha"]) / 0.9 ** steps
    assert (steps <= 2) if case == "loose" else (steps >= 10)
    if steps:
        prev = tF.apply_step(tp.config, tp.params, st_t["npg_grad"],
                             alpha0 * 0.9 ** (steps - 1))
        assert float(tF.mean_kl(tp.config, prev, tp.params, tp.transforms,
                                T64(obs), T64(mask))) >= kl_dist


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------

def ppo_pair(env, log_std, learn_rate):
    spec, jp, tp = policies(log_std)
    kw = dict(clip_coef=0.2, epochs=2, mb_size=32, learn_rate=learn_rate)
    jagent = JaxPPO(None, jp, None, **kw)
    tagent = PPO(env, tp, thost.ZeroBaseline(spec, device="cpu"),
                 device="cpu", **kw)
    return jagent, tagent, jp, tp


@pytest.mark.parametrize("case", ["plain", "log_std_at_min"])
def test_ppo_two_updates_match_jax(env, case):
    """Two updates in a row: the second starts from the first's parameters
    and Adam state.  log_std_at_min: two log_std entries start just above
    min_log_std (-3) and a batch that rewards narrowing drives them into the
    clamp, applied after every Adam step."""
    if case == "plain":
        jagent, tagent, jp, tp = ppo_pair(env, [-0.3, 0.1, -1.0, 0.0], 3e-3)
    else:
        jagent, tagent, jp, tp = ppo_pair(env, [-2.99, 0.1, -2.995, 0.0],
                                          3e-3)
    jparams, tparams = jp.params, tp.params
    jopt, topt = jagent.opt_state, tagent.opt_state
    update = jax.jit(jagent._update_core)
    for it, key in enumerate(jax.random.split(jax.random.PRNGKey(3), 2)):
        obs, act, adv, mask = on_policy_batch(
            tp, 20 + it, sharpen=case == "log_std_at_min")
        n = obs.shape[0]
        idxs = np.array(jax.random.randint(key, (2 * (n // 32), 32), 0, n))
        J = jnp.asarray
        jparams, st_j, jopt = update(jparams, jp.transforms, J(obs), J(act),
                                     J(adv), J(mask), key, jopt)
        tparams, st_t, topt = tagent._update_core(
            tparams, tp.transforms, T64(obs), T64(act), T64(adv), T64(mask),
            None, topt, idxs=idxs)
        close_tree(tparams, jparams, PPO_TOL)
        for k in ("surr_before", "surr_after", "kl_dist"):
            close(st_t[k], st_j[k], PPO_TOL)
        assert topt["count"] == int(jopt[0].count) == 14 * (it + 1)
        close(topt["mu"]["log_std"], jopt[0].mu["log_std"], PPO_TOL)
        close(topt["nu"]["layers.1.weight"].T, jopt[0].nu["layers"][1]["w"],
              PPO_TOL)
        tp.params = tparams                # the next batch's actions
    if case == "log_std_at_min":
        ls = tparams["log_std"]
        assert float(ls[0]) == float(ls[2]) == -3.0
    else:
        assert float(st_t["surr_after"]) > float(st_t["surr_before"])


def test_ppo_surrogate_matches_jax(env):
    """The clipped surrogate at moved parameters, with and without a mask,
    against the JAX package's ``ppo_surrogate``."""
    jagent, tagent, jp, tp = ppo_pair(env, [-0.3, 0.1, -1.0, 0.0], 3e-3)
    obs, act, adv, mask = on_policy_batch(tp, 40)
    rng = np.random.RandomState(41)
    p_new = {k: v + 0.3 * T64(rng.normal(size=tuple(v.shape)))
             for k, v in tp.params.items()}
    jp_new = to_jax(convert.params_to_numpy(p_new))
    ll_old = tF.log_likelihoods(tp.config, tp.params, tp.transforms,
                                T64(obs), T64(act))
    J = jnp.asarray
    for m in (None, mask):
        got = tagent.ppo_surrogate(p_new, ll_old, tp.transforms, T64(obs),
                                   T64(act), T64(adv),
                                   None if m is None else T64(m))
        want = jagent.ppo_surrogate(jp_new, jp.params, jp.transforms,
                                    J(obs), J(act), J(adv),
                                    None if m is None else J(m))
        close(got, want, 1e-12)


def test_ppo_update_draws_indices_from_the_generator(env):
    _, tagent, _, tp = ppo_pair(env, [-0.3, 0.1, -1.0, 0.0], 3e-3)
    obs, act, adv, mask = (T64(a) for a in on_policy_batch(tp, 30))
    g1 = torch.Generator().manual_seed(8)
    idxs = torch.randint(0, 240, (14, 32),
                         generator=torch.Generator().manual_seed(8))
    a, _, opt_a = tagent._update_core(tp.params, tp.transforms, obs, act, adv,
                                      mask, g1, tagent.opt_state)
    b, _, _ = tagent._update_core(tp.params, tp.transforms, obs, act, adv,
                                  mask, None, tagent.opt_state, idxs=idxs)
    close_tree(a, convert.params_to_numpy(b), 0.0)
    # the agent's own Adam state is not changed by a call that returns one
    assert tagent.opt_state["count"] == 0 and opt_a["count"] == 14


def test_ppo_agent_pickles_its_adam_state_on_the_cpu(env):
    _, tagent, _, tp = ppo_pair(env, [-0.3, 0.1, -1.0, 0.0], 3e-3)
    from mjrl_tpu_torch.envs import GymEnv
    tagent.env = GymEnv(env)
    tagent.train_step(4, horizon=5, gamma=0.99, gae_lambda=0.9)
    # 4 x 5 samples: one minibatch of 32 per epoch, 2 epochs
    assert tagent.opt_state["count"] == 2
    copy = pickle.loads(pickle.dumps(tagent))
    assert copy.opt_state["count"] == tagent.opt_state["count"]
    for k, v in tagent.opt_state["mu"].items():
        assert copy.opt_state["mu"][k].device.type == "cpu"
        assert torch.equal(copy.opt_state["mu"][k], v)
