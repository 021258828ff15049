"""Port vs JAX package: sample processing, CG, the NPG update, the linear
baseline (CPU, float64, numpy-seeded inputs).

Tolerances: 1e-12 for the scans and closed forms (GAE, returns, whitening:
same recurrences in the same order); 1e-8 for CG, the Fisher-vector product,
one whole NPG update and the least-squares fit, where ten CG iterations or a
linear solve amplify last-digit differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.algos import functional as jF
from mjrl_tpu.algos.npg_cg import NPG as JaxNPG
from mjrl_tpu.models import baselines as jbl
from mjrl_tpu.models import policies as jpol
from mjrl_tpu.models.fc_network import Transforms as JTransforms
from mjrl_tpu.ops import cg as jcg
from mjrl_tpu.ops import gae as jgae
from mjrl_tpu_torch import baselines as thost
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos import NPG, BatchREINFORCE
from mjrl_tpu_torch.algos import functional as tF
from mjrl_tpu_torch.envs.base import EnvSpec
from mjrl_tpu_torch.envs.swimmer import SwimmerEnv
from mjrl_tpu_torch.models import baselines as tbl
from mjrl_tpu_torch.models import policies as tpol
from mjrl_tpu_torch.models.fc_network import make_transforms
from mjrl_tpu_torch.ops import cg as tcg
from mjrl_tpu_torch.ops import gae as tgae

from test_torch_policy import numpy_params, numpy_transforms, to_jax

SCAN_TOL, SOLVE_TOL = 1e-12, 1e-8
OBS, ACT, HID = 12, 4, (16, 16)
T64 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64)


def close(a, b, tol):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


def close_tree(tparams, jparams, tol):
    """Port parameter dict vs JAX pytree, through convert's layout map."""
    got = convert.params_to_numpy(tparams)
    for lg, lj in zip(got["layers"], jparams["layers"]):
        close(lg["w"], lj["w"], tol)
        close(lg["b"], lj["b"], tol)
    close(got["log_std"], jparams["log_std"], tol)


# ---------------------------------------------------------------------------
# returns / GAE / whitening
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ragged():
    """(N, T) rewards and values with a ragged prefix mask; three of the
    short paths terminated, the full-length ones were truncated."""
    rng = np.random.RandomState(0)
    N, T = 7, 25
    lengths = np.array([25, 25, 3, 11, 1, 25, 18])
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float64)
    terminated = np.array([False, False, True, True, True, False, False])
    return (rng.normal(size=(N, T)), rng.normal(size=(N, T)), mask,
            terminated)


def test_discount_sum_matches_jax(ragged):
    r = ragged[0]
    for terminal in (0.0, 1.5):
        close(tgae.discount_sum(T64(r), 0.97, terminal),
              jax.vmap(lambda x: jgae.discount_sum(x, 0.97, terminal))(
                  jnp.asarray(r)), SCAN_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_discounted_returns_match_jax(ragged, masked):
    r, _, mask, _ = ragged
    if masked:
        want = jax.vmap(jgae.discounted_returns, (0, None, 0))(
            jnp.asarray(r), 0.995, jnp.asarray(mask))
        got = tgae.discounted_returns(T64(r), 0.995, T64(mask))
        assert float((got * (1 - T64(mask))).abs().sum()) == 0.0
    else:
        want = jax.vmap(jgae.discounted_returns, (0, None))(
            jnp.asarray(r), 0.995)
        got = tgae.discounted_returns(T64(r), 0.995)
    close(got, want, SCAN_TOL)


@pytest.mark.parametrize("lam", [0.97, 0.0, 1.0, None, 1.5])
@pytest.mark.parametrize("masked", [False, True])
def test_gae_matches_jax(ragged, lam, masked):
    """GAE with the mask-boundary bootstrap: terminated -> 0, truncated ->
    V(last valid obs); lam None / out of range -> returns - values."""
    r, v, mask, term = ragged
    if masked:
        want = jax.vmap(jgae.gae_advantages, (0, 0, None, None, 0, 0))(
            jnp.asarray(r), jnp.asarray(v), 0.995, lam, jnp.asarray(term),
            jnp.asarray(mask))
        got = tgae.gae_advantages(T64(r), T64(v), 0.995, lam,
                                  torch.tensor(term), T64(mask))
    else:
        want = jax.vmap(jgae.gae_advantages, (0, 0, None, None, 0))(
            jnp.asarray(r), jnp.asarray(v), 0.995, lam, jnp.asarray(term))
        got = tgae.gae_advantages(T64(r), T64(v), 0.995, lam,
                                  torch.tensor(term))
    close(got, want, SCAN_TOL)


def test_gae_single_path_and_scalar_terminated(ragged):
    r, v, _, _ = ragged
    for term in (False, True):
        close(tgae.gae_advantages(T64(r[0]), T64(v[0]), 0.99, 0.9, term),
              jgae.gae_advantages(jnp.asarray(r[0]), jnp.asarray(v[0]), 0.99,
                                  0.9, term), SCAN_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_whiten_matches_jax(ragged, masked):
    r, _, mask, _ = ragged
    m = mask.reshape(-1) if masked else None
    got = tgae.whiten(T64(r.reshape(-1)), None if m is None else T64(m))
    want = jgae.whiten(jnp.asarray(r.reshape(-1)),
                       None if m is None else jnp.asarray(m))
    close(got, want, SCAN_TOL)


def test_done_aware_scans_wait_for_autoreset():
    x = torch.zeros((2, 3))
    with pytest.raises(NotImplementedError, match="queue 1"):
        tgae.returns_with_dones(x, x, 0.9)
    with pytest.raises(NotImplementedError, match="queue 1"):
        tgae.gae_with_dones(x, x, x, x[:, 0], 0.9, 0.9)


# ---------------------------------------------------------------------------
# conjugate gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_x0", [False, True])
@pytest.mark.parametrize("iters", [3, 10, 40])
def test_cg_matches_jax(use_x0, iters):
    """Same iterates as the JAX solver, x0 honoured, and frozen once the
    squared residual is below the tolerance (40 iterations on a 12-dim
    system converge early and stay put)."""
    rng = np.random.RandomState(1)
    a = rng.normal(size=(12, 12))
    a = a @ a.T + 0.5 * np.eye(12)
    b = rng.normal(size=12)
    x0 = rng.normal(size=12) if use_x0 else None
    want = jcg.cg_solve(lambda x: jnp.asarray(a) @ x, jnp.asarray(b),
                        x0=None if x0 is None else jnp.asarray(x0),
                        cg_iters=iters)
    got = tcg.cg_solve(lambda x: T64(a) @ x, T64(b),
                       x0=None if x0 is None else T64(x0), cg_iters=iters)
    close(got, want, SOLVE_TOL)
    if iters == 40:
        close(got, np.linalg.solve(a, b), 1e-6)


def test_cg_on_parameter_dicts():
    rng = np.random.RandomState(2)
    d = {"a": T64(rng.uniform(1, 2, (3, 2))), "b": T64(rng.uniform(1, 2, 4))}
    rhs = {"a": T64(rng.normal(size=(3, 2))), "b": T64(rng.normal(size=4))}
    x = tcg.cg_solve(lambda v: {k: d[k] * v[k] for k in v}, rhs, cg_iters=20)
    # the solver stops updating once |r|^2 < 1e-10, i.e. |r| ~ 1e-5
    for k in rhs:
        close(x[k], rhs[k] / d[k], 1e-4)


# ---------------------------------------------------------------------------
# the NPG update
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def agents():
    """NPG agents of both packages around the same 16-16 policy weights and
    input/output transforms."""
    spec = EnvSpec(OBS, ACT, 20)
    p_np, t_np = numpy_params(4), numpy_transforms(5)
    p_np["log_std"] = np.array([-0.3, 0.1, -2.9, 0.0])
    jpolicy = jpol.MLP(spec, hidden_sizes=HID)
    jpolicy.params = jpolicy.old_params = to_jax(p_np)
    jpolicy.transforms = JTransforms(*to_jax(list(t_np)))
    tpolicy = tpol.MLP(spec, hidden_sizes=HID, dtype=torch.float64,
                       device="cpu")
    convert.policy_params_from_numpy(tpolicy, p_np, t_np)
    tenv = SwimmerEnv(dtype=torch.float64, device="cpu")
    tbase = thost.LinearBaseline(spec, dtype=torch.float64, device="cpu")

    def make(**kw):
        return (JaxNPG(None, jpolicy, None, **kw),
                NPG(tenv, tpolicy, tbase, device="cpu", **kw))
    return make, jpolicy, tpolicy


@pytest.fixture(scope="module")
def batch(agents):
    """(obs, act, adv, mask) with actions drawn from the policy itself (mean
    + std * numpy noise), as an on-policy batch has them."""
    rng = np.random.RandomState(3)
    n = 240
    mask = np.ones(n)
    mask[rng.choice(n, 30, replace=False)] = 0.0
    obs = rng.normal(size=(n, OBS))
    tp = agents[2]
    mean, log_std = tp.config.dist_info(tp.params, tp.transforms, T64(obs))
    act = mean.detach().numpy() \
        + np.exp(log_std.detach().numpy()) * rng.normal(size=(n, ACT))
    return obs, act, rng.normal(size=n), mask


def test_surrogate_kl_and_gradient_match_jax(agents, batch):
    _, jp, tp = agents
    obs, act, adv, mask = batch
    other = numpy_params(6)
    jo, to = to_jax(other), convert.params_from_numpy(other, torch.float64)
    J, cfg_j, cfg_t = jnp.asarray, jp.config, tp.config
    close(tF.cpi_surrogate(cfg_t, to, tp.params, tp.transforms, T64(obs),
                           T64(act), T64(adv), T64(mask)),
          jF.cpi_surrogate(cfg_j, jo, jp.params, jp.transforms, J(obs),
                           J(act), J(adv), J(mask)), 1e-10)
    close(tF.mean_kl(cfg_t, to, tp.params, tp.transforms, T64(obs),
                     T64(mask)),
          jF.mean_kl(cfg_j, jo, jp.params, jp.transforms, J(obs), J(mask)),
          1e-10)
    g_t = tF.vpg_grad(cfg_t, tp.params, tp.params, tp.transforms, T64(obs),
                      T64(act), T64(adv), T64(mask))
    g_j = jF.vpg_grad(cfg_j, jp.params, jp.params, jp.transforms, J(obs),
                      J(act), J(adv), J(mask))
    close_tree(g_t, g_j, 1e-10)


@pytest.mark.parametrize("masked", [False, True])
def test_fisher_vector_product_matches_jax(agents, batch, masked):
    """F v + damping v: the port's double backward against the JAX
    package's jvp-of-grad, on a random direction (1e-8)."""
    _, jp, tp = agents
    obs, _, _, mask = batch
    m_t, m_j = (T64(mask), jnp.asarray(mask)) if masked else (None, None)
    v_np = numpy_params(7)
    hv_t = tF.make_hvp(tp.config, tp.params, tp.transforms, T64(obs), m_t,
                       damping=1e-3)(
        convert.params_from_numpy(v_np, torch.float64))
    hv_j = jF.make_hvp(jp.config, jp.params, jp.transforms, jnp.asarray(obs),
                       m_j, damping=1e-3)(to_jax(v_np))
    close_tree(hv_t, hv_j, SOLVE_TOL)


def test_hvp_subsample_uses_a_row_subset(agents, batch):
    """hvp_sample_frac < 1 evaluates the Fisher matrix on a random subset of
    rows drawn from the generator: reproducible, and different from the
    full-batch product."""
    _, _, tp = agents
    obs = T64(batch[0])
    v = convert.params_from_numpy(numpy_params(7), torch.float64)
    mk = lambda seed, frac: tF.make_hvp(
        tp.config, tp.params, tp.transforms, obs, None, 1e-4,
        torch.Generator().manual_seed(seed), frac)(v)["layers.0.weight"]
    full = mk(0, 1.0)
    close(mk(1, 0.25), mk(1, 0.25), 0.0)
    assert float((mk(1, 0.25) - full).abs().max()) > 1e-6
    # the subset is what randperm(n)[:k] of that generator selects
    idx = torch.randperm(240, generator=torch.Generator().manual_seed(1))[:60]
    want = tF.make_hvp(tp.config, tp.params, tp.transforms, obs[idx], None,
                       1e-4)(v)["layers.0.weight"]
    close(mk(1, 0.25), want, 1e-12)


@pytest.mark.parametrize("kw, guard", [
    (dict(normalized_step_size=0.05), "may"),
    (dict(normalized_step_size=4.0), "must"),
    (dict(normalized_step_size=4.0, kl_guard=0), "off"),
    (dict(const_learn_rate=0.02), "off"),
    (dict(kl_dist=0.02, FIM_invert_args={"iters": 5, "damping": 1e-2}),
     "may"),
], ids=["step0.05", "step4_guard", "step4_noguard", "const_lr", "kl_dist"])
def test_npg_update_core_matches_jax(agents, batch, kw, guard):
    """One whole NPG update on a fixed batch: vanilla gradient, natural
    gradient, step size (after the KL guard's backtracking), new parameters
    and the logged statistics, at 1e-8."""
    make, jp, tp = agents
    jagent, tagent = make(**kw)
    obs, act, adv, mask = batch
    J = jnp.asarray
    new_j, st_j = jax.jit(jagent._update_core)(
        jp.params, jp.transforms, J(obs), J(act), J(adv), J(mask),
        jax.random.PRNGKey(0))
    new_t, st_t = tagent._update_core(
        tp.params, tp.transforms, T64(obs), T64(act), T64(adv), T64(mask),
        torch.Generator().manual_seed(0))
    g_j, npg_j = jF.npg_direction(
        jp.config, jp.params, jp.transforms, J(obs), J(act), J(adv), J(mask),
        damping=jagent.FIM_invert_args["damping"],
        cg_iters=jagent.FIM_invert_args["iters"])
    close_tree(st_t["vpg_grad"], g_j, SOLVE_TOL)
    close_tree(st_t["npg_grad"], npg_j, SOLVE_TOL)
    for k in ("alpha", "delta", "surr_before", "surr_after", "kl_dist"):
        close(st_t[k], st_j[k], SOLVE_TOL)
    close_tree(new_t, new_j, SOLVE_TOL)
    # min_log_std clamp on the new parameters
    assert float(new_t["log_std"].min()) >= -3.0
    alpha0, _ = tF.npg_step_size(st_t["vpg_grad"], st_t["npg_grad"],
                                 tagent.n_step_size, tagent.alpha)
    # the KL guard backtracks the adaptive step only (x0.7, <= 10 times)
    if guard == "off":
        assert float(st_t["alpha"]) == float(alpha0)
    else:
        k = np.log(float(st_t["alpha"]) / float(alpha0)) / np.log(0.7)
        assert abs(k - round(k)) < 1e-9 and 0 <= round(k) <= 10
        assert round(k) > 0 or guard == "may"
        cap = tagent.kl_guard * 0.5 * tagent.n_step_size
        assert float(st_t["kl_dist"]) <= cap or round(k) == 10


def test_batch_reinforce_update_core_matches_jax(agents, batch):
    """The base class's plain gradient step with the KL-targeted halving
    line search (1e-8)."""
    from mjrl_tpu.algos.batch_reinforce import \
        BatchREINFORCE as JaxBatchREINFORCE
    make, jp, tp = agents
    _, tnpg = make()
    obs, act, adv, mask = batch
    J = jnp.asarray
    jagent = JaxBatchREINFORCE(None, jp, None, learn_rate=0.5,
                               desired_kl=0.01)
    tagent = BatchREINFORCE(tnpg.env, tp, tnpg.baseline, learn_rate=0.5,
                            desired_kl=0.01, device="cpu")
    new_j, st_j = jax.jit(jagent._update_core)(
        jp.params, jp.transforms, J(obs), J(act), J(adv), J(mask),
        jax.random.PRNGKey(0))
    new_t, st_t = tagent._update_core(
        tp.params, tp.transforms, T64(obs), T64(act), T64(adv), T64(mask),
        None)
    assert float(st_t["alpha"]) < 0.5                 # the search halved
    for k in ("alpha", "surr_before", "surr_after", "kl_dist"):
        close(st_t[k], st_j[k], SOLVE_TOL)
    close_tree(new_t, new_j, SOLVE_TOL)


# ---------------------------------------------------------------------------
# baselines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def paths_batch(ragged):
    rng = np.random.RandomState(8)
    _, _, mask, _ = ragged
    obs = rng.normal(0, 6.0, mask.shape + (OBS,))   # some beyond the +-10 clip
    rets = rng.normal(size=mask.shape) + obs[..., 0]
    return obs, rets * mask, mask


def test_linear_baseline_features_match_jax(paths_batch):
    obs = paths_batch[0]
    close(tbl.LinearBaseline(OBS).features(T64(obs)),
          jbl.LinearBaseline(OBS).features(jnp.asarray(obs)), SCAN_TOL)
    close(tbl.time_features(25, torch.float64),
          jbl.time_features(25, jnp.float64), SCAN_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_linear_baseline_fit_predict_match_jax(paths_batch, masked):
    obs, rets, mask = paths_batch
    jcfg, tcfg = jbl.LinearBaseline(OBS), tbl.LinearBaseline(OBS)
    c0 = np.random.RandomState(9).normal(size=OBS + 5)
    m_j, m_t = (jnp.asarray(mask), T64(mask)) if masked else (None, None)
    cj, e0j, e1j = jcfg.fit(jnp.asarray(c0), jnp.asarray(obs),
                            jnp.asarray(rets), m_j)
    ct, e0t, e1t = tcfg.fit(T64(c0), T64(obs), T64(rets), m_t)
    close(ct, cj, SOLVE_TOL)
    close(e0t, e0j, SOLVE_TOL)
    close(e1t, e1j, SOLVE_TOL)
    assert float(e1t) < float(e0t)
    close(tcfg.predict(ct, T64(obs)), jcfg.predict(cj, jnp.asarray(obs)),
          SOLVE_TOL)


def test_lstsq_retry_raises_the_regulariser_on_nan():
    """A NaN solution multiplies reg by 10 and tries again (up to 10
    times): an all-zero feature matrix with reg 0 is singular, and NaN
    returns poison every attempt -> the zero coefficients stay."""
    feat = torch.zeros((6, 3), dtype=torch.float64)
    rets = torch.ones(6, dtype=torch.float64)
    out = tbl._lstsq_with_retry(feat, rets, 1e-5)
    close(out, np.zeros(3), 0.0)                     # F^T R = 0 -> c = 0
    bad = tbl._lstsq_with_retry(feat, rets * float("nan"), 1e-5)
    close(bad, np.zeros(3), 0.0)                     # never found: init
    feat2 = T64(np.random.RandomState(10).normal(size=(20, 3)))
    want = np.linalg.solve(feat2.numpy().T @ feat2.numpy() + 1e-5 * np.eye(3),
                           feat2.numpy().T @ np.ones(20))
    close(tbl._lstsq_with_retry(feat2, torch.ones(20, dtype=torch.float64),
                                1e-5), want, 1e-10)


def test_host_baselines(paths_batch):
    """Host wrappers: fit on a list of ragged path dicts = fit on the padded
    batch; predict per path; Zero baseline; the two that wait raise."""
    obs, rets, mask = paths_batch
    spec = EnvSpec(OBS, ACT, 25)
    paths = []
    for i in range(obs.shape[0]):
        n = int(mask[i].sum())
        paths.append(dict(observations=obs[i, :n], rewards=np.zeros(n),
                          returns=rets[i, :n]))
    a = thost.LinearBaseline(spec, dtype=torch.float64, device="cpu")
    b = thost.LinearBaseline(spec, dtype=torch.float64, device="cpu")
    e0, e1 = a.fit(paths, return_errors=True)
    b.fit(dict(observations=obs, returns=rets, mask=mask))
    close(a.state, b.state, 1e-12)
    assert e0 == 1.0 and e1 < 1.0                     # zero coeffs before
    pred = a.predict(paths[3])
    assert pred.shape == (len(paths[3]["returns"]),)
    close(pred, tbl.LinearBaseline(OBS).predict(
        a.state, T64(paths[3]["observations"])[None])[0], 1e-12)
    convert.linear_baseline_from_numpy(b, np.arange(OBS + 5.0))
    close(convert.linear_baseline_to_numpy(b), np.arange(OBS + 5.0), 0.0)
    z = thost.ZeroBaseline(spec, device="cpu")
    assert z.fit(paths, return_errors=True) == (1.0, 1.0)
    assert float(np.abs(z.predict(paths[0])).sum()) == 0.0
    for ctor in (thost.QuadraticBaseline, thost.MLPBaseline):
        with pytest.raises(NotImplementedError, match="M6b"):
            ctor(spec)
