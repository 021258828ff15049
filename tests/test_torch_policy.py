"""Port vs JAX package: policy network, distributions, flat-vector helpers.

Weights are made with numpy from a seed in the JAX package's layout, carried
across by ``mjrl_tpu_torch.convert`` and the same numpy inputs go through both
packages in float64.  Tolerance 1e-12 (rtol and atol): a 3-layer tanh MLP and
closed-form Gaussian formulas differ only in the last digits of tanh / exp
and in summation order.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import distributions as jdist
from mjrl_tpu.models import policies as jpol
from mjrl_tpu.models.fc_network import Transforms as JTransforms
from mjrl_tpu_torch import convert
from mjrl_tpu_torch import distributions as tdist
from mjrl_tpu_torch.envs.base import EnvSpec
from mjrl_tpu_torch.models import policies as tpol
from mjrl_tpu_torch.models.fc_network import (identity_transforms,
                                              make_transforms)
from mjrl_tpu_torch.ops import flat

TOL = 1e-12
OBS, ACT, HID = 12, 4, (16, 16)


def close(a, b, tol=TOL):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


def numpy_params(seed, hidden=HID, obs=OBS, act=ACT):
    """JAX-layout policy pytree with numpy leaves."""
    rng = np.random.RandomState(seed)
    sizes = (obs,) + tuple(hidden) + (act,)
    return {"layers": [{"w": rng.normal(0, 0.4, (sizes[i], sizes[i + 1])),
                        "b": rng.normal(0, 0.1, (sizes[i + 1],))}
                       for i in range(len(sizes) - 1)],
            "log_std": rng.uniform(-1.0, 0.3, (act,))}


def numpy_transforms(seed):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 0.3, OBS), rng.uniform(0.5, 2.0, OBS),
            rng.normal(0, 0.3, ACT), rng.uniform(0.5, 2.0, ACT))


def to_jax(tree):
    import jax
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)


@pytest.fixture(scope="module")
def pair():
    """(JAX config, params, transforms), (port module, params, transforms)
    holding the same weights."""
    p_np, t_np = numpy_params(0), numpy_transforms(1)
    jcfg = jpol.GaussianMLP(OBS, ACT, HID)
    tcfg = tpol.GaussianMLP(OBS, ACT, HID, dtype=torch.float64, device="cpu")
    tparams = convert.params_from_numpy(p_np, torch.float64, "cpu")
    ttr = make_transforms(OBS, ACT, *t_np, dtype=torch.float64, device="cpu")
    return ((jcfg, to_jax(p_np), JTransforms(*to_jax(list(t_np)))),
            (tcfg, tparams, ttr))


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(2)
    return rng.normal(0, 1.0, (50, OBS)), rng.normal(0, 1.0, (50, ACT))


def test_dist_info_matches_jax(pair, data):
    (jcfg, jp, jt), (tcfg, tp, tt) = pair
    obs, _ = data
    jmu, jls = jcfg.dist_info(jp, jt, jnp.asarray(obs))
    tmu, tls = tcfg.dist_info(tp, tt, torch.tensor(obs))
    close(tmu, jmu)
    close(tls, jls)


def test_log_likelihood_matches_jax(pair, data):
    (jcfg, jp, jt), (tcfg, tp, tt) = pair
    obs, act = data
    close(tcfg.log_likelihood(tp, tt, torch.tensor(obs), torch.tensor(act)),
          jcfg.log_likelihood(jp, jt, jnp.asarray(obs), jnp.asarray(act)))


def test_mean_kl_matches_jax(pair, data):
    (jcfg, jp, jt), (tcfg, tp, tt) = pair
    obs, _ = data
    other = numpy_params(5)
    jk = jcfg.mean_kl(to_jax(other), jp, jt, jnp.asarray(obs))
    tk = tcfg.mean_kl(convert.params_from_numpy(other, torch.float64), tp, tt,
                      torch.tensor(obs))
    assert float(jk) > 0.01
    close(tk, jk)


@pytest.mark.parametrize("fn", ["log_likelihood", "kl_divergence", "mean_kl",
                                "likelihood_ratio", "entropy"])
def test_distribution_closed_forms_match_jax(fn):
    rng = np.random.RandomState(3)
    a, m0, m1 = (rng.normal(0, 1, (9, 5, ACT)) for _ in range(3))
    ls0, ls1 = rng.uniform(-2, 0.5, ACT), rng.uniform(-2, 0.5, ACT)
    T, J = torch.tensor, jnp.asarray
    args = {"log_likelihood": (a, m0, ls0),
            "kl_divergence": (m0, ls0, m1, ls1),
            "mean_kl": (m0, ls0, m1, ls1),
            "likelihood_ratio": (a[..., 0], m0[..., 0]),
            "entropy": (ls0,)}[fn]
    close(getattr(tdist, fn)(*map(T, args)),
          getattr(jdist, fn)(*map(J, args)))


def test_sample_is_mean_plus_std_times_noise():
    """dist.sample draws standard normal noise from the generator."""
    g = torch.Generator().manual_seed(4)
    mean = torch.zeros((20000, ACT), dtype=torch.float64)
    ls = torch.tensor([-1.0, 0.0, 0.5, 1.0], dtype=torch.float64)
    x = tdist.sample(g, mean, ls)
    close(x.std(0), torch.exp(ls), tol=0.05)
    g2 = torch.Generator().manual_seed(4)
    eps = torch.randn(mean.shape, generator=g2, dtype=torch.float64)
    close(x, torch.exp(ls) * eps, tol=0.0)


def test_convert_round_trip():
    p_np = numpy_params(7)
    back = convert.params_to_numpy(convert.params_from_numpy(
        p_np, torch.float64))
    for la, lb in zip(p_np["layers"], back["layers"]):
        close(lb["w"], la["w"], 0.0)
        close(lb["b"], la["b"], 0.0)
    close(back["log_std"], p_np["log_std"], 0.0)


def test_convert_policy_object_and_clamp():
    """policy_params_from_numpy loads new and old copies, applies the
    min_log_std clamp as on every parameter set, and takes transforms."""
    spec = EnvSpec(OBS, ACT, 20)
    pol = tpol.MLP(spec, hidden_sizes=HID, dtype=torch.float64, device="cpu")
    p_np = numpy_params(8)
    p_np["log_std"][0] = -7.0
    convert.policy_params_from_numpy(pol, p_np, numpy_transforms(9))
    assert float(pol.params["log_std"][0]) == -3.0
    assert float(pol.old_params["log_std"][0]) == -3.0
    out, tr = convert.policy_params_to_numpy(pol)
    close(out["layers"][1]["w"], p_np["layers"][1]["w"], 0.0)
    close(tr[1], numpy_transforms(9)[1], 0.0)
    # the old copy is a copy: writing the live parameters leaves it alone
    before = pol.old_params["layers.0.bias"].clone()
    pol.params = {k: v + 1.0 for k, v in pol.params.items()}
    close(pol.old_params["layers.0.bias"], before, 0.0)


def test_policy_protocol_matches_jax_policy(data):
    """Stateful wrappers: old/new dist info, likelihood ratio and KL after
    the same weights were loaded into both."""
    obs, act = data
    spec = EnvSpec(OBS, ACT, 20)
    jp = jpol.MLP(spec, hidden_sizes=HID)
    tp = tpol.MLP(spec, hidden_sizes=HID, dtype=torch.float64, device="cpu")
    new, old = numpy_params(10), numpy_params(11)
    jp.params, jp.old_params = to_jax(new), to_jax(old)
    jp.transforms = JTransforms(*to_jax(list(numpy_transforms(12))))
    convert.policy_params_from_numpy(tp, new, numpy_transforms(12))
    tp.old_params = convert.params_from_numpy(old, torch.float64)
    jn, jo = jp.new_dist_info(obs, act), jp.old_dist_info(obs, act)
    tn, to = tp.new_dist_info(obs, act), tp.old_dist_info(obs, act)
    # the JAX wrapper casts observations and actions to float32 on the way
    # in, so this comparison is at float32 resolution: 1e-5, and 1e-4 on the
    # ratio, which exponentiates log-likelihoods of magnitude ~30
    for k in range(3):
        close(tn[k], jn[k], 1e-5)
        close(to[k], jo[k], 1e-5)
    close(tp.likelihood_ratio(tn, to), jp.likelihood_ratio(jn, jo), 1e-4)
    close(tp.mean_kl(tn, to), jp.mean_kl(jn, jo), 1e-5)
    close(tp.log_likelihood(obs, act), jp.log_likelihood(obs, act), 1e-5)


def test_init_distribution_and_last_layer_scale():
    """W, b ~ U(-k, k), k = 1/sqrt(fan_in); last layer scaled by 1e-2;
    log_std at init_log_std; identity transforms; seeded."""
    spec = EnvSpec(OBS, ACT, 20)
    pol = tpol.MLP(spec, hidden_sizes=(64, 64), seed=3, device="cpu",
                   init_log_std=-0.5)
    p = pol.params
    for i, fan_in, scale in ((0, OBS, 1.0), (1, 64, 1.0), (2, 64, 1e-2)):
        k = scale / np.sqrt(fan_in)
        w = p[f"layers.{i}.weight"]
        assert float(w.abs().max()) <= k
        if w.numel() > 500:
            assert float(w.abs().max()) > 0.9 * k
            assert abs(float(w.mean())) < 0.1 * k
    close(p["log_std"], np.full(ACT, -0.5), 0.0)
    close(pol.transforms.in_scale, np.ones(OBS), 0.0)
    again = tpol.MLP(spec, hidden_sizes=(64, 64), seed=3, device="cpu")
    close(again.params["layers.1.weight"], p["layers.1.weight"], 0.0)
    assert pol.d == sum(v.numel() for v in p.values()) == pol.n * 64 + 64 \
        + 64 * 64 + 64 + 64 * pol.m + pol.m + pol.m


def test_get_set_param_values_and_clamp():
    spec = EnvSpec(OBS, ACT, 20)
    pol = tpol.MLP(spec, hidden_sizes=HID, device="cpu")
    vec = pol.get_param_values()
    assert vec.shape == (pol.d,) and vec.dtype == np.float64
    # named_parameters order: log_std first, then the layers
    assert list(pol.params)[0] == "log_std"
    vec2 = vec + 0.25
    vec2[:ACT] = -9.0
    pol.set_param_values(vec2, set_new=True, set_old=False)
    got = pol.get_param_values()
    close(got[ACT:], vec2[ACT:].astype(np.float32), 1e-7)
    close(got[:ACT], np.full(ACT, -3.0), 0.0)
    close(flat.ravel(pol.old_params)[0].numpy(), vec.astype(np.float32), 0.0)


def test_get_action_contract():
    spec = EnvSpec(OBS, ACT, 20)
    pol = tpol.MLP(spec, hidden_sizes=HID, device="cpu")
    a, info = pol.get_action(np.zeros(OBS))
    assert a.shape == (ACT,) and set(info) == {"mean", "log_std",
                                               "evaluation"}
    close(info["evaluation"], info["mean"], 0.0)
    lin = tpol.LinearPolicy(spec, device="cpu")
    assert sorted(lin.params) == ["layers.0.bias", "layers.0.weight",
                                  "log_std"]


def test_module_forward_is_dist_info(pair, data):
    """GaussianMLP is an nn.Module: forward = dist_info on its own
    parameters."""
    _, (tcfg, tp, tt) = pair
    obs = torch.tensor(data[0])
    tcfg.load_param_dict(tp)
    mu, ls = tcfg(obs, tt)
    close(mu, tcfg.dist_info(tp, tt, obs)[0], 0.0)
    assert isinstance(tcfg, torch.nn.Module)
    assert len(list(tcfg.parameters())) == 2 * (len(HID) + 1) + 1
    mu_id, _ = tcfg(obs)
    close(mu_id, tcfg.dist_info(tp, identity_transforms(
        OBS, ACT, torch.float64), obs)[0], 0.0)


def test_policy_pickles_with_cpu_tensors():
    spec = EnvSpec(OBS, ACT, 20)
    pol = tpol.MLP(spec, hidden_sizes=HID, device="cpu")
    pol.get_action(np.zeros(OBS))
    clone = pickle.loads(pickle.dumps(pol))
    close(clone.get_param_values(), pol.get_param_values(), 0.0)
    # the generator state travels: both draw the same next action
    close(clone.get_action(np.ones(OBS))[0], pol.get_action(np.ones(OBS))[0],
          0.0)


@pytest.mark.parametrize("op", ["dot", "add_scaled", "scale", "zeros",
                                "ravel"])
def test_tree_helpers(op):
    rng = np.random.RandomState(6)
    a = {"x": torch.tensor(rng.normal(size=(3, 2))),
         "y": torch.tensor(rng.normal(size=(4,)))}
    b = {k: v * 2.0 + 1.0 for k, v in a.items()}
    fa, unravel = flat.ravel(a)
    fb, _ = flat.ravel(b)
    if op == "dot":
        close(flat.tree_dot(a, b), fa @ fb)
    elif op == "add_scaled":
        close(flat.ravel(flat.tree_add_scaled(a, b, 0.3))[0], fa + 0.3 * fb)
    elif op == "scale":
        close(flat.ravel(flat.tree_scale(a, -2.0))[0], -2.0 * fa)
    elif op == "zeros":
        assert float(flat.ravel(flat.tree_zeros_like(a))[0].abs().sum()) == 0
    else:
        back = unravel(fa)
        assert all(torch.equal(back[k], a[k]) for k in a)
        assert torch.equal(flat.ravel(flat.unravel_like(fb, a))[0], fb)
