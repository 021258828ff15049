"""Port vs JAX package: the quadratic and MLP baselines (CPU, float64).

The same numpy-seeded observations, returns, masks and weights go through
both packages.  Random draws are injected: the MLP fit's permutations are
the JAX package's own, ``jax.random.permutation`` of each key of
``jax.random.split(key, epochs)``, handed to the port as ``perms``.
Tolerances: 1e-12 for feature maps and predictions (same arithmetic);
1e-8 for the least-squares fit (a linear solve amplifies last digits); 1e-10
relative for the MLP fit, where torch's and optax's Adam evaluate the same
formula in a different order.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.models import baselines as jbl
from mjrl_tpu_torch import baselines as thost
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.envs.base import EnvSpec
from mjrl_tpu_torch.models import baselines as tbl

OBS, N, T = 5, 6, 10
HID = (8, 8)
FEAT_TOL, SOLVE_TOL, ADAM_TOL = 1e-12, 1e-8, 1e-10
T64 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64)


def close(a, b, tol, atol=None):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol,
                               atol=tol if atol is None else atol)


def data(seed, masked):
    """Observations partly beyond the +-10 clip, returns, and a ragged
    prefix mask."""
    rng = np.random.RandomState(seed)
    obs = rng.normal(0, 6.0, (N, T, OBS))
    rets = rng.normal(0, 3.0, (N, T)) + obs[..., 0]
    if not masked:
        return obs, rets, None
    lengths = rng.randint(2, T + 1, N)
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float64)
    return obs, rets, mask


def mlp_layers(seed):
    """MLP baseline weights in the JAX layout (float64 numpy)."""
    rng = np.random.RandomState(seed)
    sizes = (OBS + 4,) + HID + (1,)
    return [{"w": rng.normal(0, 0.5, (sizes[i], sizes[i + 1])),
             "b": rng.normal(0, 0.1, (sizes[i + 1],))}
            for i in range(len(sizes) - 1)]


def jax_perms(key, epochs, n_total):
    return np.stack([np.asarray(jax.random.permutation(k, n_total))
                     for k in jax.random.split(key, epochs)])


# ---------------------------------------------------------------------------
# quadratic baseline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 4, 11])
def test_triu_indices_order_matches_jax(n):
    """Row-major i <= j pairs in both packages: the quadratic features'
    column order."""
    ti, tj = torch.triu_indices(n, n)
    ji, jj = jnp.triu_indices(n)
    assert ti.tolist() == np.asarray(ji).tolist()
    assert tj.tolist() == np.asarray(jj).tolist()
    assert tbl.QuadraticBaseline(n).num_features() == \
        jbl.QuadraticBaseline(n).num_features() == n + n * (n + 1) // 2 + 5


def test_quadratic_features_match_jax():
    obs, _, _ = data(0, False)
    got = tbl.QuadraticBaseline(OBS).features(T64(obs))
    want = jbl.QuadraticBaseline(OBS).features(jnp.asarray(obs))
    assert got.shape == (N, T, OBS + OBS * (OBS + 1) // 2 + 5)
    close(got, want, FEAT_TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_quadratic_fit_and_predict_match_jax(masked):
    obs, rets, mask = data(1, masked)
    tcfg, jcfg = tbl.QuadraticBaseline(OBS), jbl.QuadraticBaseline(OBS)
    tm = None if mask is None else T64(mask)
    jm = None if mask is None else jnp.asarray(mask)
    tc0 = tcfg.init(dtype=torch.float64, device="cpu")
    jc0 = jnp.zeros(jcfg.num_features(), jnp.float64)
    tc, te0, te1 = tcfg.fit(tc0, T64(obs), T64(rets), tm)
    jc, je0, je1 = jcfg.fit(jc0, jnp.asarray(obs), jnp.asarray(rets), jm)
    close(tc, jc, SOLVE_TOL)
    close(te0, je0, SOLVE_TOL)
    close(te1, je1, SOLVE_TOL)
    assert float(te1) < float(te0) == 1.0
    close(tcfg.predict(tc, T64(obs)),
          jcfg.predict(jc, jnp.asarray(obs)), SOLVE_TOL)
    # a second fit from the fitted coefficients (e_before now < 1)
    tc2, te0b, _ = tcfg.fit(tc, T64(obs[::-1].copy()), T64(rets), tm)
    jc2, je0b, _ = jcfg.fit(jc, jnp.asarray(obs[::-1].copy()),
                            jnp.asarray(rets), jm)
    close(tc2, jc2, SOLVE_TOL)
    close(te0b, je0b, SOLVE_TOL)


# ---------------------------------------------------------------------------
# MLP baseline
# ---------------------------------------------------------------------------

def mlp_pair(reg_coef, epochs=2, batch_size=16, seed=3):
    """(JAX cfg, JAX state, port cfg, port state) around the same weights,
    both Adam states at zero."""
    layers = mlp_layers(seed)
    jcfg = jbl.MLPBaseline(OBS, hidden_sizes=HID, reg_coef=reg_coef,
                           batch_size=batch_size, epochs=epochs)
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                layers)
    jstate = (jp, jcfg._optimizer().init(jp))
    tcfg = tbl.MLPBaseline(OBS, hidden_sizes=HID, reg_coef=reg_coef,
                           batch_size=batch_size, epochs=epochs)
    gen = torch.Generator().manual_seed(0)
    tparams, topt = tcfg.init(gen, dtype=torch.float64, device="cpu")
    tparams = convert.layers_from_numpy(layers, torch.float64)
    tstate = (tparams, {**topt, "mu": {k: torch.zeros_like(v)
                                       for k, v in tparams.items()},
                        "nu": {k: torch.zeros_like(v)
                               for k, v in tparams.items()}})
    return jcfg, jstate, tcfg, tstate


def close_layers(tparams, jlayers, tol):
    for lt, lj in zip(convert.layers_to_numpy(tparams), jlayers):
        close(lt["w"], lj["w"], tol, atol=1e-12)
        close(lt["b"], lj["b"], tol, atol=1e-12)


def test_mlp_features_and_predict_match_jax():
    obs, _, _ = data(4, False)
    jcfg, jstate, tcfg, tstate = mlp_pair(0.0)
    close(tcfg.features(T64(obs)), jcfg.features(jnp.asarray(obs)),
          FEAT_TOL)
    got = tcfg.predict(tstate, T64(obs))
    assert got.shape == (N, T)
    close(got, jcfg.predict(jstate, jnp.asarray(obs)), FEAT_TOL)


@pytest.mark.parametrize("reg_coef", [0.0, 1e-3], ids=["adam", "adamw"])
@pytest.mark.parametrize("masked", [False, True])
def test_mlp_fit_twice_matches_jax(reg_coef, masked):
    """Two fits in a row, 2 epochs each, the Adam state carried from the
    first into the second; AdamW's decoupled decay at reg_coef > 0."""
    obs, rets, mask = data(5, masked)
    jcfg, jstate, tcfg, tstate = mlp_pair(reg_coef)
    jfit = jax.jit(jcfg.fit)
    tm = None if mask is None else T64(mask)
    jm = jnp.ones((N, T)) if mask is None else jnp.asarray(mask)
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(11), 2)):
        perms = jax_perms(key, 2, N * T)
        jstate, je0, je1 = jfit(jstate, jnp.asarray(obs), jnp.asarray(rets),
                                jm, key)
        tstate, te0, te1 = tcfg.fit(tstate, T64(obs), T64(rets), tm,
                                    perms=perms)
        close_layers(tstate[0], jstate[0], ADAM_TOL)
        close(te0, je0, ADAM_TOL)
        close(te1, je1, ADAM_TOL)
        assert tstate[1]["count"] == int(jstate[1][0].count) == \
            2 * (i + 1) * (N * T // 16)
        close(tstate[1]["mu"]["layers.0.weight"].T, jstate[1][0].mu[0]["w"],
              ADAM_TOL, atol=1e-14)
        close(tstate[1]["nu"]["layers.2.bias"], jstate[1][0].nu[2]["b"],
              ADAM_TOL, atol=1e-16)
    assert float(te1) < float(te0)


@pytest.mark.parametrize("reg_coef", [0.0, 1e-3], ids=["adam", "adamw"])
def test_mlp_fit_with_an_all_masked_minibatch_matches_jax(reg_coef):
    """The first minibatch of the second fit holds only masked samples: its
    loss is 0 / max(0, 1), the gradient zero, and the step still runs — the
    moments decay and the parameters move (by momentum, and by the decay
    with AdamW)."""
    obs, rets, _ = data(6, False)
    jcfg, jstate, tcfg, tstate = mlp_pair(reg_coef)
    keys = jax.random.split(jax.random.PRNGKey(12), 2)
    perms2 = jax_perms(keys[1], 2, N * T)
    mask = np.ones(N * T)
    mask[perms2[0, :16]] = 0.0
    mask = mask.reshape(N, T)
    for key in keys:
        jstate, _, _ = jax.jit(jcfg.fit)(jstate, jnp.asarray(obs),
                                         jnp.asarray(rets),
                                         jnp.asarray(mask), key)
        tstate, _, _ = tcfg.fit(tstate, T64(obs), T64(rets), T64(mask),
                                perms=jax_perms(key, 2, N * T))
        close_layers(tstate[0], jstate[0], ADAM_TOL)

    # one step on that minibatch alone moves the parameters
    before = {k: v.clone() for k, v in tstate[0].items()}
    one = tbl.MLPBaseline(OBS, hidden_sizes=HID, reg_coef=reg_coef,
                          batch_size=16, epochs=1)
    idx = perms2[0, :16]
    f = lambda a: T64(a.reshape(N * T, *a.shape[2:])[idx])[None]
    count = tstate[1]["count"]
    (after, opt), e0, e1 = one.fit(tstate, f(obs), f(rets), f(mask),
                                   perms=np.arange(16)[None])
    assert opt["count"] == count + 1
    assert float(e0) == float(e1) == 0.0          # nothing valid to fit
    assert max(float((after[k] - before[k]).abs().max())
               for k in before) > 0


def test_mlp_fit_draws_its_permutations_from_the_generator():
    obs, rets, _ = data(7, False)
    _, _, tcfg, tstate = mlp_pair(1e-3)
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    perms = torch.stack([torch.randperm(N * T, generator=g2)
                         for _ in range(2)])
    clone = lambda st: ({k: v.clone() for k, v in st[0].items()},
                        {**st[1], "mu": {k: v.clone()
                                         for k, v in st[1]["mu"].items()},
                         "nu": {k: v.clone()
                                for k, v in st[1]["nu"].items()}})
    a, _, _ = tcfg.fit(clone(tstate), T64(obs), T64(rets), generator=g1)
    b, _, _ = tcfg.fit(clone(tstate), T64(obs), T64(rets), perms=perms)
    close_layers(a[0], convert.layers_to_numpy(b[0]), 0.0)


# ---------------------------------------------------------------------------
# host wrappers, convert, pickling
# ---------------------------------------------------------------------------

def paths_and_batch(seed):
    """Ragged paths (the first one full length) and the same data as one
    padded batch."""
    obs, rets, mask = data(seed, True)
    mask[0] = 1.0
    lengths = mask.sum(1).astype(int)
    paths = [dict(observations=obs[i, :n], rewards=np.zeros(n),
                  returns=rets[i, :n]) for i, n in enumerate(lengths)]
    return paths, dict(observations=obs * mask[..., None],
                       returns=rets * mask, mask=mask)


def test_quadratic_host_wrapper():
    spec = EnvSpec(OBS, 2, T)
    paths, batch = paths_and_batch(8)
    a = thost.QuadraticBaseline(spec, dtype=torch.float64, device="cpu")
    b = thost.QuadraticBaseline(spec, dtype=torch.float64, device="cpu")
    assert not a.needs_key and a.cfg.reg_coeff == 1e-3
    e0, e1 = a.fit(paths, return_errors=True)
    b.fit(batch)
    close(a.state, b.state, 1e-12)
    assert e0 == 1.0 and e1 < 1.0
    pred = a.predict(paths[2])
    assert pred.shape == (len(paths[2]["returns"]),)
    close(pred, tbl.QuadraticBaseline(OBS).predict(
        a.state, T64(paths[2]["observations"])[None])[0], 1e-12)


def test_mlp_host_wrapper_owns_its_generator():
    spec = EnvSpec(OBS, 2, T)
    paths, batch = paths_and_batch(9)
    kw = dict(hidden_sizes=HID, batch_size=16, epochs=2, reg_coef=1e-3,
              dtype=torch.float64, device="cpu")
    a = thost.MLPBaseline(spec, seed=4, **kw)
    b = thost.MLPBaseline(spec, seed=4, **kw)
    c = thost.MLPBaseline(spec, seed=5, **kw)
    assert a.needs_key and a.generator.initial_seed() == 4
    close_layers(a.state[0], convert.mlp_baseline_to_numpy(b), 0.0)
    assert float((a.state[0]["layers.0.weight"]
                  - c.state[0]["layers.0.weight"]).abs().max()) > 0
    # list of paths and the same padded batch: same fit, same draws
    e0, e1 = a.fit(paths, return_errors=True)
    b.fit(batch)
    close_layers(a.state[0], convert.mlp_baseline_to_numpy(b), 1e-12)
    assert e1 < e0
    assert a.state[1]["count"] == 2 * (N * T // 16)
    pred = a.predict(paths[0])
    assert pred.shape == (len(paths[0]["returns"]),)
    # the wrapper's fit is the functional fit with the wrapper's generator
    state = b.state
    g = torch.Generator().manual_seed(0)
    g.set_state(b.generator.get_state())
    b.fit(batch)
    want, _, _ = b.cfg.fit(state, *thost._paths_to_batch(
        batch, torch.float64), generator=g)
    close_layers(b.state[0], convert.layers_to_numpy(want[0]), 0.0)


def test_convert_carries_baselines_across():
    spec = EnvSpec(OBS, 2, T)
    layers = mlp_layers(10)
    bl = thost.MLPBaseline(spec, hidden_sizes=HID, dtype=torch.float64,
                           device="cpu")
    bl.fit(paths_and_batch(10)[1])
    convert.mlp_baseline_from_numpy(bl, layers)
    assert bl.state[1]["count"] == 0
    assert all(float(v.abs().max()) == 0 for v in bl.state[1]["mu"].values())
    back = convert.mlp_baseline_to_numpy(bl)
    for lb, lw in zip(back, layers):
        close(lb["w"], lw["w"], 0.0)
        close(lb["b"], lw["b"], 0.0)
    # the port's prediction from carried weights is the JAX package's
    obs, _, _ = data(10, False)
    jcfg = jbl.MLPBaseline(OBS, hidden_sizes=HID)
    jp = jax.tree_util.tree_map(jnp.asarray, layers)
    close(bl.predict({"observations": obs[0]}),
          jcfg.predict((jp, None), jnp.asarray(obs[:1]))[0], FEAT_TOL)
    q = thost.QuadraticBaseline(spec, dtype=torch.float64, device="cpu")
    coeffs = np.linspace(-1, 1, q.cfg.num_features())
    convert.linear_baseline_from_numpy(q, coeffs)
    close(convert.linear_baseline_to_numpy(q), coeffs, 0.0)


def test_baselines_pickle_with_cpu_tensors():
    spec = EnvSpec(OBS, 2, T)
    _, batch = paths_and_batch(11)
    bl = thost.MLPBaseline(spec, hidden_sizes=HID, batch_size=16,
                           dtype=torch.float64, device="cpu")
    bl.fit(batch)
    copy = pickle.loads(pickle.dumps(bl))
    assert copy.device == torch.device("cpu")
    assert copy.state[1]["count"] == bl.state[1]["count"]
    for k, v in bl.state[0].items():
        assert torch.equal(copy.state[0][k], v)
        assert torch.equal(copy.state[1]["nu"][k], bl.state[1]["nu"][k])
    # the generator travels too: the next fits draw the same permutations
    bl.fit(batch)
    copy.fit(batch)
    close_layers(copy.state[0], convert.mlp_baseline_to_numpy(bl), 0.0)
    q = thost.QuadraticBaseline(spec, dtype=torch.float64, device="cpu")
    q.fit(batch)
    q2 = pickle.loads(pickle.dumps(q))
    assert torch.equal(q2.state, q.state)
    close(q2.predict({"observations": batch["observations"][0]}),
          q.predict({"observations": batch["observations"][0]}), 0.0)
