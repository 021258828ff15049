"""Port vs JAX package: the learned world models (CPU, float64).

The JAX model-based modules cast their inputs to float32
(``jnp.asarray(x, jnp.float32)``); these tests run the same JAX code at
float64 by handing the modules a ``jax.numpy`` whose ``float32`` is float64
(``jax_f64``), with float64 weights and Adam states carried across by
``convert``.  Every permutation of a fit is the JAX package's own draw
(from the model's key, as its fit splits it), handed to the port as
``perms=``.

Tolerances: 1e-12 for forwards, transforms and rewards (the same closed
forms); 1e-9 for fits (up to 24 Adam steps; the two packages sum a
minibatch's loss in different orders).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.algos.model_accel import nn_dynamics as jnd
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos.model_accel import nn_dynamics as tnd
from mjrl_tpu_torch.parallel import make_mesh

from test_torch_baselines import jax_perms

EXACT, FIT_TOL = 1e-12, 1e-9
D, A, HID = 5, 2, (16, 16)


class Float64Numpy:
    """``jax.numpy`` with ``float32`` read as float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def jax_f64(monkeypatch):
    monkeypatch.setattr(jnd, "jnp", Float64Numpy())


def close(a, b, tol):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


def numpy_layers(seed, n_in=D + A, n_out=D, hidden=HID):
    rng = np.random.RandomState(seed)
    sizes = (n_in,) + tuple(hidden) + (n_out,)
    return [{"w": rng.normal(0, 0.4, (sizes[i], sizes[i + 1])),
             "b": rng.normal(0, 0.1, (sizes[i + 1],))}
            for i in range(len(sizes) - 1)]


def numpy_transforms(seed, frozen=(1,)):
    """Random transforms; ``out_scale`` of the ``frozen`` dims below 1e-8."""
    rng = np.random.RandomState(seed)
    tr = {"s_shift": rng.normal(0, 0.3, D), "s_scale": rng.uniform(0.5, 2, D),
          "a_shift": rng.normal(0, 0.3, A), "a_scale": rng.uniform(0.5, 2, A),
          "out_shift": rng.normal(0, 0.3, D),
          "out_scale": rng.uniform(0.5, 2, D)}
    tr["out_scale"][list(frozen)] = 0.0
    return tr


def data(seed, n=100):
    rng = np.random.RandomState(seed)
    s = rng.normal(0, 1, (n, D))
    a = rng.normal(0, 1, (n, A))
    w = rng.normal(0, 0.3, (D + A, D))
    sp = s + np.tanh(np.concatenate([s, a], 1) @ w)
    sp[:, 3] = s[:, 3]              # a frozen dimension: zero out_scale
    return s, a, sp


def jax_tree(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                  tree)


def jax_adam(state):
    """The ScaleByAdamState of an optax state, as convert takes it."""
    s = state[0]
    return {"count": int(s.count), "mu": jax.tree_util.tree_map(np.asarray,
                                                                s.mu),
            "nu": jax.tree_util.tree_map(np.asarray, s.nu)}


def check_model(tm, jm, tol):
    got = convert.world_model_to_numpy(tm)
    for lg, lj in zip(got["dyn_params"], jm.dyn_params):
        close(lg["w"], lj["w"], tol)
        close(lg["b"], lj["b"], tol)
    for k, v in jm.dyn_tr.items():
        close(got["dyn_tr"][k], v, tol)
    st = jax_adam(jm.dyn_opt_state)
    assert got["dyn_opt_state"]["count"] == st["count"]
    for part in ("mu", "nu"):
        for lg, lj in zip(got["dyn_opt_state"][part], st[part]):
            close(lg["w"], lj["w"], tol)
            close(lg["b"], lj["b"], tol)


def pair(seed=0, fit_wd=0.0, learn_reward=False, layers_seed=3):
    """A JAX and a port WorldModel with the same float64 weights."""
    jm = jnd.WorldModel(D, A, hidden_size=HID, seed=seed, fit_wd=fit_wd,
                        learn_reward=learn_reward)
    tm = tnd.WorldModel(D, A, hidden_size=HID, seed=seed, fit_wd=fit_wd,
                        learn_reward=learn_reward, device="cpu",
                        dtype=torch.float64)
    jm.dyn_params = jax_tree(numpy_layers(layers_seed))
    jm.dyn_tr = jax_tree(jm.dyn_tr)
    jm.dyn_opt_state = jm._dyn_opt.init(jm.dyn_params)
    kw = {}
    if learn_reward:
        jm.rew_params = jax_tree(numpy_layers(layers_seed + 1,
                                              2 * D + A, 1, (100, 100)))
        jm.rew_tr = jax_tree(jm.rew_tr)
        jm.rew_opt_state = jm._rew_opt.init(jm.rew_params)
        kw = dict(rew_params=numpy_layers(layers_seed + 1, 2 * D + A, 1,
                                          (100, 100)),
                  rew_tr=jax.tree_util.tree_map(np.asarray, jm.rew_tr))
    convert.world_model_from_numpy(tm, numpy_layers(layers_seed),
                                   jax.tree_util.tree_map(np.asarray,
                                                          jm.dyn_tr), **kw)
    return jm, tm


@pytest.mark.parametrize("residual,activation",
                         [(True, "relu"), (False, "tanh")])
def test_forward_with_mask_and_residual_matches_jax(residual, activation):
    jcfg = jnd.DynamicsNetCfg(D, A, HID, activation, residual)
    tcfg = tnd.DynamicsNetCfg(D, A, HID, activation, residual)
    s, a, _ = data(0, 9)
    T = lambda x: torch.tensor(x, dtype=torch.float64)
    members = [(numpy_layers(i), numpy_transforms(10 + i)) for i in range(3)]
    for out_tr in (True, False):
        for layers, tr in members:
            got = tcfg.forward(convert.layers_from_numpy(layers,
                                                         torch.float64),
                               {k: T(v) for k, v in tr.items()}, T(s), T(a),
                               apply_out_transforms=out_tr)
            want = jcfg.forward(jax_tree(layers), jax_tree(tr),
                                jnp.asarray(s), jnp.asarray(a),
                                apply_out_transforms=out_tr)
            close(got, want, EXACT)
            if out_tr and residual:     # a frozen dim keeps the state
                close(got[:, 1], s[:, 1], EXACT)
    # the stacked forward of the three at once
    stack = lambda trees: {k: torch.stack([t[k] for t in trees])
                           for k in trees[0]}
    got = tcfg.forward(
        stack([convert.layers_from_numpy(l, torch.float64)
               for l, _ in members]),
        stack([{k: T(v) for k, v in tr.items()} for _, tr in members]),
        T(s).expand(3, -1, -1), T(a).expand(3, -1, -1))
    for i, (layers, tr) in enumerate(members):
        close(got[i], jcfg.forward(jax_tree(layers), jax_tree(tr),
                                   jnp.asarray(s), jnp.asarray(a)), EXACT)


def test_data_transforms_match_jax():
    s, a, sp = data(1)
    T = lambda x: torch.tensor(x, dtype=torch.float64)
    got = tnd.data_transforms(T(s), T(a), T(sp - s))
    want = jnd.data_transforms(jnp.asarray(s), jnp.asarray(a),
                               jnp.asarray(sp - s))
    for g, w in zip(got, want):
        close(g, w, EXACT)
    # the scale is the mean absolute deviation, not the std
    close(got[1], np.mean(np.abs(s - s.mean(0)), 0), EXACT)


@pytest.mark.parametrize("fit_wd", [0.0, 1e-3], ids=["adam", "adamw"])
def test_capped_fit_matches_jax_and_continues_from_converted_state(
        jax_f64, fit_wd):
    """100 samples in minibatches of 16: 6 steps an epoch (4 samples
    dropped), 4 epochs capped at 15 steps: the cap falls in the third
    epoch, the fourth runs no step.  Then a second fit (another cap) from
    the JAX model's state converted into a fresh port model."""
    jm, tm = pair(fit_wd=fit_wd)
    s, a, sp = data(2)
    key, sub = jax.random.split(jm._key)
    want = jm.fit_dynamics(s, a, sp, 16, 4, max_steps=15)
    got = tm.fit_dynamics(s, a, sp, 16, 4, max_steps=15,
                          perms=jax_perms(sub, 4, 100))
    close(got, want, FIT_TOL)
    assert want[3] == got[3] == 0.0 and want[2] != 0.0
    check_model(tm, jm, FIT_TOL)
    assert tm.dyn_opt_state["count"] == 15

    fresh = tnd.WorldModel(D, A, hidden_size=HID, fit_wd=fit_wd,
                           device="cpu", dtype=torch.float64)
    convert.world_model_from_numpy(
        fresh, jax.tree_util.tree_map(np.asarray, jm.dyn_params),
        jax.tree_util.tree_map(np.asarray, jm.dyn_tr),
        jax_adam(jm.dyn_opt_state))
    s2, a2, sp2 = data(3, 80)
    _, sub = jax.random.split(jm._key)
    want = jm.fit_dynamics(s2, a2, sp2, 16, 2, max_steps=9,
                           set_transformations=False)
    got = fresh.fit_dynamics(s2, a2, sp2, 16, 2, max_steps=9,
                             set_transformations=False,
                             perms=jax_perms(sub, 2, 80))
    close(got, want, FIT_TOL)
    check_model(fresh, jm, FIT_TOL)
    assert fresh.dyn_opt_state["count"] == 24
    close(fresh.compute_loss(s2, a2, sp2), jm.compute_loss(s2, a2, sp2),
          FIT_TOL)


def test_ensemble_fit_matches_jax_ensemble(jax_f64):
    """Three members, each with its own weights and its own permutation
    stream (``fold_in(key, 7)``, the key moved on by ``fold_in(key, 13)``
    after a fit), fitted twice by one stacked fit each."""
    M = 3
    jens = jnd.WorldModelEnsemble(M, D, A, seed=4, hidden_size=HID)
    tens = tnd.WorldModelEnsemble(M, D, A, seed=4, hidden_size=HID,
                                  device="cpu", dtype=torch.float64)
    for i, (jm, tm) in enumerate(zip(jens, tens)):
        jm.dyn_params = jax_tree(numpy_layers(20 + i))
        jm.dyn_tr = jax_tree(jm.dyn_tr)
        jm.dyn_opt_state = jm._dyn_opt.init(jm.dyn_params)
        convert.world_model_from_numpy(
            tm, numpy_layers(20 + i),
            jax.tree_util.tree_map(np.asarray, jm.dyn_tr))
    for fit, (n, epochs, cap) in enumerate([(100, 3, 1e4), (70, 2, 5)]):
        s, a, sp = data(5 + fit, n)
        perms = np.stack([jax_perms(jax.random.fold_in(m._key, 7), epochs,
                                    n) for m in jens])
        want = jens.fit_dynamics(s, a, sp, 16, epochs, max_steps=cap)
        got = tens.fit_dynamics(s, a, sp, 16, epochs, max_steps=cap,
                                perms=perms)
        assert got.shape == want.shape == (M, epochs)
        close(got, want, FIT_TOL)
        for jm, tm in zip(jens, tens):
            check_model(tm, jm, FIT_TOL)
        close(tens.predict_all(s[:7], a[:7]), jens.predict_all(s[:7], a[:7]),
              FIT_TOL)
    # the members are views of the stacks: a member's own prediction
    close(tens[1].predict(s, a), tens.predict_all(s, a)[1], EXACT)


def test_reward_head_matches_jax(jax_f64):
    jm, tm = pair(seed=6, learn_reward=True)
    s, a, sp = data(7)
    r = (np.sum(s[:, :2] ** 2, 1) - 0.3 * a[:, 0])[:, None]
    _, sub = jax.random.split(jm._key)
    want = jm.fit_reward(s, a, r, 16, 2)
    got = tm.fit_reward(s, a, r, 16, 2, perms=jax_perms(sub, 2, 100))
    close(got, want, FIT_TOL)
    close(tm.reward(s, a), jm.reward(s, a), FIT_TOL)
    for k, v in jm.rew_tr.items():
        close(tm.rew_tr[k], v, EXACT)
    paths = {"observations": s[:18].reshape(3, 6, D),
             "actions": a[:18].reshape(3, 6, A)}
    close(tm.compute_path_rewards(dict(paths))["rewards"],
          jm.compute_path_rewards(dict(paths))["rewards"], FIT_TOL)
    assert tnd.WorldModel(D, A, device="cpu").reward(s, a) is None


def test_conversion_round_trip_and_pickle():
    tens = tnd.WorldModelEnsemble(2, D, A, seed=8, hidden_size=HID,
                                  device="cpu", dtype=torch.float64)
    s, a, sp = data(9, 64)
    tens.fit_dynamics(s, a, sp, 16, 2)
    arrays = convert.world_model_to_numpy(tens[1])
    single = tnd.WorldModel(D, A, hidden_size=HID, device="cpu",
                            dtype=torch.float64)
    convert.world_model_from_numpy(single, **arrays)
    close(single.predict(s, a), tens[1].predict(s, a), 0.0)
    again = convert.world_model_to_numpy(single)
    assert again["dyn_opt_state"]["count"] == 8
    for part in ("mu", "nu"):
        for lg, lw in zip(again["dyn_opt_state"][part],
                          arrays["dyn_opt_state"][part]):
            close(lg["w"], lw["w"], 0.0)
    copy = pickle.loads(pickle.dumps(tens))
    close(copy.predict_all(s, a), tens.predict_all(s, a), 0.0)
    assert copy[0]._ens is copy
    assert torch.equal(copy[1].generator.get_state(),
                       tens[1].generator.get_state())
    # both copies fit on alike: same draws, same result
    close(copy.fit_dynamics(s, a, sp, 16, 1), tens.fit_dynamics(s, a, sp, 16,
                                                                1), 0.0)
    # the model axis over a mesh (M11) is ported: on a one-rank mesh the
    # ensemble fits as without one, and a pickle drops the process group
    kw = dict(seed=8, hidden_size=HID, device="cpu", dtype=torch.float64)
    meshed = tnd.WorldModelEnsemble(2, D, A, mesh=make_mesh(device="cpu"),
                                    **kw)
    plain = tnd.WorldModelEnsemble(2, D, A, **kw)
    close(meshed.fit_dynamics(s, a, sp, 16, 2), plain.fit_dynamics(
        s, a, sp, 16, 2), 0.0)
    close(meshed.predict_all(s, a), plain.predict_all(s, a), 0.0)
    assert pickle.loads(pickle.dumps(meshed)).mesh is None
