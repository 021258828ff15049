"""Port vs JAX package: the stacked world-model ensemble whose members'
Adam step counts differ (CPU, float64).

A member fitted on its own takes its own Adam count; a later stacked fit
then steps every member with its own bias correction, as the JAX
ensemble's ``vmap`` over per-member optax states does.  Three fits in a
row: member 0 alone, then two stacked fits, each against the JAX package
run at float64 (``Float64Numpy``) with its permutations injected
(``perms=``).  Every member's parameters, transforms and Adam moments at
1e-9 (up to 18 Adam steps; the two packages sum a minibatch's loss in
different orders), the counts exactly.
"""

import jax
import numpy as np
import torch

from mjrl_tpu.algos.model_accel import nn_dynamics as jnd
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos.model_accel import nn_dynamics as tnd

from test_torch_baselines import jax_perms
from test_torch_nn_dynamics import (A, D, FIT_TOL, HID, check_model, close,
                                    data, jax_f64, jax_tree,  # noqa: F401
                                    numpy_layers)

M = 3


def ensembles():
    jens = jnd.WorldModelEnsemble(M, D, A, seed=11, hidden_size=HID)
    tens = tnd.WorldModelEnsemble(M, D, A, seed=11, hidden_size=HID,
                                  device="cpu", dtype=torch.float64)
    for i, (jm, tm) in enumerate(zip(jens, tens)):
        jm.dyn_params = jax_tree(numpy_layers(40 + i))
        jm.dyn_tr = jax_tree(jm.dyn_tr)
        jm.dyn_opt_state = jm._dyn_opt.init(jm.dyn_params)
        convert.world_model_from_numpy(
            tm, numpy_layers(40 + i),
            jax.tree_util.tree_map(np.asarray, jm.dyn_tr))
    return jens, tens


def check_all(jens, tens):
    for jm, tm in zip(jens, tens):
        check_model(tm, jm, FIT_TOL)


def test_member_fit_then_stacked_fits_match_jax(jax_f64):  # noqa: F811
    jens, tens = ensembles()

    # member 0 alone: 80 samples, minibatches of 16, 2 epochs -> 10 steps
    s, a, sp = data(21, 80)
    _, sub = jax.random.split(jens[0]._key)
    want = jens[0].fit_dynamics(s, a, sp, 16, 2)
    got = tens[0].fit_dynamics(s, a, sp, 16, 2, perms=jax_perms(sub, 2, 80))
    close(got, want, FIT_TOL)
    check_all(jens, tens)
    assert [m.dyn_opt_state["count"] for m in tens] == [10, 0, 0]

    # two stacked fits: member 0 carries on from 10, the others from 0
    for fit, (n, epochs, cap) in enumerate([(64, 2, 1e4), (50, 2, 5)]):
        s, a, sp = data(22 + fit, n)
        perms = np.stack([jax_perms(jax.random.fold_in(m._key, 7), epochs,
                                    n) for m in jens])
        want = jens.fit_dynamics(s, a, sp, 16, epochs, max_steps=cap)
        got = tens.fit_dynamics(s, a, sp, 16, epochs, max_steps=cap,
                                perms=perms)
        close(got, want, FIT_TOL)
        check_all(jens, tens)
        close(tens.predict_all(s[:6], a[:6]), jens.predict_all(s[:6], a[:6]),
              FIT_TOL)
    assert [m.dyn_opt_state["count"] for m in tens] == [23, 13, 13]
    assert [int(m.dyn_opt_state[0].count) for m in jens] == [23, 13, 13]


def test_equal_counts_keep_the_shared_bias_correction():
    """With equal counts the per-member correction equals the scalar one:
    one stacked step from count 4 gives the same moments and parameters as
    the same step taken with an int count."""
    from mjrl_tpu_torch.ops.adam import adam_init, adam_step_
    rng = np.random.RandomState(5)
    p0 = {"w": torch.tensor(rng.normal(size=(M, 4, 3))),
          "b": torch.tensor(rng.normal(size=(M, 4)))}
    g = {k: torch.tensor(rng.normal(size=v.shape)) for k, v in p0.items()}
    results = []
    for count in (4, torch.tensor([4] * M)):
        p = {k: v.clone() for k, v in p0.items()}
        st = adam_init(p)
        st["count"] = count
        for k in p:
            st["mu"][k].fill_(0.3)
            st["nu"][k].fill_(0.2)
        st = adam_step_(p, g, st, 1e-2)
        results.append((p, st))
    (pa, sa), (pb, sb) = results
    for k in p0:
        close(pa[k], pb[k].numpy(), 1e-15)
        close(sa["mu"][k], sb["mu"][k].numpy(), 0.0)
    assert sa["count"] == 5 and sb["count"].tolist() == [5] * M
