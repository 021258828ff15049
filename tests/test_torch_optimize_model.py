"""Port vs JAX package: ``utils/optimize_model.fit_data`` and behaviour
cloning with a custom optimizer (CPU, float64).

``fit_data`` on the same float64 MLP regression as the JAX ``fit_data``,
each epoch's permutation the JAX package's own draw (``split(key,
epochs)``, then ``permutation(ekey, n)``) handed to the port as
``perms=``: the default Adam, Adam continued from the returned state, and
an SGD factory against ``optax.sgd``.  BC with an SGD factory against the
JAX BC with ``optax.sgd``, its minibatch indices injected.  Parameters and
losses at 1e-9 (the packages sum a minibatch's loss in different orders).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mjrl_tpu.algos.behavior_cloning import BC as JaxBC
from mjrl_tpu.models import policies as jpol
from mjrl_tpu.utils.optimize_model import fit_data as jax_fit_data
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos import BC
from mjrl_tpu_torch.envs.base import EnvSpec
from mjrl_tpu_torch.models import policies as tpol
from mjrl_tpu_torch.utils.optimize_model import fit_data

from test_torch_baselines import jax_perms
from test_torch_bc import EPOCHS, MB, expert_paths, jax_fit_idxs
from test_torch_npg import close_tree
from test_torch_policy import numpy_params, to_jax

TOL = 1e-9
N, D_IN, HID = 90, 3, 8


def regression(seed):
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(N, D_IN))
    y = np.sin(x @ rng.normal(size=(D_IN, 1)))
    p = {"w1": rng.normal(0, 0.5, (D_IN, HID)), "b1": np.zeros(HID),
         "w2": rng.normal(0, 0.5, (HID, 1)), "b2": np.zeros(1)}
    return x, y, p


def jax_loss(p, x, y):
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] + p["b2"] - y) ** 2)


def torch_loss(p, x, y):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return torch.mean((h @ p["w2"] + p["b2"] - y) ** 2)


def T(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def J(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def close(a, b, tol=TOL):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("batch_size,epochs", [(16, 3), (200, 2)])
def test_fit_data_adam_matches_jax(batch_size, epochs):
    """(16, 3): 5 steps an epoch, 10 samples dropped; (200, 2): the batch
    is cut to n, one step an epoch.  Then a second fit continues from
    each package's returned Adam state."""
    x, y, p = regression(0)
    key = jax.random.PRNGKey(3)
    jp, jstate, jl = jax_fit_data(jax_loss, J(p), x, y,
                                  batch_size=batch_size, epochs=epochs,
                                  key=key)
    tp, tstate, tl = fit_data(torch_loss, T(p), x, y,
                              batch_size=batch_size, epochs=epochs,
                              perms=jax_perms(key, epochs, N))
    close(tl, jl)
    for k in p:
        close(tp[k], jp[k])
    assert tstate["count"] == int(jstate[0].count)
    key2 = jax.random.PRNGKey(4)
    jp, _, jl = jax_fit_data(jax_loss, jp, x, y, opt_state=jstate,
                             batch_size=batch_size, epochs=1, key=key2)
    tp, _, tl = fit_data(torch_loss, tp, x, y, opt_state=tstate,
                         batch_size=batch_size, epochs=1,
                         perms=jax_perms(key2, 1, N))
    close(tl, jl)
    for k in p:
        close(tp[k], jp[k])


LR = 0.05
BC_LR = 0.01


def sgd(params):
    return torch.optim.SGD(params, lr=LR)


def bc_sgd(params):
    return torch.optim.SGD(params, lr=BC_LR)


def momentum(params):
    return torch.optim.SGD(params, lr=BC_LR, momentum=0.9)


def test_fit_data_with_an_sgd_factory_matches_optax_sgd():
    x, y, p = regression(1)
    key = jax.random.PRNGKey(5)
    jp, _, jl = jax_fit_data(jax_loss, J(p), x, y, optimizer=optax.sgd(LR),
                             batch_size=32, epochs=3, key=key)
    tp, tstate, tl = fit_data(torch_loss, T(p), x, y, optimizer=sgd,
                              batch_size=32, epochs=3,
                              perms=jax_perms(key, 3, N))
    close(tl, jl)
    for k in p:
        close(tp[k], jp[k])
    assert tstate["param_groups"][0]["lr"] == LR
    # the inputs are left as they were; the generator draws the default
    # permutations when none are given
    close(T(p)["w1"], p["w1"], 0.0)
    _, _, l1 = fit_data(torch_loss, T(p), x, y, epochs=2)
    _, _, l2 = fit_data(torch_loss, T(p), x, y, epochs=2,
                        generator=torch.Generator().manual_seed(0))
    assert l1 == l2


OBS, ACT = 12, 4


def bc_pair(factory):
    spec = EnvSpec(OBS, ACT, 25)
    p_np = numpy_params(12)
    jpolicy = jpol.MLP(spec, hidden_sizes=(16, 16))
    jpolicy.params = jpolicy.old_params = to_jax(p_np)
    tpolicy = tpol.MLP(spec, hidden_sizes=(16, 16), dtype=torch.float64,
                       device="cpu")
    convert.policy_params_from_numpy(tpolicy, p_np)
    paths = expert_paths(13)
    kw = dict(epochs=EPOCHS, batch_size=MB, lr=BC_LR, loss_type="MLE")
    jbc = JaxBC(paths, jpolicy, optimizer=optax.sgd(BC_LR), **kw)
    tbc = BC(paths, tpolicy, optimizer=factory, device="cpu", **kw)
    return jbc, tbc, paths


def test_bc_with_an_sgd_factory_matches_jax_bc_with_optax_sgd():
    jbc, tbc, paths = bc_pair(bc_sgd)
    n = sum(len(p["observations"]) for p in paths)
    assert isinstance(tbc._torch_opt, torch.optim.SGD)
    jbc.train()
    tbc.train(idxs=jax_fit_idxs(0, n))
    close_tree(tbc.policy.params, jbc.policy.params, TOL)
    for k in ("loss_before", "loss_after"):
        close(tbc.logger.log[k][-1], jbc.logger.log[k][-1])
    # a second fit continues with the same optimizer; the pickled agent
    # keeps its factory and the optimizer's state
    jbc.train()
    tbc.train(idxs=jax_fit_idxs(1, n))
    close_tree(tbc.policy.params, jbc.policy.params, TOL)
    copy = pickle.loads(pickle.dumps(tbc))
    assert copy._optimizer is bc_sgd
    assert isinstance(copy._torch_opt, torch.optim.SGD)
    idxs = jax_fit_idxs(2, n)
    tbc.train(idxs=idxs)
    copy.train(idxs=idxs)
    close_tree(copy.policy.params,
               convert.params_to_numpy(tbc.policy.params), 0.0)


def test_bc_with_a_momentum_factory_pickles_its_state():
    """A stateful optimizer (SGD with momentum): the momentum buffers
    travel through a pickle, so the copy continues exactly as the
    original does."""
    _, tbc, paths = bc_pair(momentum)
    n = sum(len(p["observations"]) for p in paths)
    gen = torch.Generator().manual_seed(1)
    tbc.train(idxs=torch.randint(0, n, (6, MB), generator=gen))
    copy = pickle.loads(pickle.dumps(tbc))
    idxs = torch.randint(0, n, (6, MB), generator=gen)
    tbc.train(idxs=idxs)
    copy.train(idxs=idxs)
    close_tree(copy.policy.params,
               convert.params_to_numpy(tbc.policy.params), 0.0)
    assert copy._torch_opt.state_dict()["state"]
