"""Port vs JAX package: behavior cloning (CPU, float64).

The same expert paths, policy weights and minibatch indices go through both
packages' ``BC``: ``train()`` on the expert paths, then a second ``fit`` on
other data with the Adam state carried over, for the MSE and the MLE loss,
with and without ``set_transforms``.  The indices are the JAX package's own
draw (``jax.random.randint`` of the key its ``fit`` splits off), handed to
the port as ``idxs``.  The data are float32 numbers, which the JAX package's
cast to float32 leaves as they are.  The JAX package keeps the transforms
and log_std it takes from the data in float32 whatever the policy's dtype;
the port computes them in the policy's dtype, so they are compared at
float32 rounding (1e-6 relative) and the JAX values are then installed in
both, so that the fits are compared at 1e-9 relative (Adam's order of
operations differs).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.algos.behavior_cloning import BC as JaxBC
from mjrl_tpu.models import policies as jpol
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos import BC
from mjrl_tpu_torch.envs.base import EnvSpec
from mjrl_tpu_torch.models import policies as tpol

from test_torch_npg import close, close_tree
from test_torch_policy import numpy_params, to_jax

OBS, ACT, HID = 12, 4, (16, 16)
FIT_TOL, F32_TOL = 1e-9, 1e-6
EPOCHS, MB = 3, 32


def expert_paths(seed, n_paths=4, T=25):
    rng = np.random.RandomState(seed)
    f32 = lambda x: x.astype(np.float32).astype(np.float64)
    w = rng.normal(0, 0.5, (OBS, ACT))
    paths = []
    for _ in range(n_paths):
        obs = f32(rng.normal(1.0, 2.0, (T, OBS)))
        act = f32(np.tanh(obs @ w) * 0.8 + 0.3
                  + 0.05 * rng.normal(size=(T, ACT)))
        paths.append(dict(observations=obs, actions=act))
    return paths


def pair(loss_type, set_transforms):
    spec = EnvSpec(OBS, ACT, 25)
    p_np = numpy_params(12)
    p_np["log_std"] = np.array([-0.5, 0.0, -1.0, -2.9])
    jpolicy = jpol.MLP(spec, hidden_sizes=HID)
    jpolicy.params = jpolicy.old_params = to_jax(p_np)
    tpolicy = tpol.MLP(spec, hidden_sizes=HID, dtype=torch.float64,
                       device="cpu")
    convert.policy_params_from_numpy(tpolicy, p_np)
    paths = expert_paths(13)
    kw = dict(epochs=EPOCHS, batch_size=MB, lr=1e-3, loss_type=loss_type,
              set_transforms=set_transforms)
    jbc = JaxBC(paths, jpolicy, **kw)
    tbc = BC(paths, tpolicy, device="cpu", **kw)
    if set_transforms:
        jtr = jpolicy.transforms
        for a, b in zip(tpolicy.transforms, jtr):
            close(a, b, F32_TOL)
        close(tpolicy.params["log_std"], jpolicy.params["log_std"], F32_TOL)
        # the JAX values (float32) in both, as float64
        j64 = [np.asarray(t, np.float64) for t in jtr]
        jpolicy.transforms = type(jtr)(*(jnp.asarray(t) for t in j64))
        ls = np.asarray(jpolicy.params["log_std"], np.float64)
        jpolicy.params = jpolicy.old_params = {**jpolicy.params,
                                               "log_std": jnp.asarray(ls)}
        jbc.opt_state = jbc._optimizer.init(jpolicy.params)
        tpolicy.set_transformations(*j64)
        convert.policy_params_from_numpy(
            tpolicy, {**convert.params_to_numpy(tpolicy.params),
                      "log_std": ls})
    return jbc, tbc, paths


def jax_fit_idxs(fit_index, n):
    """The minibatch indices of the JAX BC's ``fit_index``-th fit (seed 0)."""
    key = jax.random.PRNGKey(0)
    for _ in range(fit_index + 1):
        key, sub = jax.random.split(key)
    return np.array(jax.random.randint(sub, (EPOCHS * (n // MB), MB), 0, n))


@pytest.mark.parametrize("set_transforms", [False, True],
                         ids=["plain", "set_transforms"])
@pytest.mark.parametrize("loss_type", ["MSE", "MLE"])
def test_bc_train_then_fit_matches_jax(loss_type, set_transforms):
    jbc, tbc, paths = pair(loss_type, set_transforms)
    jp, tp = jbc.policy, tbc.policy
    n = sum(len(p["observations"]) for p in paths)
    jbc.train()
    tbc.train(idxs=jax_fit_idxs(0, n))
    close_tree(tp.params, jp.params, FIT_TOL)
    for k in ("loss_before", "loss_after"):
        close(tbc.logger.log[k][-1], jbc.logger.log[k][-1], FIT_TOL)
    assert tbc.logger.log["loss_after"][-1] < tbc.logger.log["loss_before"][-1]
    if loss_type == "MSE":           # the mean's loss leaves log_std alone
        close(tp.params["log_std"], jp.params["log_std"], 0.0)

    # a second fit on other data carries the Adam state
    other = expert_paths(14, n_paths=3)
    data = dict(observations=np.concatenate([p["observations"]
                                             for p in other]),
                expert_actions=np.concatenate([p["actions"] for p in other]))
    jbc.fit(data)
    tbc.fit(data, idxs=jax_fit_idxs(1, len(data["observations"])))
    close_tree(tp.params, jp.params, FIT_TOL)
    close_tree(tp.old_params, jp.old_params, FIT_TOL)
    assert tbc.opt_state["count"] == int(jbc.opt_state[0].count) == \
        EPOCHS * (n // MB + len(data["observations"]) // MB)
    close(tbc.loss(data), jbc.loss(data), FIT_TOL)
    close(tbc.loss(data, idx=[3, 1, 4]), jbc.loss(data, idx=[3, 1, 4]),
          FIT_TOL)


def test_bc_draws_indices_from_its_generator_and_pickles():
    _, tbc, paths = pair("MLE", False)
    n = sum(len(p["observations"]) for p in paths)
    copy = pickle.loads(pickle.dumps(tbc))
    idxs = torch.randint(0, n, (EPOCHS * (n // MB), MB),
                         generator=torch.Generator().manual_seed(0))
    tbc.train()
    copy.train(idxs=idxs)
    close_tree(tbc.policy.params, convert.params_to_numpy(copy.policy.params),
               0.0)
    again = pickle.loads(pickle.dumps(tbc))
    assert again.opt_state["count"] == tbc.opt_state["count"] > 0
    for k, v in tbc.opt_state["nu"].items():
        assert again.opt_state["nu"][k].device.type == "cpu"
        assert torch.equal(again.opt_state["nu"][k], v)
    assert torch.equal(again.generator.get_state(),
                       tbc.generator.get_state())
