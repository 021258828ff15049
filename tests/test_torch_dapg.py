"""Port vs JAX package: DAPG updates (CPU, float64).

Two agents around the same point-mass policy (32-32) and a linear
baseline, each given the same batches (the returns, GAE and whitening of
``_train_from_batch``, then the update): two updates with demos, so the
demo advantage decays from lam_0 to lam_0 lam_1, and the no-demo case.
The JAX DAPG casts its demos to float32; under ``jax_f64`` it keeps them
at float64, as the port keeps them in the policy's dtype.

Tolerance 1e-8, as for NPG: ten CG iterations amplify last-digit
differences.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import baselines as jhost
from mjrl_tpu.algos import dapg as jdapg
from mjrl_tpu.models import policies as jpol
from mjrl_tpu_torch import baselines as thost
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos import DAPG
from mjrl_tpu_torch.envs.point_mass import PointMassEnv
from mjrl_tpu_torch.models import policies as tpol

from test_torch_nn_dynamics import Float64Numpy, close
from test_torch_npg import close_tree
from test_torch_policy import numpy_params, to_jax

OBS, ACT, HID, N, T = 6, 2, (32, 32), 6, 12
UPDATE_TOL = 1e-8


@pytest.fixture
def jax_f64(monkeypatch):
    monkeypatch.setattr(jdapg, "jnp", Float64Numpy())


def demo_paths(seed, n=3, length=9):
    rng = np.random.RandomState(seed)
    return [dict(observations=rng.normal(0, 0.6, (length, OBS)),
                 actions=rng.normal(0, 0.5, (length, ACT)))
            for _ in range(n)]


def agents(demos, **kw):
    spec = PointMassEnv(device="cpu").spec
    p_np = numpy_params(8, HID, OBS, ACT)
    p_np["log_std"] = np.array([-0.4, 0.1])
    jp = jpol.MLP(spec, hidden_sizes=HID)
    jp.params = jp.old_params = to_jax(p_np)
    jp.transforms = type(jp.transforms)(*to_jax(list(jp.transforms)))
    tp = tpol.MLP(spec, hidden_sizes=HID, dtype=torch.float64, device="cpu")
    convert.policy_params_from_numpy(tp, p_np)
    kw = dict(demo_paths=demos, normalized_step_size=0.05, seed=1,
              save_logs=True, **kw)
    ja = jdapg.DAPG(None, jp, jhost.LinearBaseline(spec), **kw)
    ta = DAPG(PointMassEnv(dtype=torch.float64, device="cpu"), tp,
              thost.LinearBaseline(spec, dtype=torch.float64, device="cpu"),
              device="cpu", **kw)
    return ja, ta


def batch(seed, agent):
    """A ragged on-policy batch: actions drawn around the policy's mean."""
    rng = np.random.RandomState(seed)
    obs = rng.normal(0, 0.6, (N, T, OBS))
    lengths = rng.randint(3, T + 1, N)
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float64)
    tp = agent.policy
    mean, log_std = tp.config.dist_info(tp.params, tp.transforms,
                                        torch.tensor(obs))
    act = mean.detach().numpy() + np.exp(log_std.detach().numpy()) \
        * rng.normal(size=(N, T, ACT))
    return dict(observations=obs, actions=act,
                rewards=rng.normal(size=(N, T)) * mask, mask=mask,
                terminated=lengths < T)


def update(agent, b, framework):
    if framework == "jax":
        tree = {k: jnp.asarray(v) for k, v in b.items()}
    else:
        tree = {k: torch.tensor(v) for k, v in b.items()}
    tree["env_infos"] = {}
    _, process_fn, update_fn, _ = agent._get_phases(N, T, 0.95, 0.97)
    return agent._train_from_batch(tree, process_fn, update_fn)


@pytest.mark.parametrize("with_demos", [True, False],
                         ids=["demos", "no_demos"])
def test_two_dapg_updates_match_jax(jax_f64, with_demos):
    ja, ta = agents(demo_paths(2) if with_demos else None, lam_1=0.8)
    for it in range(2):
        b = batch(10 + it, ta)
        close(update(ta, b, "torch"), update(ja, b, "jax"), UPDATE_TOL)
        close_tree(ta.policy.params, ja.policy.params, UPDATE_TOL)
        assert ta.iter_count == ja.iter_count == it + 1.0
        for k in ("alpha", "delta", "kl_dist", "surr_improvement"):
            close(ta.logger.log[k][-1], ja.logger.log[k][-1], UPDATE_TOL)
    if with_demos:
        assert ta._demo_obs.dtype == torch.float64
        assert ta._demo_obs.shape == (27, OBS)


def test_demos_change_the_step_and_lam_0_zero_is_npg_without_guard():
    """With lam_0 = 0 the demos are left out: the same update as without
    them.  With demos, another direction."""
    demos = demo_paths(3)
    _, plain = agents(None)
    _, off = agents(demos, lam_0=0.0)
    _, on = agents(demos)
    b = batch(20, plain)
    for agent in (plain, off, on):
        update(agent, b, "torch")
    close_tree(off.policy.params, convert.params_to_numpy(
        plain.policy.params), 1e-12)
    diff = np.abs(on.policy.get_param_values()
                  - plain.policy.get_param_values()).max()
    assert diff > 1e-6
    # the realized KL is left alone (no guard): step size 2 * kl_dist
    assert on.n_step_size == 0.05 and on.kl_dist == 0.025
