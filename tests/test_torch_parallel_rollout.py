"""Sharded rollouts: ``rollout_batch(mesh=)`` on two gloo ranks (CPU,
float64), Hopper-v3 (contacts, early termination).

- An eval rollout from the JAX package's start states, each rank stepping
  its 4 of 8 rows, against the JAX package's sharded eval rollout
  (``rollout_batch(..., mesh=make_mesh(), eval_mode=True)`` on the 8
  virtual devices) at the existing ``ROLLOUT_TOL`` 1e-8, the ranks' rows
  put back together.
- A stochastic rollout with the whole batch's noise injected and one with
  autoreset and injected fresh states (Hopper), and a Swimmer rollout that
  draws its resets and noise from the generator: each equals the one-rank
  port rollout exactly (0.0), so every draw is made for the whole batch and
  sliced.

The same four rollouts on four ranks (2 rows each) equal one rank at
``RANK_TOL`` 1e-10, the tolerance of ``test_torch_parallel_train.py`` (a
batch of 2 rows rounds the Hopper step's last bit otherwise than one of
8), and their eval rollout equals the JAX package's, sharded over 4 of the
8 virtual devices, at ``ROLLOUT_TOL``.

The JAX side and the one-rank runs go in this process while the ranks
run; the ranks import this file, which imports JAX only inside its
fixtures.
"""

import os

import numpy as np
import pytest
import torch

from mjrl_tpu_torch import convert
from mjrl_tpu_torch.envs.gym_suite import HopperEnv
from mjrl_tpu_torch.envs.swimmer import SwimmerEnv
from mjrl_tpu_torch.models.fc_network import identity_transforms
from mjrl_tpu_torch.models.policies import GaussianMLP
from mjrl_tpu_torch.parallel import make_mesh
from mjrl_tpu_torch.samplers.rollout import rollout_batch

from test_torch_parallel_mesh import (init_ranks, join_ranks, load_ranks,
                                      spawn_ranks)

B, T, HID = 8, 4, (8, 8)
ROLLOUT_TOL, RANK_TOL = 1e-8, 1e-10
LEAVES = ("observations", "actions", "rewards", "mask", "agent_mean",
          "last_obs", "terminated")


def rollouts(inputs, mesh):
    """The four rollouts of this file, on ``mesh`` (None: one rank)."""
    env = HopperEnv(dtype=torch.float64, device="cpu")
    cfg = GaussianMLP(11, 3, HID, dtype=torch.float64, device="cpu")
    params = convert.params_from_numpy(inputs["params"], torch.float64)
    tr = identity_transforms(11, 3, torch.float64)
    roll = lambda gen=None, **kw: rollout_batch(
        env, cfg, params, tr, gen, B, horizon=T, mesh=mesh, **kw)
    start = lambda q, v: env.state_from_qpos_qvel(q, v)
    swimmer = SwimmerEnv(dtype=torch.float64, device="cpu")
    scfg = GaussianMLP(swimmer.observation_dim, swimmer.action_dim, HID,
                       dtype=torch.float64, device="cpu")
    sp, st = scfg.init(torch.Generator().manual_seed(2))
    return {
        "eval": roll(eval_mode=True, state0=start(*inputs["eval_start"])),
        "noise": roll(state0=start(*inputs["table"]),
                      noise=torch.tensor(inputs["noise"])),
        "autoreset": roll(state0=start(*inputs["table"]),
                          noise=torch.tensor(inputs["noise"]),
                          autoreset=True, resets=inputs["resets"]),
        "drawn": rollout_batch(swimmer, scfg, sp, st,
                               torch.Generator().manual_seed(11), 2 * B,
                               horizon=3 * T, mesh=mesh),
    }


def rollout_worker(rank, world, init_method, out_dir):
    init_ranks(rank, world, init_method)
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"),
                        weights_only=False)
    out = rollouts(inputs, make_mesh(device="cpu"))
    torch.save({k: {leaf: v[leaf] for leaf in LEAVES + ("dones",)
                    if leaf in v} for k, v in out.items()},
               os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    from mjrl_tpu.parallel import make_mesh as jax_make_mesh
    from test_torch_gym_suite import _start_table
    from test_torch_policy import numpy_params

    out = tmp_path_factory.mktemp("rollout_ranks")
    p_np = numpy_params(31, HID, obs=11, act=3)
    # the JAX rollout's start states: the table rows its reset keys pick
    # (rollout_batch's split, then the env reset's), checked below against
    # its first observations
    q_tab, v_tab = _start_table()
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    pick = lambda k: jax.random.randint(jax.random.split(
        jax.random.split(k)[0])[1], (), 0, 8)
    rows = np.asarray(jax.vmap(pick)(keys))
    hop = HopperEnv(dtype=torch.float64, device="cpu")
    obs0 = hop.state_from_qpos_qvel(q_tab[rows], v_tab[rows]).obs.numpy()
    rng = np.random.RandomState(7)
    fresh_q = np.tile(hop.model.qpos0, (T, B, 1)) \
        + rng.uniform(-5e-3, 5e-3, (T, B, 6))
    inputs = dict(
        params=p_np,
        eval_start=(q_tab[rows], v_tab[rows]),
        table=(q_tab, v_tab), noise=rng.normal(size=(T, B, 3)),
        resets=(torch.tensor(fresh_q),
                torch.tensor(rng.uniform(-5e-3, 5e-3, (T, B, 6)))))
    four = os.path.join(str(out), "four")
    os.makedirs(four)
    for d in (str(out), four):
        torch.save(inputs, os.path.join(d, "inputs.pt"))
    procs = spawn_ranks("test_torch_parallel_rollout", "rollout_worker", out)
    procs4 = spawn_ranks("test_torch_parallel_rollout", "rollout_worker",
                         four, world=4)
    jb = jax_eval_rollout(p_np, jax_make_mesh())
    jb4 = jax_eval_rollout(p_np, jax_make_mesh(4))
    one = rollouts(inputs, None)
    join_ranks(procs)
    join_ranks(procs4)
    return jb, obs0, one, joined(load_ranks(out)), \
        (jb4, joined(load_ranks(four, world=4)))


def jax_eval_rollout(p_np, mesh):
    """The JAX package's eval rollout of this file, sharded over ``mesh``."""
    import jax
    import jax.numpy as jnp

    from mjrl_tpu.models import policies as jpol
    from mjrl_tpu.models.fc_network import \
        identity_transforms as jax_identity_transforms
    from mjrl_tpu.samplers import rollout as jrollout
    from test_torch_gym_suite import _TableHopper
    from test_torch_policy import to_jax

    jenv = _TableHopper(dtype=jnp.float64)
    return jax.jit(lambda k: jrollout.rollout_batch(
        jenv, jpol.GaussianMLP(11, 3, HID), to_jax(p_np),
        jax_identity_transforms(11, 3, jnp.float64), k, B, horizon=T,
        eval_mode=True, mesh=mesh))(jax.random.PRNGKey(5))


def joined(ranks):
    """The ranks' rows of every rollout put back together."""
    return {k: {leaf: torch.cat([r[k][leaf] for r in ranks])
                for leaf in ranks[0][k]} for k in ranks[0]}


def close(a, b, tol):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("leaf", ["observations", "actions", "rewards",
                                  "mask", "terminated"])
def test_sharded_eval_rollout_matches_the_jax_sharded_rollout(results, leaf):
    jb, obs0, _, two, _ = results
    close(jb["observations"][:, 0], obs0, 1e-15)  # the same starts
    assert len(jb["observations"].sharding.device_set) == 8
    close(two["eval"][leaf], jb[leaf], ROLLOUT_TOL)


def test_eval_batch_has_terminated_and_full_episodes(results):
    _, _, _, two, _ = results
    lengths = two["eval"]["mask"].sum(1)
    assert float(lengths.min()) < T or bool(two["noise"]["terminated"].any())


@pytest.mark.parametrize("name", ["eval", "noise", "autoreset", "drawn"])
def test_two_ranks_equal_one_rank_exactly(results, name):
    _, _, one, two, _ = results
    for leaf in two[name]:
        close(two[name][leaf], one[name][leaf], 0.0)
    if name == "autoreset":
        assert float(two[name]["dones"].sum()) > 0


@pytest.mark.parametrize("name", ["eval", "noise", "autoreset", "drawn"])
def test_four_ranks_equal_one_rank(results, name):
    one, four = results[2], results[4][1]
    for leaf in four[name]:
        close(four[name][leaf], one[name][leaf], RANK_TOL)


@pytest.mark.parametrize("leaf", ["observations", "actions", "rewards",
                                  "mask", "terminated"])
def test_four_rank_eval_rollout_matches_jax_on_4_devices(results, leaf):
    jb, four = results[4]
    assert len(jb["observations"].sharding.device_set) == 4
    close(four["eval"][leaf], jb[leaf], ROLLOUT_TOL)
