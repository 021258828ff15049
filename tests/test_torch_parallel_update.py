"""Sharded updates, baselines and the ensemble on two gloo ranks (CPU,
float64, numpy-seeded data).

One batch of 8 paths x 6 steps with a ragged validity mask is split by
rows, each rank taking 4 paths, and goes through:

- the NPG update (gradient, CG over all-reduced Fisher-vector products,
  step size, KL guard, new parameters) against the JAX package's
  ``_update_core`` on the whole batch at the existing ``SOLVE_TOL`` 1e-8
  of ``tests/test_torch_npg.py``, and against the one-rank port at 1e-10;
- NPG with ``hvp_sample_frac = 0.5`` (a permutation of all rows, each rank
  keeping its own), TRPO, PPO with injected minibatch indices over all
  rows, and DAPG with 3 demo paths of 13 rows in all (an odd count, cut
  unevenly over the ranks): against the one-rank port at 1e-10;
- the linear, quadratic and MLP baselines (injected permutations): against
  the one-rank port at 1e-10 and the JAX package's fits at the tolerances
  of ``tests/test_torch_baselines.py`` (1e-8 for the least squares, 1e-10
  for Adam); the MLP fit also with its permutations drawn by its own
  generator, as the learning runs draw them: against one rank at 1e-10;
- a 4-member ``WorldModelEnsemble`` on the mesh, 2 members a rank, fitted
  with the members' drawn permutations: the same losses, stacked
  parameters, ``predict_all`` and generator states as one rank, at 1e-12.

Both ranks must hold the same result, bit for bit.  The same cases on four
ranks (2 paths and one ensemble member each) equal one rank at the same
tolerances, and their NPG update equals the JAX package's ``_update_core``
with the batch sharded over 4 of the 8 virtual devices at ``SOLVE_TOL``.
The ranks import this file, which imports JAX only inside its fixtures.
"""

import os

import numpy as np
import pytest
import torch

from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos import DAPG, NPG, PPO, TRPO
from mjrl_tpu_torch.algos.model_accel.nn_dynamics import WorldModelEnsemble
from mjrl_tpu_torch.baselines import LinearBaseline as HostLinear
from mjrl_tpu_torch.envs.base import EnvSpec
from mjrl_tpu_torch.envs.point_mass import PointMassEnv
from mjrl_tpu_torch.models import baselines as tbl
from mjrl_tpu_torch.models import policies as tpol
from mjrl_tpu_torch.parallel import make_mesh, shard_rollout_keys

from test_torch_parallel_mesh import (init_ranks, join_ranks, load_ranks,
                                      spawn_ranks)

OBS, ACT, HID = 6, 2, (8, 8)
N, T = 8, 6
D, A = 4, 2                      # the ensemble's state and action widths
RANK_TOL, ENS_TOL, SOLVE_TOL, ADAM_TOL = 1e-10, 1e-12, 1e-8, 1e-10
STATS = ("alpha", "delta", "surr_before", "surr_after", "kl_dist")


def make_inputs():
    rng = np.random.RandomState(3)
    sizes = (OBS,) + HID + (ACT,)
    p_np = {"layers": [{"w": rng.normal(0, 0.4, (sizes[i], sizes[i + 1])),
                        "b": rng.normal(0, 0.1, (sizes[i + 1],))}
                       for i in range(len(sizes) - 1)],
            "log_std": np.array([-0.4, 0.2])}
    t_np = (rng.normal(0, 0.3, OBS), rng.uniform(0.5, 2.0, OBS),
            np.zeros(ACT), np.ones(ACT))
    lengths = np.array([6, 2, 6, 5, 6, 3, 1, 6])
    mask = (np.arange(T)[None] < lengths[:, None]).astype(np.float64)
    bsizes = (OBS + 4,) + HID + (1,)
    s = rng.normal(size=(64, D))
    a = rng.normal(size=(64, A))
    return dict(
        p_np=p_np, t_np=t_np, mask=mask,
        obs=rng.normal(0, 4.0, (N, T, OBS)),
        act=rng.normal(size=(N, T, ACT)), adv=rng.normal(size=(N, T)),
        rets=rng.normal(0, 3.0, (N, T)),
        ppo_idxs=rng.randint(0, N * T, (2 * (N * T // 8), 8)),
        mlp_layers=[{"w": rng.normal(0, 0.5, (bsizes[i], bsizes[i + 1])),
                     "b": rng.normal(0, 0.1, (bsizes[i + 1],))}
                    for i in range(len(bsizes) - 1)],
        demos=[{"observations": rng.normal(size=(k, OBS)),
                "actions": rng.normal(size=(k, ACT))} for k in (3, 4, 6)],
        ens=(s, a, s + 0.1 * np.tanh(a @ rng.normal(size=(A, D)))))


def mlp_state(layers, cfg):
    """The MLP baseline's state from JAX-layout layers, Adam at zero."""
    params, opt = cfg.init(torch.Generator().manual_seed(0),
                           dtype=torch.float64, device="cpu")
    params = convert.layers_from_numpy(layers, torch.float64)
    zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
    return params, {**opt, "mu": zeros(), "nu": zeros()}


def cases(inp, mesh):
    """Every update, fit and the ensemble of this file on ``mesh`` (None:
    one rank) -> {case: {name: tensor}}."""
    shard = lambda x: shard_rollout_keys(torch.tensor(x), mesh)
    flat = lambda x: shard(x).reshape((-1,) + x.shape[2:])
    obs, act, adv, mask = (flat(inp[k]) for k in ("obs", "act", "adv",
                                                  "mask"))
    spec = EnvSpec(OBS, ACT, T)
    policy = tpol.MLP(spec, hidden_sizes=HID, dtype=torch.float64,
                      device="cpu")
    convert.policy_params_from_numpy(policy, inp["p_np"], inp["t_np"])
    env = PointMassEnv(dtype=torch.float64, device="cpu")

    def agent(cls, **kw):
        return cls(env, policy, HostLinear(spec, dtype=torch.float64,
                                           device="cpu"), device="cpu",
                   mesh=mesh, **kw)

    args = (policy.params, policy.transforms, obs, act, adv, mask)
    out = {}
    for name, a, gen in (
            ("npg", agent(NPG, normalized_step_size=0.05), None),
            ("npg_sub", agent(NPG, normalized_step_size=0.05,
                              hvp_sample_frac=0.5),
             torch.Generator().manual_seed(4)),
            ("trpo", agent(TRPO, kl_dist=0.01), None)):
        new, st = a._update_core(*args, gen, mesh=mesh)
        out[name] = {**new, **{k: st[k] for k in STATS}}
    ppo = agent(PPO, mb_size=8, epochs=2)
    new, st, opt = ppo._update_core(*args, None, ppo.opt_state,
                                    idxs=inp["ppo_idxs"], mesh=mesh)
    out["ppo"] = {**new, "surr_after": st["surr_after"],
                  "kl_dist": st["kl_dist"], **{f"mu.{k}": v for k, v in
                                               opt["mu"].items()}}
    dapg = agent(DAPG, demo_paths=inp["demos"], normalized_step_size=0.05)
    new, st, _ = dapg._update_core(*args, None, torch.zeros(
        (), dtype=torch.float64), mesh=mesh)
    out["dapg"] = {**new, **{k: st[k] for k in STATS}}
    # the baselines on this rank's paths
    b_obs, b_rets, b_mask = (shard(inp[k]) for k in ("obs", "rets", "mask"))
    for name, cfg in (("linear", tbl.LinearBaseline(OBS)),
                      ("quadratic", tbl.QuadraticBaseline(OBS))):
        c, e0, e1 = cfg.fit(cfg.init(dtype=torch.float64), b_obs, b_rets,
                            b_mask, mesh=mesh)
        out[name] = {"coeffs": c, "e0": e0, "e1": e1}
    cfg = tbl.MLPBaseline(OBS, hidden_sizes=HID, batch_size=8, epochs=2)
    (params, opt), e0, e1 = cfg.fit(mlp_state(inp["mlp_layers"], cfg), b_obs,
                                    b_rets, b_mask, perms=inp["mlp_perms"],
                                    mesh=mesh)
    out["mlp"] = {**params, "e0": e0, "e1": e1,
                  **{f"nu.{k}": v for k, v in opt["nu"].items()}}
    # the same fit with its permutations drawn by a generator of its own,
    # seeded alike on every rank, as the learning runs draw them
    gen = torch.Generator().manual_seed(5)
    (params, _), e0, e1 = cfg.fit(mlp_state(inp["mlp_layers"], cfg), b_obs,
                                  b_rets, b_mask, generator=gen, mesh=mesh)
    out["mlp_generator"] = {**params, "e0": e0, "e1": e1,
                            "generator": gen.get_state().double()}
    # the ensemble, its model axis over the mesh
    ens = WorldModelEnsemble(4, D, A, seed=3, hidden_size=(16, 16),
                             device="cpu", dtype=torch.float64, mesh=mesh)
    s, a, sp = inp["ens"]
    losses = ens.fit_dynamics(s, a, sp, 16, 2)
    out["ensemble"] = {
        "losses": torch.tensor(losses), **ens._dyn["params"],
        "predict_all": ens.predict_all(s[:5], a[:5]),
        "counts": torch.tensor(ens._counts),
        "generators": torch.stack([m.generator.get_state().double()
                                   for m in ens.members])}
    return out


def update_worker(rank, world, init_method, out_dir):
    init_ranks(rank, world, init_method)
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    torch.save(cases(inp, make_mesh(device="cpu")),
               os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    from test_torch_baselines import jax_perms

    out = tmp_path_factory.mktemp("update_ranks")
    inp = make_inputs()
    key = jax.random.PRNGKey(11)
    inp["mlp_key"], inp["mlp_perms"] = key, jax_perms(key, 2, N * T)
    four = os.path.join(str(out), "four")
    os.makedirs(four)
    for d in (str(out), four):
        torch.save({k: v for k, v in inp.items() if k != "mlp_key"},
                   os.path.join(d, "inputs.pt"))
    procs = spawn_ranks("test_torch_parallel_update", "update_worker", out)
    procs4 = spawn_ranks("test_torch_parallel_update", "update_worker", four,
                         world=4)
    jax_out = jax_side(inp)
    jax_out["npg_4_devices"] = jax_npg(inp, n_devices=4)
    one = cases(inp, None)
    join_ranks(procs)
    join_ranks(procs4)
    return inp, one, load_ranks(out), jax_out, load_ranks(four, world=4)


def jax_npg(inp, n_devices=None):
    """The JAX package's NPG update on the whole batch, its rows sharded
    over ``n_devices`` of the virtual devices when given."""
    import jax
    import jax.numpy as jnp

    from mjrl_tpu.algos.npg_cg import NPG as JaxNPG
    from mjrl_tpu.models import policies as jpol
    from mjrl_tpu.models.fc_network import Transforms as JTransforms
    from mjrl_tpu.parallel import batch_sharding
    from mjrl_tpu.parallel import make_mesh as jax_make_mesh
    J = lambda x: jnp.asarray(x, jnp.float64)
    jpolicy = jpol.MLP(EnvSpec(OBS, ACT, T), hidden_sizes=HID)
    jpolicy.params = jpolicy.old_params = jax.tree_util.tree_map(
        J, inp["p_np"])
    jpolicy.transforms = JTransforms(*(J(x) for x in inp["t_np"]))
    flat = lambda k: J(inp[k].reshape((N * T,) + inp[k].shape[2:]))
    rows = [flat(k) for k in ("obs", "act", "adv", "mask")]
    if n_devices is not None:
        sharding = batch_sharding(jax_make_mesh(n_devices))
        rows = [jax.device_put(x, sharding) for x in rows]
        assert len(rows[0].sharding.device_set) == n_devices
    jagent = JaxNPG(None, jpolicy, None, normalized_step_size=0.05)
    return jax.jit(jagent._update_core)(
        jpolicy.params, jpolicy.transforms, *rows, jax.random.PRNGKey(0))


def jax_side(inp):
    """The JAX package's NPG update and baseline fits on the whole batch."""
    import jax
    import jax.numpy as jnp

    from mjrl_tpu.models import baselines as jbl
    J = lambda x: jnp.asarray(x, jnp.float64)
    out = {"npg": jax_npg(inp)}
    obs, rets, mask = J(inp["obs"]), J(inp["rets"]), J(inp["mask"])
    for name, cfg in (("linear", jbl.LinearBaseline(OBS)),
                      ("quadratic", jbl.QuadraticBaseline(OBS))):
        out[name] = cfg.fit(jnp.zeros(cfg.num_features(), jnp.float64), obs,
                            rets, mask)
    cfg = jbl.MLPBaseline(OBS, hidden_sizes=HID, batch_size=8, epochs=2)
    layers = jax.tree_util.tree_map(J, inp["mlp_layers"])
    out["mlp"] = jax.jit(cfg.fit)((layers, cfg._optimizer().init(layers)),
                                  obs, rets, mask, inp["mlp_key"])
    return out


def close(a, b, tol):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


CASES = ("npg", "npg_sub", "trpo", "ppo", "dapg", "linear", "quadratic",
         "mlp", "mlp_generator", "ensemble")


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_one_rank(results, case):
    _, one, ranks, _, _ = results
    tol = ENS_TOL if case == "ensemble" else RANK_TOL
    assert set(ranks[0][case]) == set(one[case])
    for k, v in one[case].items():
        close(ranks[0][case][k], v, tol)
        # every rank holds the same result, bit for bit
        close(ranks[1][case][k], ranks[0][case][k], 0.0)


@pytest.mark.parametrize("case", CASES)
def test_four_ranks_equal_one_rank(results, case):
    one, ranks = results[1], results[4]
    tol = ENS_TOL if case == "ensemble" else RANK_TOL
    assert set(ranks[0][case]) == set(one[case])
    for k, v in one[case].items():
        close(ranks[0][case][k], v, tol)
        for r in ranks[1:]:
            close(r[case][k], ranks[0][case][k], 0.0)


def test_sharded_npg_update_matches_jax(results):
    _, _, ranks, jax_out, _ = results
    check_npg_against_jax(ranks[0]["npg"], jax_out["npg"])


def test_four_rank_npg_update_matches_the_jax_update_on_4_devices(results):
    _, _, _, jax_out, ranks = results
    check_npg_against_jax(ranks[0]["npg"], jax_out["npg_4_devices"])


def check_npg_against_jax(got, jax_out):
    jnew, jst = jax_out
    tree = convert.params_to_numpy({k: v for k, v in got.items()
                                    if k not in STATS})
    for lg, lj in zip(tree["layers"], jnew["layers"]):
        close(lg["w"], lj["w"], SOLVE_TOL)
        close(lg["b"], lj["b"], SOLVE_TOL)
    close(tree["log_std"], jnew["log_std"], SOLVE_TOL)
    for k in STATS:
        close(got[k], jst[k], SOLVE_TOL)


@pytest.mark.parametrize("case", ["linear", "quadratic", "mlp"])
def test_sharded_baseline_fits_match_jax(results, case):
    _, _, ranks, jax_out, _ = results
    got = ranks[0][case]
    jstate, je0, je1 = jax_out[case]
    if case == "mlp":
        params = {k: v for k, v in got.items() if k.startswith("layers.")}
        for lt, lj in zip(convert.layers_to_numpy(params), jstate[0]):
            close(lt["w"], lj["w"], ADAM_TOL)
            close(lt["b"], lj["b"], ADAM_TOL)
        tol = ADAM_TOL
    else:
        close(got["coeffs"], jstate, SOLVE_TOL)
        tol = SOLVE_TOL
    close(got["e0"], je0, tol)
    close(got["e1"], je1, tol)


def test_the_cases_do_real_work(results):
    """The demo rows split unevenly, the subsampled Fisher differs from the
    full one, the ensemble's members differ and each fitted 8 steps."""
    inp, one, _, _, _ = results
    assert sum(len(d["observations"]) for d in inp["demos"]) % 2 == 1
    assert float((one["npg_sub"]["layers.0.weight"]
                  - one["npg"]["layers.0.weight"]).abs().max()) > 1e-8
    ens = one["ensemble"]
    assert float((ens["predict_all"][0] - ens["predict_all"][1]).abs()
                 .max()) > 1e-6
    assert ens["counts"].tolist() == [2 * (64 // 16)] * 4
