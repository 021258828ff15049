"""The port's data parallelism helpers (``mjrl_tpu_torch.parallel``) on the
CPU, and the harness the other ``test_torch_parallel_*`` files run their
ranks with.

Two real processes join a ``gloo`` group through ``distributed.initialize``
(TCP, driven by MJRL_COORDINATOR / MJRL_NUM_PROCS / MJRL_PROC_ID, as the
JAX package's ``tests/test_distributed.py`` drives ``jax.distributed``) and
check the helpers that test ported: a host-sharded (4, 3) per rank is a
(8, 3) array summing to 12, ``all_hosts_mean(10, 20)`` is 15, a
``HostShardedBuffer`` draws 2 x ``per_host_n`` rows; then the collectives
and row splits the training layers use, and the two refusals of an uneven
split.  The one-rank helpers are checked in this process.

This file imports no JAX: the other files' workers import its harness.
"""

import datetime
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mjrl_tpu_torch.parallel import (batch_sharding, make_mesh,
                                     replicated_sharding, shard_rollout_keys)
from mjrl_tpu_torch.parallel import distributed as pdist
from mjrl_tpu_torch.parallel.mesh import (Mesh, all_reduce_tree,
                                          gather_rows, local_index,
                                          row_offset)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORLD = 2
GROUP_TIMEOUT_S = 60      # a collective that waits longer fails the rank
RANKS_TIMEOUT_S = 240     # the whole pair, start-up included


# -- the harness -------------------------------------------------------------

class RowsOnly(Mesh):
    """Rank ``rank`` of ``size`` in this one process, for a layer that only
    cuts rows (a rollout, a reset): any collective fails the test."""

    def __init__(self, rank, size, device="cpu"):
        super().__init__(None, 0, 1, device)
        self.rank, self.size = int(rank), int(size)

    def all_reduce_sum(self, x):
        raise AssertionError("a collective where rows are only cut")


def init_ranks(rank, world, init_method):
    """In a worker: one torch thread, and a gloo group over CPU tensors
    (``init_method`` a ``file://`` path, so parallel test runs never race
    for a port)."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))


def spawn_ranks(module, func, out_dir, world=WORLD, env_of=None):
    """Start ``world`` processes running ``module.func(rank, world,
    init_method, out_dir)`` (``module`` a file of tests/, imported without
    JAX; ``env_of(rank)``: a rank's environment) -> the processes."""
    out_dir = str(out_dir)
    init = "file://" + os.path.join(out_dir, "group_init")
    code = (f"import sys; sys.path[:0] = [{TESTS!r}, {REPO!r}]; "
            f"import {module} as m; "
            f"m.{func}(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], "
            f"sys.argv[4])")
    env_of = env_of or (lambda r: os.environ)
    return [subprocess.Popen([sys.executable, "-c", code, str(r),
                              str(world), init, out_dir],
                             env=dict(env_of(r), OMP_NUM_THREADS="1"),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(world)]


def join_ranks(procs, timeout=RANKS_TIMEOUT_S):
    """Wait for every rank; the first to fail (or the deadline) kills the
    rest and fails with the ranks' output."""
    deadline = time.time() + timeout
    while any(p.poll() is None for p in procs):
        failed = any(p.poll() not in (None, 0) for p in procs)
        if failed or time.time() > deadline:
            for p in procs:
                p.kill()
            break
        time.sleep(0.05)
    outs = [p.communicate()[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed (rc {p.returncode}):\n" \
            + "\n".join(f"--- rank {i} ---\n{o}" for i, o in enumerate(outs))
    return outs


def load_ranks(out_dir, world=WORLD):
    """Every rank's ``rank<r>.pt``."""
    return [torch.load(os.path.join(str(out_dir), f"rank{r}.pt"))
            for r in range(world)]


# -- the mesh helpers on two ranks ---------------------------------------------

def mesh_worker(rank, world, init_method, out_dir):
    torch.set_num_threads(1)
    res = {"initialized": pdist.initialize(device="cpu", timeout=60)}
    res["is_distributed"] = pdist.is_distributed()
    mesh = pdist.global_mesh(device="cpu")
    res["mesh"] = [mesh.rank, mesh.size, str(mesh.device)]
    # ported from tests/test_distributed.py's worker
    arr = pdist.host_sharded(mesh, np.full((4, 3), float(rank), np.float32))
    res["global_shape"] = list(arr.shape)
    res["sum"] = float(arr.sum())
    res["gathered"] = arr.gather()[:, 0].tolist()
    res["mean"] = pdist.all_hosts_mean(mesh, 10.0 * (rank + 1))
    buf = pdist.HostShardedBuffer(max_steps=100, seed=rank)
    rng = np.random.RandomState(rank)
    buf.add_paths([{"observations": rng.randn(6, 2).astype(np.float32),
                    "actions": rng.randn(6, 1).astype(np.float32),
                    "rewards": rng.randn(6).astype(np.float32)}])
    gb = buf.global_batch(mesh, per_host_n=8)
    res["buffer_shapes"] = {k: list(v.shape) for k, v in gb.items()}
    res["buffer_local_rows"] = gb["s"].local.shape[0]
    # the collectives of the training layers
    before = mesh.collectives
    tree, extra = all_reduce_tree(
        {"w": torch.full((2, 2), rank + 1.0), "b": torch.tensor([rank])},
        mesh, extra=torch.tensor([1.0]))
    res["tree"] = [tree["w"].tolist(), tree["b"].tolist(), extra.tolist()]
    res["gather_bool"] = gather_rows(torch.tensor([rank == 1]),
                                     mesh).tolist()
    res["collectives"] = mesh.collectives - before
    res["rows"] = [batch_sharding(mesh).rows(8).start,
                   batch_sharding(mesh).rows(8).stop,
                   replicated_sharding(mesh).rows(8).stop]
    res["keys"] = shard_rollout_keys(torch.arange(6), mesh).tolist()
    res["cut"] = mesh.cut(torch.arange(5)).tolist()
    res["offset"] = list(row_offset(3, mesh))
    idx, own = local_index(torch.tensor([0, 3, 5, 2]),
                           row_offset(3, mesh)[0], 3)
    res["local_index"] = [idx.tolist(), own.tolist()]
    # uneven splits raise, naming both numbers
    from mjrl_tpu_torch.algos.model_accel.nn_dynamics import \
        WorldModelEnsemble
    from mjrl_tpu_torch.envs.point_mass import PointMassEnv
    from mjrl_tpu_torch.models.policies import GaussianMLP
    from mjrl_tpu_torch.samplers.rollout import rollout_batch
    env = PointMassEnv(dtype=torch.float64, device="cpu")
    pol = GaussianMLP(env.observation_dim, env.action_dim, (4,),
                      dtype=torch.float64, device="cpu")
    params, tr = pol.init(torch.Generator().manual_seed(0))
    errors = {}
    for name, fn in (
            ("rollout", lambda: rollout_batch(
                env, pol, params, tr, torch.Generator().manual_seed(0), 3,
                horizon=2, mesh=mesh)),
            ("ensemble", lambda: WorldModelEnsemble(
                3, 4, 2, mesh=mesh, device="cpu")),
            ("mesh_of_3", lambda: make_mesh(3, device="cpu"))):
        try:
            fn()
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    res["errors"] = errors
    one = make_mesh(1, device="cpu")
    res["one_rank"] = [one.size, one.group is None,
                       one.all_reduce_sum(torch.tensor(2.0)).item()]
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_ranks")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env_of = lambda r: dict(os.environ, MJRL_COORDINATOR=f"127.0.0.1:{port}",
                            MJRL_NUM_PROCS=str(WORLD), MJRL_PROC_ID=str(r))
    join_ranks(spawn_ranks("test_torch_parallel_mesh", "mesh_worker", out,
                           env_of=env_of))
    res = []
    for r in range(WORLD):
        with open(os.path.join(str(out), f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res


def test_initialize_joins_the_group_from_the_environment(ranks):
    for r, res in enumerate(ranks):
        assert res["initialized"] and res["is_distributed"]
        assert res["mesh"] == [r, WORLD, "cpu"]


def test_host_sharded_and_all_hosts_mean(ranks):
    for res in ranks:
        assert res["global_shape"] == [8, 3]
        assert res["sum"] == 12.0
        assert res["gathered"] == [0.0] * 4 + [1.0] * 4
        assert abs(res["mean"] - 15.0) < 1e-12


def test_host_sharded_buffer_global_batch(ranks):
    for res in ranks:
        assert res["buffer_shapes"] == {"s": [16, 2], "a": [16, 1],
                                        "sp": [16, 2], "r": [16]}
        assert res["buffer_local_rows"] == 8


def test_collectives_and_row_splits(ranks):
    for r, res in enumerate(ranks):
        assert res["tree"] == [[[3.0, 3.0], [3.0, 3.0]], [1], [2.0]]
        assert res["gather_bool"] == [False, True]
        assert res["collectives"] == 2
        assert res["rows"] == [4 * r, 4 * r + 4, 8]
        assert res["keys"] == list(range(3 * r, 3 * r + 3))
        assert res["cut"] == [[0, 1, 2], [3, 4]][r]
        assert res["offset"] == [3 * r, 6]
        want = [[[0, 2, 2, 2], [True, False, False, True]],
                [[0, 0, 2, 0], [False, True, True, False]]][r]
        assert res["local_index"] == want
        assert res["one_rank"] == [1, True, 2.0]


def test_uneven_splits_raise(ranks):
    for res in ranks:
        err = res["errors"]
        assert "3" in err["rollout"] and "2" in err["rollout"]
        assert "3" in err["ensemble"] and "2" in err["ensemble"]
        assert "3" in err["mesh_of_3"] and "2" in err["mesh_of_3"]


# -- one rank, in this process --------------------------------------------------

LAUNCH_VARS = ("MJRL_COORDINATOR", "MJRL_NUM_PROCS", "MJRL_PROC_ID",
               "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
               "LOCAL_RANK")


def test_initialize_without_the_environment_is_a_no_op(monkeypatch):
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    assert pdist.initialize() is False
    assert not dist.is_initialized() and not pdist.is_distributed()


def _record_init(monkeypatch, cards):
    """Stand-ins for a host with ``cards`` cards (0: none) and for
    ``init_process_group`` -> the record of what initialize asked for."""
    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.__setitem__("card", str(d)))
    monkeypatch.setattr(pdist.tdist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    return seen


def test_initialize_binds_the_launchers_card(monkeypatch):
    """torchrun's variables: LOCAL_RANK's card, NCCL, torchrun's store;
    the port's own: the rank modulo the cards; the CPU when asked for."""
    seen = _record_init(monkeypatch, cards=4)
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT="29511",
                     WORLD_SIZE="8", RANK="6", LOCAL_RANK="2").items():
        monkeypatch.setenv(k, v)
    assert pdist.initialize() is True
    assert (seen["card"], seen["backend"], seen["init_method"],
            seen["world_size"], seen["rank"]) == ("cuda:2", "nccl",
                                                  "env://", 8, 6)
    monkeypatch.setenv("MJRL_COORDINATOR", "127.0.0.1:29512")
    monkeypatch.setenv("MJRL_NUM_PROCS", "8")
    monkeypatch.setenv("MJRL_PROC_ID", "5")
    monkeypatch.delenv("LOCAL_RANK")
    seen.clear()
    assert pdist.initialize(backend="gloo") is True
    assert (seen["card"], seen["backend"], seen["init_method"],
            seen["rank"]) == ("cuda:1", "gloo", "tcp://127.0.0.1:29512", 5)
    seen.clear()
    pdist.initialize(device="cpu")
    assert "card" not in seen and seen["backend"] == "gloo"


def test_make_mesh_and_initialize_raise_without_a_card(monkeypatch):
    """Without a card the mesh and the group use the CPU only when the
    caller asks for it."""
    seen = _record_init(monkeypatch, cards=0)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pdist.global_mesh()
    assert make_mesh(device="cpu").device.type == "cpu"
    for env in (dict(MASTER_ADDR="127.0.0.1", MASTER_PORT="29513",
                     WORLD_SIZE="2", RANK="0", LOCAL_RANK="0"),
                dict(MJRL_COORDINATOR="127.0.0.1:29514", MJRL_NUM_PROCS="2",
                     MJRL_PROC_ID="0")):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            pdist.initialize()
        assert seen == {}
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            pdist.initialize(backend="gloo")
        for k in env:
            monkeypatch.delenv(k)


def launcher_worker(rank, world, init_method, out_dir):
    """One rank started with torchrun's variables (no MJRL_*)."""
    torch.set_num_threads(1)
    res = {"initialized": pdist.initialize(device="cpu", timeout=60),
           "local_rank": os.environ["LOCAL_RANK"]}
    mesh = pdist.global_mesh(device="cpu")
    res["mesh"] = [mesh.rank, mesh.size, str(mesh.device)]
    res["mean"] = pdist.all_hosts_mean(mesh, 10.0 * (rank + 1))
    mesh.check_same("a value every rank holds", [3.0, float("nan")])
    try:
        mesh.check_same("the rank", [rank])
        res["disagreement"] = None
    except RuntimeError as e:
        res["disagreement"] = str(e)
    mesh.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def test_initialize_from_torchruns_variables(tmp_path):
    """Two processes with the variables ``torchrun`` sets join one group;
    the ranks' agreement check passes on equal values and names the ones
    that differ."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    base = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env_of = lambda r: dict(base, MASTER_ADDR="127.0.0.1",
                            MASTER_PORT=str(port), WORLD_SIZE=str(WORLD),
                            RANK=str(r), LOCAL_RANK=str(r))
    join_ranks(spawn_ranks("test_torch_parallel_mesh", "launcher_worker",
                           tmp_path, env_of=env_of))
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.json") as f:
            res = json.load(f)
        assert res["initialized"] and res["local_rank"] == str(r)
        assert res["mesh"] == [r, WORLD, "cpu"]
        assert abs(res["mean"] - 15.0) < 1e-12
        assert "the rank" in res["disagreement"]


def test_one_rank_mesh_without_a_group():
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    assert mesh.axis_names == ("batch",)
    x = torch.arange(6.0)
    assert mesh.all_reduce_sum(x) is x and mesh.gather(x) is x
    assert mesh.collectives == 0
    assert shard_rollout_keys(x, None) is x
    assert torch.equal(shard_rollout_keys(x, mesh), x)
    assert make_mesh(devices=[torch.device("cpu")]).device.type == "cpu"
    with pytest.raises(ValueError, match="2 ranks needs a process group"):
        Mesh(None, 1, 2, "cpu")
    with pytest.raises(ValueError, match="2 ranks"):
        make_mesh(2, device="cpu")
    assert pdist.all_hosts_mean(mesh, 4.5) == 4.5


def test_shard_rollout_keys_slices_every_leaf_of_a_state():
    from mjrl_tpu_torch.envs.point_mass import PointMassEnv

    env = PointMassEnv(dtype=torch.float64, device="cpu")
    s = env.reset(6, torch.Generator().manual_seed(1))
    half = shard_rollout_keys(s, RowsOnly(1, 2))
    assert torch.equal(half.obs, s.obs[3:])
    assert torch.equal(half.physics.qpos, s.physics.qpos[3:])
    for k in s.scenery:
        assert torch.equal(half.scenery[k], s.scenery[k][3:])
    assert torch.equal(half.t, s.t[3:])
