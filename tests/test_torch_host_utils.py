"""Port vs JAX package: the small host utilities (CPU).

``tensor_utils`` on nested dicts of numpy arrays and of tensors against
the JAX package's (exact: the same copies), ``expand_grid`` and
``run_sweep`` with a stub entry against the JAX sweep (the same job
directories and configs), the sweep through the port's job script,
``plot_from_logs``, ``profiling`` and ``get_environment``.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from mjrl_tpu.utils import sweep as jsweep
from mjrl_tpu.utils import tensor_utils as jtu
from mjrl_tpu_torch.envs import GymEnv
from mjrl_tpu_torch.utils import profiling, sweep
from mjrl_tpu_torch.utils import tensor_utils as tu
from mjrl_tpu_torch.utils.get_environment import get_environment
from mjrl_tpu_torch.utils.plot_from_logs import plot_from_logs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def path_dicts(seed, n=3):
    rng = np.random.RandomState(seed)
    return [{"observations": rng.normal(size=(4, 2)),
             "env_infos": {"solved": rng.normal(size=(4,)) > 0,
                           "state": {"qp": rng.normal(size=(4, 3))}}}
            for _ in range(n)]


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.asarray(tree))


def assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_tree_equal(got[k], want[k])
        return
    got = got.numpy() if torch.is_tensor(got) else got
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_tensor_utils_match_jax(kind):
    dicts = path_dicts(0)
    mine = dicts if kind == "numpy" else [to_torch(d) for d in dicts]
    stacked = tu.stack_tensor_dict_list(mine)
    assert_tree_equal(stacked, jtu.stack_tensor_dict_list(dicts))
    assert_tree_equal(tu.concat_tensor_dict_list(mine),
                      jtu.concat_tensor_dict_list(dicts))
    for got, want in zip(tu.split_tensor_dict_list(stacked),
                         jtu.split_tensor_dict_list(
                             jtu.stack_tensor_dict_list(dicts))):
        assert_tree_equal(got, want)
    arrays = [np.arange(6.0).reshape(2, 3), np.arange(4.0)]
    mine = arrays if kind == "numpy" else [torch.tensor(a) for a in arrays]
    flat = tu.flatten_tensors(mine)
    assert_tree_equal(flat, jtu.flatten_tensors(arrays))
    for got, want in zip(tu.unflatten_tensors(flat, [(2, 3), (4,)]),
                         jtu.unflatten_tensors(jtu.flatten_tensors(arrays),
                                               [(2, 3), (4,)])):
        assert_tree_equal(got, want)
    ragged = [np.ones((2, 3)), np.ones((5, 3)) * 2]
    mine = ragged if kind == "numpy" else [torch.tensor(a) for a in ragged]
    assert_tree_equal(tu.pad_tensor_n(mine, 6), jtu.pad_tensor_n(ragged, 6))
    assert len(tu.flatten_tensors([])) == 0


def test_expand_grid_matches_jax():
    grid = ["rl_step_size=0.05,0.1", "seed=1,2,3", "tag=a"]
    assert sweep.expand_grid(grid) == jsweep.expand_grid(grid)
    assert len(sweep.expand_grid(grid)) == 6
    assert sweep.expand_grid([]) == jsweep.expand_grid([]) == [[]]


def test_run_sweep_with_a_stub_entry_matches_jax(tmp_path):
    base = {"seed": 0, "train": {"niter": 3}, "env": "mjrl_swimmer-v0"}
    grid = ["seed=1,2", "train.niter=5"]
    calls = {"jax": [], "port": []}
    jres = jsweep.run_sweep(str(tmp_path / "jax"), base, grid,
                            lambda d, c: calls["jax"].append((d, c)))
    tres = sweep.run_sweep(str(tmp_path / "port"), base, grid,
                           lambda d, c: calls["port"].append((d, c)))
    assert [os.path.basename(d) for d, _ in tres] == \
        [os.path.basename(d) for d, _ in jres]
    assert [o for _, o in tres] == [o for _, o in jres]
    for (td, tc), (jd, jc) in zip(calls["port"], calls["jax"]):
        with open(tc) as f, open(jc) as g:
            assert json.load(f) == json.load(g)
        assert os.path.dirname(tc) == td
    assert base["seed"] == 0                   # the base config untouched
    assert sweep._resolve_entry("json:dumps") is json.dumps


def test_sweep_through_the_job_script(tmp_path):
    """The default entry: the port's job script on each point (here on
    the CPU with a 5-step horizon)."""
    cfg = os.path.join(REPO, "examples", "example_configs",
                       "swimmer_ppo.json")
    with open(cfg) as f:
        base = json.load(f)
    res = sweep.run_sweep(
        str(tmp_path), base, ["seed=1,2", "rl_num_iter=1", "rl_num_traj=2"],
        sweep.job_script_entry("--device", "cpu", "--horizon", "5"))
    assert len(res) == 2
    for job_dir, overrides in res:
        with open(os.path.join(job_dir, "logs", "log.pickle"), "rb") as f:
            log = pickle.load(f)
        assert np.isfinite(log["stoc_pol_mean"]).all()
        with open(os.path.join(job_dir, "job_config.json")) as f:
            assert json.load(f)["seed"] == int(overrides[0].split("=")[1])


ENTRY_CALLS = []


def record_entry(job_dir, config_path):
    ENTRY_CALLS.append((job_dir, config_path))


def test_sweep_cli_with_an_entry(tmp_path):
    cfg = tmp_path / "base.json"
    cfg.write_text(json.dumps({"seed": 0}))
    ENTRY_CALLS.clear()
    res = sweep.main(["--output", str(tmp_path / "out"), "--config",
                      str(cfg), "--grid", "seed=4,5", "--entry",
                      "test_torch_host_utils:record_entry"])
    assert [c[0] for c in ENTRY_CALLS] == [d for d, _ in res]
    assert [o for _, o in res] == [["seed=4"], ["seed=5"]]


def test_plot_from_logs(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    log = {"a": [1.0, 2.0, 3.0], "b": [3, 2, 1], "s": ["x"]}
    p = tmp_path / "log.pickle"
    with open(p, "wb") as f:
        pickle.dump(log, f)
    out = str(tmp_path / "plot.png")
    assert plot_from_logs(str(p), out) is True
    assert os.path.getsize(out) > 1000
    assert plot_from_logs({"s": ["x"]}, str(tmp_path / "none.png")) is False
    # without matplotlib: says so and writes nothing
    import builtins
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError("no matplotlib")
        return real_import(name, *args, **kwargs)
    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    assert plot_from_logs(log, str(tmp_path / "none.png")) is False
    assert not os.path.exists(tmp_path / "none.png")


def test_profiling_trace_and_time_jitted(tmp_path):
    x = torch.ones(16)
    t = profiling.time_jitted(lambda v: (v * 2.0).sum(), x, iters=3)
    assert t > 0.0
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(8).mul(3.0).sum()
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert len(prof.key_averages()) > 0


def test_get_environment():
    e = get_environment("mjrl_point_mass-v0", device="cpu")
    assert isinstance(e, GymEnv) and e.observation_dim == 6
    assert get_environment() is None
