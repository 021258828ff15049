"""The benchmark's files: BENCHMARK.json against the contract's shape, the
files every entry is found by, and the frozen counts of each
configuration."""

import json
import os
import re

import pytest

from conftest import ROOT, bench, workloads

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PB = os.path.join(ROOT, "portbench")


def test_benchmark_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    names += [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for c in b["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k)
                                             for k in c["reduced"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m.get("workloads", [])) <= set(workloads())


@pytest.mark.parametrize("workload", workloads())
def test_cell_files_parse(workload):
    b = bench()
    w = next(w for w in b["workloads"] if w["name"] == workload)
    for path in (("configs", w["config"] + ".json"),
                 ("configs", w["config"] + ".planar.json"),
                 ("traffic", w["traffic"] + ".json"),
                 ("limits", workload + ".json")):
        with open(os.path.join(PB, *path)) as f:
            json.load(f)
    from portbench.reference.check import COMPARED
    with open(os.path.join(PB, "limits", workload + ".json")) as f:
        limits = json.load(f)["limits"]
    assert set(limits) == set(COMPARED)
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(PB, "metrics",
                                           m["name"] + ".py"))


def test_frozen_kernel_counts():
    """16 546 operations per environment and control step for the Swimmer
    under K1, 691 934 for Hopper-v3 under K2, from the frozen copy."""
    from portbench import counts
    from portbench.counts import load_config
    _, swimmer = load_config("swimmer_npg")
    _, hopper = load_config("hopper_npg")
    assert counts.count_kernel_ops(swimmer, 5) == 16546
    assert counts.count_contact_ops(hopper, 4) == 691934


@pytest.mark.parametrize("config", sorted({w["config"]
                                           for w in bench()["workloads"]}))
def test_config_counts_are_frozen(config):
    from portbench.counts import iteration_counts, load_config
    cfg, p = load_config(config)
    assert cfg["counts"] == iteration_counts(cfg, p)


@pytest.mark.parametrize("workload", workloads())
def test_cell_flops_and_bytes(workload):
    """The counted work of one iteration of each cell, from its shapes: the
    samples from the traffic's rows over its ranks and the horizon, the
    kernel's bytes from the frozen model's sizes."""
    from portbench import run
    from portbench.counts import load_config, mlp_flops, policy_passes
    cell = run.Cell(os.path.join(ROOT, "BENCHMARK.json"), workload)
    cfg, p = load_config(cell.config_name)
    c = cfg["counts"]
    samples = cell.rows // cell.traffic.get("ranks", 1) * cell.horizon
    assert samples > 0
    assert c["flops_per_sample"] == (c["physics_ops_per_sample"]
                                     + c["policy_flops_per_sample"]
                                     + c["baseline_flops_per_sample"])
    sizes = [cfg["obs_dim"]] + list(cfg["policy_size"]) + [cfg["act_dim"]]
    assert c["policy_flops_per_sample"] == mlp_flops(sizes) * policy_passes(
        cfg["FIM_invert_args"]["iters"])
    # qpos, qvel and ctrl read, q and v written, float32
    assert c["kernel_bytes_per_env"] == 4 * (4 * p.nv + cfg["act_dim"])
    assert len(p.actuators) == cfg["act_dim"]
