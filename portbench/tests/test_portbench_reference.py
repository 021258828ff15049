"""The reference against the program: the frozen plain step against the
port's at float64, and the reference's NPG iteration against the port's
agent run in float64, where the two may differ only by rounding (and by
the port's input transform, x / (1 + 1e-8), which float32 rounds away).
These tests may import the port; the reference itself may not."""

import json
import os

import pytest
import torch

from conftest import ROOT, TOY, bench, workloads

CONFIGS = sorted({w["config"] for w in bench()["workloads"]})


@pytest.mark.parametrize("config", CONFIGS)
def test_frozen_plain_step_matches_port(config):
    from mjrl_tpu_torch.envs import make
    from mjrl_tpu_torch.physics.planar import step_n_arrays
    from portbench.counts import load_config
    from portbench.reference import planar_plain
    cfg, p = load_config(config)
    env = make(cfg["env"], device="cpu", dtype=torch.float64)
    assert p == env._planar
    g = torch.Generator().manual_seed(1)
    s = env.reset(6, g)
    qpos = s.physics.qpos + 0.05 * torch.randn(s.physics.qpos.shape,
                                               generator=g,
                                               dtype=torch.float64)
    qvel = torch.randn(s.physics.qvel.shape, generator=g,
                       dtype=torch.float64)
    act = 2.2 * torch.rand((6, env.action_dim), generator=g,
                           dtype=torch.float64) - 1.1
    q1, v1 = planar_plain.step_n_arrays(p, qpos, qvel, act,
                                        cfg["frame_skip"])
    q2, v2 = step_n_arrays(env._planar, qpos, qvel, act, cfg["frame_skip"])
    assert torch.equal(q1, q2) and torch.equal(v1, v2)


@pytest.mark.parametrize("workload", workloads())
def test_reference_follows_program_in_float64(workload):
    from portbench import run
    from portbench.counts import load_config
    from portbench.reference import check
    cell = run.Cell(os.path.join(ROOT, "BENCHMARK.json"), workload)
    cell.traffic.update(TOY, dtype="float64")
    cell.rows, cell.horizon = TOY["rows"], TOY["horizon"]
    agent = run.build_agent(cell, 11, "cpu")
    prog = run.checked_iterations(agent, cell)
    _, p = load_config(cell.config_name)
    numbers, _, checked = check.program_numbers(prog, cell.cfg, p, "cpu",
                                                11)
    assert checked > 0 and numbers["phys_miss"] == 0
    assert numbers["phys_gap"] < 1e-10
    assert numbers["policy_gap"] < 1e-7
    for name in ("grad_gap", "step_gap", "step_median_gap", "change_gap",
                 "surr_gap", "vf_gap"):
        assert numbers[name] < 1e-5, (name, numbers[name])


@pytest.mark.parametrize("workload", workloads())
def test_toy_run_of_each_cell(toy_run, workload):
    """The traffic builder, the window and the check at a toy size: the
    result line carries every end-to-end metric and every number compared
    beside its limit, the checks last."""
    rc, res = toy_run(workload)
    assert rc == 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    names = {m["name"] for m in bench()["end_to_end"]}
    assert set(res["metrics"]) == names
    assert res["attempted"] >= 1 and res["failed"] == 0
    # every number has its limit, or null where the cell compares it not
    with open(os.path.join(ROOT, "portbench", "limits",
                           workload + ".json")) as f:
        limits = json.load(f)["limits"]
    assert {k: c["limit"] for k, c in res["checks"].items()} == limits


def test_toy_traced_run(toy_run):
    """--trace 1 reports per-layer metrics (the CPU has no device events:
    no roofline is reported, the card's idle share reads 100 %)."""
    wl = workloads()[0]
    rc, res = toy_run(wl, trace=1)
    assert rc == 0 and "breakdown" in res
    assert {"rollout_steps_per_s", "update_s", "vf_fit_s",
            "mfu"} <= set(res["metrics"])
    assert not any(k.endswith("_roofline") for k in res["metrics"])
    assert res["device"]["window_s"] > 0


def test_no_card_no_result(capsys):
    """The measurement path without a card fails and prints no result."""
    from portbench import run
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", workloads()[0], "--seed", "1", "--seconds",
                  "1", "--bench", os.path.join(ROOT, "BENCHMARK.json")])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


@pytest.mark.gpu
@pytest.mark.parametrize("workload", workloads())
def test_cell_on_card(card, workload):
    """A short run of each cell's path on the card(s) at a toy size."""
    from portbench import run
    cell = run.Cell(os.path.join(ROOT, "BENCHMARK.json"), workload)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"needs {cell.chips} cards")
    res = run.main(["--workload", workload, "--seed", "5", "--seconds",
                    "1", "--bench", os.path.join(ROOT, "BENCHMARK.json")],
                   device="cuda", overrides={**TOY, "rows": 256})
    assert res == 0
