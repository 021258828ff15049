"""The check catches what it must: each fault a training cell can have,
planted in the program underneath a whole toy-size run (the harness's look
for a card skipped, the program in float64 so that its sound numbers sit at
rounding), comes out not correct, on a number that the sound run keeps
within its limit; and the control, the reference at TF32, fails a limit
too."""

import pytest
import torch

from conftest import TOY, workloads


def run_numbers(toy_run, workload, **kw):
    rc, res = toy_run(workload, dtype="float64", **kw)
    assert rc == 0
    return res["correct"], {k: (c["value"], c["limit"])
                            for k, c in res["checks"].items()}


def over(numbers, names):
    """The numbers of ``names`` over their limits (a number whose limit is
    null is not compared in the cell)."""
    return [n for n in names
            if numbers[n][1] is not None and numbers[n][0] > numbers[n][1]]


UPDATE = ("grad_gap", "step_gap", "step_median_gap", "change_gap",
          "surr_gap", "vf_gap")


@pytest.fixture(params=workloads())
def sound(request, toy_run):
    _, numbers = run_numbers(toy_run, request.param)
    return request.param, numbers


def test_sound_float64_run_within_update_and_physics_limits(sound):
    _, numbers = sound
    assert not over(numbers, UPDATE + ("phys_gap", "phys_miss",
                                       "policy_gap"))


def test_step_that_returns_the_state_unchanged(sound, toy_run, monkeypatch):
    from mjrl_tpu_torch.algos import NPG
    original = NPG._update_core

    def unchanged(self, params, *args, **kwargs):
        _, stats = original(self, params, *args, **kwargs)
        return {k: v.clone() for k, v in params.items()}, stats
    monkeypatch.setattr(NPG, "_update_core", unchanged)
    correct, numbers = run_numbers(toy_run, sound[0])
    assert not correct and "change_gap" in over(numbers, UPDATE)


def test_half_of_the_batch_left_out(sound, toy_run, monkeypatch):
    from mjrl_tpu_torch.algos import NPG
    original = NPG._update_core

    def half(self, params, transforms, obs, act, adv, mask, *args, **kw):
        n = obs.shape[0] // 2
        return original(self, params, transforms, obs[:n], act[:n], adv[:n],
                        mask[:n], *args, **kw)
    monkeypatch.setattr(NPG, "_update_core", half)
    correct, numbers = run_numbers(toy_run, sound[0])
    assert not correct and over(numbers, UPDATE)


def test_answer_altered_where_produced(sound, toy_run, monkeypatch):
    """The physics step's next state with the last joint's velocity off by
    0.01."""
    from mjrl_tpu_torch.envs import base
    original = base.cuda_step_n_batched

    def altered(*args, **kwargs):
        q, v = original(*args, **kwargs)
        v = v.clone()
        v[:, -1] += 0.01
        return q, v
    monkeypatch.setattr(base, "cuda_step_n_batched", altered)
    correct, numbers = run_numbers(toy_run, sound[0])
    assert not correct and over(numbers, ("phys_gap", "phys_miss"))


@pytest.mark.parametrize("workload", workloads())
def test_control_fails_a_limit(workload):
    """The reference at TF32 in the program's place, on the program's
    float32 batches at a toy size, fails at least one number's limit."""
    import json
    import os
    from conftest import ROOT
    from portbench import calibrate, run
    cell = run.Cell(os.path.join(ROOT, "BENCHMARK.json"), workload)
    cell.traffic.update(TOY)
    cell.rows, cell.horizon = TOY["rows"], TOY["horizon"]
    out = calibrate.readings(cell, 5, "cpu", True)
    with open(os.path.join(ROOT, "portbench", "limits",
                           workload + ".json")) as f:
        limits = json.load(f)["limits"]
    assert [k for k, v in out["control"].items()
            if limits.get(k) is not None and v > limits[k]]
    assert torch.backends.cuda.matmul.allow_tf32 is False
