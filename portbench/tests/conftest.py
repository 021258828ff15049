"""Helpers of the benchmark's CPU tests: toy-size runs of a cell through
the harness, the program on the CPU (its plain step in place of the
kernels)."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BENCH = os.path.join(ROOT, "BENCHMARK.json")
# a toy size of every cell: rows, the horizon cut, rows whose transitions
# are checked
TOY = {"rows": 8, "horizon": 10, "check_rows": 4}


def bench():
    with open(BENCH) as f:
        return json.load(f)


def workloads():
    return [w["name"] for w in bench()["workloads"]]


@pytest.fixture
def toy_run(capsys):
    """Runs a cell at the toy size on the CPU -> (exit code, the result
    line as a dict)."""
    from portbench import run

    def go(workload, trace=0, seed=3000000001, **overrides):
        capsys.readouterr()
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", "0.01", "--trace", str(trace),
                       "--bench", BENCH], device="cpu",
                      overrides={**TOY, **overrides})
        out = capsys.readouterr().out.strip().splitlines()
        return rc, json.loads(out[-1])
    return go


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
