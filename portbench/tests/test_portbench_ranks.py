"""A cell on four cards, rehearsed on the CPU: four gloo ranks started by
the harness from the one command, the batch split over them, and the
reference's sums reduced over them.  Each traffic mix of several ranks
runs on the first configuration, as a cell of a BENCHMARK.json of the
test's own.  The exchange between the ranks left out is planted in every
rank's process (a ``sitecustomize`` on the children's path) and must move
the first gradient far from the reference."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, bench

TRAFFIC = os.path.join(ROOT, "portbench", "traffic")
MIXES = sorted(f[:-5] for f in os.listdir(TRAFFIC) if f.endswith(".json")
               and json.load(open(os.path.join(TRAFFIC, f))).get("ranks", 1)
               > 1)
TOY4 = {"rows": 8, "horizon": 6, "check_rows": 2}


@pytest.fixture(params=MIXES)
def workload(request, tmp_path):
    """(the cell's name, its BENCHMARK.json)."""
    config = bench()["configs"][0]["name"]
    name = f"{config}.{request.param}"
    b = dict(bench(), workloads=[{"name": name, "config": config,
                                  "traffic": request.param, "chips": 4,
                                  "why": "four ranks on the CPU"}])
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(b))
    return name, str(path)


def run_ranks(workload, extra_env=None, **overrides):
    name, path = workload
    env = dict(os.environ, **(extra_env or {}))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", name,
         "--seed", "2147483999", "--seconds", "0.01", "--device", "cpu",
         "--bench", path, "--overrides", json.dumps({**TOY4, **overrides})],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_ranks_follow_the_reference_in_float64(workload):
    res = run_ranks(workload, dtype="float64")
    assert res["device"]["count"] == 4
    c = {k: v["value"] for k, v in res["checks"].items()}
    assert c["phys_miss"] == 0 and c["phys_gap"] < 1e-10
    assert c["grad_gap"] < 1e-7 and c["vf_gap"] < 1e-7
    # the step: ten CG iterations at damping 1e-4 on 48 samples amplify
    # the split sums' float64 roundoff (one process reads ~1e-7 here)
    assert c["change_gap"] < 1e-3 and c["surr_gap"] < 1e-3


def test_exchange_between_ranks_left_out(workload, tmp_path):
    (tmp_path / "sitecustomize.py").write_text(
        "from mjrl_tpu_torch.parallel import mesh\n"
        "mesh.Mesh.all_reduce_sum = lambda self, x: x\n")
    path = os.pathsep.join([str(tmp_path), ROOT])
    res = run_ranks(workload, {"PYTHONPATH": path}, dtype="float64")
    c = res["checks"]
    assert not res["correct"]
    assert c["grad_gap"]["value"] > 1e-3
