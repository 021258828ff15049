"""A configuration on a physics engine the harness has not seen is new
files only: on a copy of the benchmark, a configuration whose engine is a
module of its own (the planar engine's functions under another name), its
frozen model, a toy traffic mix, a cell and the cell's limits are added,
and ``portbench.run`` takes the cell on the CPU without a change to any
file the copy had.  The run reads ``correct``, with the numbers of the
planar configuration it mirrors at the same seed."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT, TOY

MIRRORED = "swimmer_npg"          # the cheapest configuration on the CPU
ENGINE = "mirror"
ENGINE_MODULE = '''"""The planar engine under another name."""
from portbench.reference.planar_plain import *  # noqa: F401,F403
'''


def digests(root):
    out = {}
    for d, dirs, files in os.walk(root):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def values(res):
    return {k: c["value"] for k, c in res["checks"].items()}


def run_cell(root, workload):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), ROOT]))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", "2147484001", "--seconds", "0.01", "--device", "cpu",
         "--overrides", json.dumps({**TOY, "dtype": "float64"})],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_engine_is_new_files_only(tmp_path):
    pb = tmp_path / "portbench"
    shutil.copytree(os.path.join(ROOT, "portbench"), pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH, tmp_path / "BENCHMARK.json")
    before = digests(pb)
    with open(BENCH) as f:
        bench = json.load(f)
    mirrored = next(w for w in bench["workloads"]
                    if w["config"] == MIRRORED and w["chips"] == 1)

    # the new files: the engine, the configuration and its frozen model,
    # the traffic mix, the cell's limits
    name, cell = f"{MIRRORED}_{ENGINE}", f"{MIRRORED}_{ENGINE}.toy"
    (pb / "reference" / f"{ENGINE}_plain.py").write_text(ENGINE_MODULE)
    with open(pb / "configs" / f"{MIRRORED}.json") as f:
        cfg = json.load(f)
    engine = cfg["engine"]
    (pb / "configs" / f"{name}.json").write_text(
        json.dumps(dict(cfg, engine=ENGINE), indent=1))
    shutil.copy(pb / "configs" / f"{MIRRORED}.{engine}.json",
                pb / "configs" / f"{name}.{ENGINE}.json")
    (pb / "traffic" / "toy.json").write_text(json.dumps(
        {"why": "a toy size on the CPU", "checked_iterations": 3, **TOY}))
    # the mirrored cell's limits, but for the taken noise's moments: the
    # toy's 320 draws cannot resolve them to 3e-3
    with open(pb / "limits" / f"{mirrored['name']}.json") as f:
        limits = json.load(f)
    limits["limits"]["action_z"] = None
    (pb / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    # BENCHMARK.json gains entries, and loses or changes none
    conf = next(c for c in bench["configs"] if c["name"] == MIRRORED)
    grown = dict(bench, configs=bench["configs"] + [
        dict(conf, name=name, file=f"portbench/configs/{name}.json")],
        workloads=bench["workloads"] + [
        dict(mirrored, name=cell, config=name, traffic="toy")])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(grown, indent=1))

    new, old = run_cell(tmp_path, cell), run_cell(tmp_path,
                                                  mirrored["name"])
    assert new["correct"] and new["transitions_checked"] > 0
    assert values(new) == values(old)
    after = digests(pb)
    assert {k: after[k] for k in before} == before
