"""The import guard: neither the harness nor the reference loads JAX or
the JAX package, and the reference loads nothing of the program.  Module
names are compared by their top-level name, whole: ``mjrl_tpu_torch``
begins with ``mjrl_tpu``."""

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "mjrl_tpu"}


def top_level(code):
    out = subprocess.run([sys.executable, "-c", code + """
import json, sys
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))"""],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600, check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_reference_imports_neither_jax_nor_the_program():
    names = top_level("""
from portbench.reference import check, npg
from portbench import counts, trace
for name in counts.config_names():     # each with its engine's module
    cfg, _, _ = counts.load_config(name)
    check.load_env(cfg["reference_env"])
""")
    assert not names & FORBIDDEN
    assert "mjrl_tpu_torch" not in names


def test_harness_run_imports_no_jax():
    names = top_level("""
from portbench import run
run.main(["--workload", "swimmer_npg.b32k", "--seed", "2", "--seconds",
          "0.01"], device="cpu",
         overrides={"rows": 4, "horizon": 4, "check_rows": 2})
""")
    assert not names & FORBIDDEN
    assert "mjrl_tpu_torch" in names


def test_guard_compares_whole_names():
    from portbench import run
    assert set(run.FORBIDDEN) == FORBIDDEN
    found = {n.split(".")[0] for n in ("mjrl_tpu_torch.algos",
                                       "jaxtyping")} & FORBIDDEN
    assert not found
