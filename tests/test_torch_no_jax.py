"""The port stands apart: every module of ``mjrl_tpu_torch``,
``chip_smoke.py``, every ``examples/torch_*.py`` and every
``tools/torch_*.py`` imports in a process where ``jax``, the JAX package
and the optional drawing, video and environment packages cannot be
imported at all (``sys.modules[name] = None`` makes any import of them
raise)."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, importlib.util, os, pkgutil, sys
    for name in ("jax", "jaxlib", "flax", "optax", "mjrl_tpu",
                 "matplotlib", "PIL", "cv2", "gymnasium", "mujoco"):
        sys.modules[name] = None
    repo = sys.argv[1]
    sys.path.insert(0, repo)
    import mjrl_tpu_torch
    names = ["mjrl_tpu_torch"]
    for info in pkgutil.walk_packages(mjrl_tpu_torch.__path__,
                                      "mjrl_tpu_torch."):
        importlib.import_module(info.name)
        names.append(info.name)
    files = [os.path.join(repo, "chip_smoke.py")] + sorted(
        os.path.join(repo, d, f) for d in ("examples", "tools")
        for f in os.listdir(os.path.join(repo, d))
        if f.startswith("torch_") and f.endswith(".py"))
    sys.path.insert(0, os.path.join(repo, "tools"))
    for path in files:
        name = os.path.splitext(os.path.basename(path))[0]
        spec = importlib.util.spec_from_file_location(name, path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        names.append(name)
    leaked = [m for m in ("jax", "mjrl_tpu", "matplotlib", "gymnasium")
              if sys.modules.get(m) is not None]
    assert not leaked, leaked
    print(len(names), " ".join(names))
""")


def test_every_port_module_imports_without_jax_or_drawing_packages():
    proc = subprocess.run([sys.executable, "-c", SCRIPT, REPO],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    count, *names = proc.stdout.split()
    names = set(names)
    for new in ("mjrl_tpu_torch.parallel", "mjrl_tpu_torch.parallel.mesh",
                "mjrl_tpu_torch.parallel.distributed",
                "mjrl_tpu_torch.native", "mjrl_tpu_torch.envs.mjcf_env",
                "mjrl_tpu_torch.utils.checkpoint", "mjrl_tpu_torch.utils.sweep",
                "mjrl_tpu_torch.utils.render",
                "mjrl_tpu_torch.utils.visualize_policy",
                "mjrl_tpu_torch.utils.visualize_trajectories",
                "mjrl_tpu_torch.utils.plot_from_logs",
                "mjrl_tpu_torch.utils.tensor_utils",
                "mjrl_tpu_torch.utils.get_environment",
                "mjrl_tpu_torch.utils.profiling",
                "mjrl_tpu_torch.utils.optimize_model", "chip_smoke",
                "torch_visualizer_smoke", "torch_linear_nn_comparison",
                "torch_point_mass_smoke", "torch_train_gym",
                "torch_bench_hopper", "torch_hopper_transplant"):
        assert new in names, new
    assert int(count) == len(names) > 70
