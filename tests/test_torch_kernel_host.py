"""The CUDA kernel's per-environment body, compiled for the host.

``csrc/planar_body.cuh`` is the arithmetic of the planar whole-control-step
kernel as a ``__host__ __device__`` template.  Here it is compiled with g++
behind ``csrc/planar_host.cpp`` and held to the plain PyTorch version
``physics.planar.step_n_arrays`` on random, limit-active and golden states:
float64 at rtol = atol = 1e-10 (same operations in the same order; the
compiler may contract a*b+c), float32 at 2e-5 (positions) and 2e-4
(velocities) — the bounds the JAX package holds its own kernel to, which
leave room for last-digit differences amplified by the Cholesky
factorization and 12 Gauss-Seidel sweeps.  States lie off the limit
boundary, where the two could legitimately take different branches.

This checks the arithmetic where there is no GPU; the launch, the layout
and the device build are checked on the card by ``chip_smoke.py`` and by the
``gpu``-marked test below.  This file imports nothing of JAX, so that test
also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_kernel_host.py -m gpu
"""

import os
import re
import shutil

import numpy as np
import pytest
import torch

from mjrl_tpu_torch.envs.assets import swimmer_model
from mjrl_tpu_torch.ops import cuda_planar
from mjrl_tpu_torch.physics import planar as tplanar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
TOLS = {np.float64: (1e-10, 1e-10), np.float32: (2e-5, 2e-4)}


# ---- the state sets shared by the port's physics tests (numpy, seeded) ------

def random_states(B=60, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-0.5, 0.5, (B, 7)), rng.uniform(-1.0, 1.0, (B, 7)),
            rng.uniform(-1.0, 1.0, (B, 4)))


def limit_active_states(B=60, seed=1):
    """Hinges pushed 0.1..0.5 rad past the +-1.5 stops, moving into the
    stop; controls partly outside the +-1 control range (clipped inside)."""
    rng = np.random.RandomState(seed)
    q, v, _ = random_states(B, seed)
    u = rng.uniform(-1.5, 1.5, (B, 4))
    q[:, 3:] = rng.uniform(1.6, 2.0, (B, 4)) * rng.choice([-1, 1], (B, 4))
    v[:, 3:] = np.sign(q[:, 3:]) * np.abs(v[:, 3:])
    return q, v, u


def golden_physics_states():
    d = np.load(os.path.join(GOLDEN, "swimmer.npz"))
    return d["qpos"], d["qvel"], d["ctrl"]


def golden_env_states():
    d = np.load(os.path.join(GOLDEN, "env_swimmer.npz"))
    eps = range(int(d["n_eps"]))
    return (np.concatenate([d[f"ep{e}_qpos_before"] for e in eps]),
            np.concatenate([d[f"ep{e}_qvel_before"] for e in eps]),
            np.concatenate([d[f"ep{e}_actions"] for e in eps]))


STATES = {"random": random_states, "limit_active": limit_active_states,
          "golden_swimmer": golden_physics_states,
          "golden_env_swimmer": golden_env_states}


@pytest.fixture(scope="module")
def params():
    return tplanar.extract_planar(swimmer_model(solver="newton"))


@pytest.fixture(scope="module")
def host_lib(params):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    return cuda_planar.load_host_body(params)


@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("name", list(STATES))
def test_host_body_matches_plain_version(params, host_lib, name, dtype, n):
    q, v, u = (np.ascontiguousarray(a, dtype) for a in STATES[name]())
    gq, gv = cuda_planar.host_step_n_batched(params, q, v, u, n)
    rq, rv = tplanar.step_n_arrays(params, torch.tensor(q), torch.tensor(v),
                                   torch.tensor(u), n)
    assert gq.dtype == dtype and gq.shape == q.shape
    tol_q, tol_v = TOLS[dtype]
    np.testing.assert_allclose(gq, rq.numpy(), rtol=tol_q, atol=tol_q)
    np.testing.assert_allclose(gv, rv.numpy(), rtol=tol_v, atol=tol_v)


def test_host_body_zero_substeps_is_identity(params, host_lib):
    q, v, u = (np.ascontiguousarray(a) for a in STATES["random"]())
    gq, gv = cuda_planar.host_step_n_batched(params, q, v, u, 0)
    assert np.array_equal(gq, q) and np.array_equal(gv, v)


def test_host_body_carries_nan_like_the_plain_version(params, host_lib):
    """A non-finite state comes out non-finite from both, so the env's
    divergence rescue sees the same rows."""
    q, v, u = (np.ascontiguousarray(a[:4]) for a in STATES["random"]())
    v[1, 3] = np.nan
    q[2, 4] = np.inf
    gq, gv = cuda_planar.host_step_n_batched(params, q, v, u, 5)
    rq, rv = tplanar.step_n_arrays(params, torch.tensor(q), torch.tensor(v),
                                   torch.tensor(u), 5)
    bad = ~(np.isfinite(gq).all(-1) & np.isfinite(gv).all(-1))
    ref_bad = ~(torch.isfinite(rq).all(-1)
                & torch.isfinite(rv).all(-1)).numpy()
    assert list(bad) == list(ref_bad) == [False, True, True, False]


@pytest.mark.gpu
@pytest.mark.parametrize("B", [4096, 1000])
def test_cuda_kernel_matches_plain_version_on_the_card(params, B):
    """The kernel itself, on a GPU: float64 at 1e-9, float32 at 2e-5 /
    2e-4, and one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    reps = -(-B // 60)
    q, v, u = (np.tile(a, (reps, 1))[:B] for a in STATES["limit_active"]())
    for dtype, tq, tv in ((torch.float64, 1e-9, 1e-9),
                          (torch.float32, 2e-5, 2e-4)):
        a, b, c = (torch.tensor(x, dtype=dtype, device="cuda")
                   for x in (q, v, u))
        before = cuda_planar.launch_count
        gq, gv = cuda_planar.cuda_step_n_batched(params, a, b, c, 5)
        torch.cuda.synchronize()
        assert cuda_planar.launch_count == before + 1
        rq, rv = tplanar.step_n_arrays(params, a, b, c, 5)
        torch.testing.assert_close(gq, rq, rtol=tq, atol=tq)
        torch.testing.assert_close(gv, rv, rtol=tv, atol=tv)


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|optax)\b|from\s+(jax|flax|optax)\b"
    r"|import\s+mjrl_tpu(\s|\.|$)|from\s+mjrl_tpu(\s|\.))", re.M)


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(os.path.join(REPO, "mjrl_tpu_torch")):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    out += [os.path.join(REPO, "examples", "torch_swimmer_npg.py")]
    return out


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """mjrl_tpu_torch, chip_smoke.py and the port's example import torch,
    numpy and the standard library: never jax, flax, optax or mjrl_tpu."""
    hits = []
    for path in _port_sources():
        with open(path) as f:
            src = f.read()
        for m in _FORBIDDEN.finditer(src):
            hits.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert not hits, hits
    assert len(_port_sources()) > 30


def test_forbidden_import_pattern_catches_what_it_should():
    for bad in ("import jax", "  from jax import numpy", "import optax",
                "from flax import struct", "import mjrl_tpu",
                "from mjrl_tpu.envs import x", "import mjrl_tpu.ops as o"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import mjrl_tpu_torch", "from mjrl_tpu_torch.envs import x",
               "# import jax would be wrong here", "import torch"):
        assert not _FORBIDDEN.search(ok), ok
