"""The CUDA kernels' per-environment bodies, compiled for the host.

``csrc/planar_body.cuh`` (smooth chains) and ``csrc/planar_contact.cuh``
(contacts / RK4) are the arithmetic of the planar whole-control-step
kernels as ``__host__ __device__`` templates.  Here they are compiled with
g++ behind ``csrc/planar_host.cpp`` and held to the plain PyTorch version
``physics.planar.step_n_arrays``.

Smooth kernel, on random, limit-active and golden swimmer states, at every
lane-group size it is built for (L = 1 through ``csrc/planar_host.cpp``;
L = 2, 4, 8 with the lanes of a group run as fibers and the group sums done
as the warp's xor butterfly, ``csrc/planar_host_lanes.cpp``, where the lanes
of a group must end with the same bits): float64 at rtol = atol = 1e-10
(the same operations, except that each reciprocal is taken once, products
with exact zeros are skipped and at L > 1 the bodies' forces are summed per
lane and then over the group; the compiler may contract a*b+c), float32 at
2e-5 (positions) and 2e-4 (velocities) — the bounds the JAX package holds
its own kernel to, which leave room for last-digit differences amplified by
the Cholesky factorization and 12 Gauss-Seidel sweeps.

Contact kernel, on resting, penetrating and limit-violating states of
Hopper, Walker2d and HalfCheetah and on the captured half-cheetah explosion
states: float64 at 1e-9 (sums over rows run left to right where the plain
version calls ``torch.sum``, the kernel multiplies by a correctly rounded
reciprocal where the plain version divides repeatedly by the same value, and
up to 20 chained dual solves of 15-50 projected sweeps carry both along),
float32 at 3e-4 (positions) and 3e-3
(velocities, relative to the state set's largest velocity) — the bounds of
the JAX package's own float32 check of this branch; a flipped restart test
of the accelerated descent is a legitimate difference in float32.

The contact body is written for a group of L lanes per environment; g++
builds it at L = 1 (``csrc/planar_host.cpp``) and, with the lanes of a group
run as fibers and the group sums done as the warp's xor butterfly, at
L = 8, 16 and 32 (``csrc/planar_host_lanes.cpp``): the same bounds hold at
every L, and the lanes of a group must end with the same bits.  The
ownership of rows by lanes (``cuda_planar.lane_layout``) is checked as a
table.

States lie off the limit and contact boundaries, where the two could
legitimately take different branches.

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


# ---- contact models (hopper / walker2d / half-cheetah) ----------------------

MJCF = os.path.join(REPO, "mjrl_tpu_torch", "envs", "mjcf")
CONTACT_MODELS = {"hopper": ("hopper.xml", 4),
                  "walker2d": ("walker2d.xml", 4),
                  "half_cheetah": ("half_cheetah.xml", 5)}   # file, frame_skip


def contact_params(name, cone=None):
    """The port's PlanarParams (float64 model) of a contact model."""
    from mjrl_tpu_torch.physics.mjcf import load_mjcf
    from mjrl_tpu_torch.physics.model import ELLIPTIC
    mb = load_mjcf(os.path.join(MJCF, CONTACT_MODELS[name][0]))
    if cone == "elliptic":
        mb.opt["cone"] = ELLIPTIC
    model = mb.finalize(solver="newton")
    return tplanar.extract_planar(model), model.qpos0


def contact_states(p, qpos0, kind, B=4, seed=0):
    """numpy-seeded (q, v, u) for a contact model.  ``resting``: near the
    standing pose; ``penetrating``: dropped 0.4 into the floor with the
    joints scattered; ``limits``: every limited joint 0.05..0.3 rad past a
    stop and moving into it, at high velocity.  All lie off the
    contact / limit boundaries, where two implementations could
    legitimately take different branches; poses in which two capsule axes
    come within 1 cm of crossing are left out, because there the contact
    normal (c2 - c1) / |c2 - c1| is 0 / 0 and rounding alone turns it."""
    q, v, u = _contact_candidates(p, qpos0, kind, 4 * B, seed)
    keep = np.flatnonzero(tplanar.capsule_axis_distance(
        p, torch.tensor(q)).numpy() > 0.01)[:B]
    assert len(keep) == B
    return q[keep], v[keep], u[keep]


def _contact_candidates(p, qpos0, kind, B, seed):
    rng = np.random.RandomState(seed)
    nv, nu = p.nv, len(p.actuators)
    q = np.tile(np.asarray(qpos0, np.float64), (B, 1))
    u = rng.uniform(-1.0, 1.0, (B, nu))
    if kind == "resting":
        q += rng.uniform(-0.02, 0.02, (B, nv))
        v = rng.uniform(-0.1, 0.1, (B, nv))
    elif kind == "penetrating":
        q += rng.uniform(-0.15, 0.15, (B, nv))
        q[:, 1] -= 0.4
        v = rng.uniform(-1.0, 1.0, (B, nv))
    elif kind == "limits":
        q += rng.uniform(-0.05, 0.05, (B, nv))
        v = rng.uniform(-5.0, 5.0, (B, nv))
        for d in range(nv):
            if p.limited[d]:
                side = rng.choice([-1.0, 1.0], B)
                over = rng.uniform(0.05, 0.3, B)
                q[:, d] = np.where(side > 0, p.hi[d] + over, p.lo[d] - over)
                v[:, d] = side * np.abs(v[:, d])
    else:
        raise KeyError(kind)
    return q, v, u


def cheetah_explosion_states():
    """The captured high-velocity half-cheetah states (float32 values)."""
    d = np.load(os.path.join(GOLDEN, "cheetah_explosion_states.npz"))
    ts = sorted(int(k[2:]) for k in d.files if k.startswith("t_"))
    one = np.load(os.path.join(GOLDEN, "cheetah_explosion_state.npz"))
    q = [d[f"qpos_{t}"] for t in ts] + [one["qpos"]]
    v = [d[f"qvel_{t}"] for t in ts] + [one["qvel"]]
    u = [d[f"action_{t}"] for t in ts] + [one["action"]]
    return tuple(np.asarray(a, np.float64) for a in (q, v, u))


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


@pytest.mark.parametrize("lanes", cuda_planar.SMOOTH_LANES)
@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("name", list(STATES))
def test_host_body_matches_plain_version(params, host_lib, name, dtype, n,
                                         lanes):
    """At L > 1, host_step_n_batched also raises unless every lane of a
    group ends with the same bits."""
    q, v, u = (np.ascontiguousarray(a, dtype) for a in STATES[name]())
    gq, gv = cuda_planar.host_step_n_batched(params, q, v, u, n, lanes=lanes)
    rq, rv = tplanar.step_n_arrays(params, torch.tensor(q), torch.tensor(v),
                                   torch.tensor(u), n)
    assert gq.dtype == dtype and gq.shape == q.shape
    tol_q, tol_v = TOLS[dtype]
    np.testing.assert_allclose(gq, rq.numpy(), rtol=tol_q, atol=tol_q)
    np.testing.assert_allclose(gv, rv.numpy(), rtol=tol_v, atol=tol_v)


CONTACT_TOLS = {np.float64: (1e-9, 1e-9), np.float32: (3e-4, 3e-3)}
CONTACT_CASES = [("hopper", None), ("walker2d", None), ("half_cheetah", None),
                 ("hopper", "elliptic")]


@pytest.fixture(scope="module")
def contact_model():
    """name, cone -> (PlanarParams, qpos0, frame_skip), host body built."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    cache = {}

    def get(name, cone):
        if (name, cone) not in cache:
            p, qpos0 = contact_params(name, cone)
            cuda_planar.load_host_body(p)
            cache[name, cone] = (p, qpos0, CONTACT_MODELS[name][1])
        return cache[name, cone]
    return get


def _check_contact_body(p, q, v, u, n, dtype):
    q, v, u = (np.ascontiguousarray(a, dtype) for a in (q, v, u))
    gq, gv = cuda_planar.host_step_n_batched(p, q, v, u, n)
    rq, rv = tplanar.step_n_arrays(p, torch.tensor(q), torch.tensor(v),
                                   torch.tensor(u), n)
    rq, rv = rq.numpy(), rv.numpy()
    assert gq.dtype == dtype and gq.shape == q.shape
    ok = (np.abs(rv) < 1e10).all(-1)       # rows the env would not rescue
    assert list((np.abs(gv) < 1e10).all(-1)) == list(ok)
    tol_q, tol_v = CONTACT_TOLS[dtype]
    np.testing.assert_allclose(gq[ok], rq[ok], rtol=tol_q, atol=tol_q)
    np.testing.assert_allclose(
        gv[ok], rv[ok], rtol=tol_v,
        atol=tol_v * max(1.0, np.abs(rv[ok]).max()))
    return ok


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("kind", ["resting", "penetrating", "limits"])
@pytest.mark.parametrize("name,cone", CONTACT_CASES,
                         ids=["hopper", "walker2d", "half_cheetah",
                              "hopper_elliptic"])
def test_contact_host_body_matches_plain_version(contact_model, name, cone,
                                                 kind, dtype):
    p, qpos0, n = contact_model(name, cone)
    q, v, u = contact_states(p, qpos0, kind, B=6, seed=11)
    assert _check_contact_body(p, q, v, u, n, dtype).all()


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
def test_contact_host_body_on_the_cheetah_explosion_states(contact_model,
                                                           dtype):
    """The captured high-velocity states; the last one has exploded already
    and leaves the finite range in both."""
    p, _, n = contact_model("half_cheetah", None)
    q, v, u = cheetah_explosion_states()
    ok = _check_contact_body(p, q, v, u, n, dtype)
    assert list(ok) == [True, True, True, False, True]


# ---- lane groups: row ownership and the body at L > 1 ------------------------

OWNERSHIP_CASES = [(m, c) for m in CONTACT_MODELS for c in (None, "elliptic")]


@pytest.mark.parametrize("lanes", cuda_planar.LANES)
@pytest.mark.parametrize("name,cone", OWNERSHIP_CASES,
                         ids=[f"{m}_{c or 'pyramidal'}"
                              for m, c in OWNERSHIP_CASES])
def test_lane_ownership_table(name, cone, lanes):
    """Every row has exactly one (lane, slot); each elliptic triple sits on
    one lane in slots 3j, 3j+1, 3j+2 of one of the triple groups; no lane
    holds more than ceil(C / L) + 2 slots; pyramidal rows go round robin;
    and the generated header carries the same tables."""
    p, _ = contact_params(name, cone)
    lane, slot, nslots, ngroups = cuda_planar.lane_layout(p, lanes)
    C = tplanar.n_planar_rows(p)
    assert len(lane) == len(slot) == C
    assert all(0 <= l < lanes for l in lane)
    assert len(set(zip(lane, slot))) == C                # one row per slot
    assert nslots == max(slot) + 1 <= -(-C // lanes) + 2
    _, _, tri_mu, soc = cuda_planar._row_layout(p)
    K = len(tri_mu)
    assert ngroups == -(-K // lanes)
    assert (K > 0) == (cone == "elliptic")
    tri_rows = set()
    for k in range(K):
        rows = [soc + k, soc + K + k, soc + 2 * K + k]
        tri_rows.update(rows)
        assert len({lane[r] for r in rows}) == 1
        j = slot[rows[0]] // 3
        assert [slot[r] for r in rows] == [3 * j, 3 * j + 1, 3 * j + 2]
        assert j < ngroups
    for r in range(C):
        if r in tri_rows:
            continue
        # a row outside the triples never shares a slot group with a
        # triple on its own lane
        assert not any(lane[t] == lane[r] and slot[t] // 3 == slot[r] // 3
                       for t in tri_rows)
        if K == 0:
            assert (lane[r], slot[r]) == (r % lanes, r // lanes)
    header = cuda_planar.emit_model_header(p)
    li = cuda_planar.LANES.index(lanes)

    def table(fname):
        m = re.search(fname + r"\(int i0, int i1\) \{\n\s*constexpr int t\[\] "
                      r"= \{([^}]*)\}", header)
        vals = [int(x) for x in m.group(1).split(",")]
        return vals[li * C:(li + 1) * C]
    assert table("own_lane") == lane and table("own_slot") == slot


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("lanes", [L for L in cuda_planar.LANES if L > 1])
@pytest.mark.parametrize("name,cone", CONTACT_CASES,
                         ids=["hopper", "walker2d", "half_cheetah",
                              "hopper_elliptic"])
def test_contact_host_body_on_lane_groups_matches_plain_version(
        contact_model, name, cone, lanes, dtype):
    """The contact body at L lanes per environment, the lanes run as
    fibers and the group sums done as the warp's xor butterfly: the same
    bounds as at L = 1, and every lane of a group ends with the same bits
    (host_step_n_batched raises otherwise)."""
    p, qpos0, n = contact_model(name, cone)
    parts = [contact_states(p, qpos0, k, B=1, seed=30 + i)
             for i, k in enumerate(("resting", "penetrating", "limits"))]
    q, v, u = (np.ascontiguousarray(np.concatenate([x[i] for x in parts]),
                                    dtype) for i in range(3))
    gq, gv = cuda_planar.host_step_n_batched(p, q, v, u, n, lanes=lanes)
    rq, rv = tplanar.step_n_arrays(p, torch.tensor(q), torch.tensor(v),
                                   torch.tensor(u), n)
    tol_q, tol_v = CONTACT_TOLS[dtype]
    np.testing.assert_allclose(gq, rq.numpy(), rtol=tol_q, atol=tol_q)
    np.testing.assert_allclose(gv, rv.numpy(), rtol=tol_v,
                               atol=tol_v * max(1.0, np.abs(rv.numpy()).max()))


def test_contact_host_body_zero_substeps_is_identity(contact_model):
    p, qpos0, _ = contact_model("hopper", None)
    q, v, u = contact_states(p, qpos0, "resting", B=3)
    gq, gv = cuda_planar.host_step_n_batched(p, q, v, u, 0)
    assert np.array_equal(gq, q) and np.array_equal(gv, v)


def test_host_body_zero_substeps_is_identity(params, host_lib):
    q, v, u = (np.ascontiguousarray(a) for a in STATES["random"]())
    gq, gv = cuda_planar.host_step_n_batched(params, q, v, u, 0)
    assert np.array_equal(gq, q) and np.array_equal(gv, v)


@pytest.mark.parametrize("lanes", cuda_planar.SMOOTH_LANES)
def test_host_body_carries_nan_like_the_plain_version(params, host_lib,
                                                      lanes):
    """A non-finite state comes out non-finite from both, so the env's
    divergence rescue sees the same rows."""
    q, v, u = (np.ascontiguousarray(a[:4]) for a in STATES["random"]())
    v[1, 3] = np.nan
    q[2, 4] = np.inf
    gq, gv = cuda_planar.host_step_n_batched(params, q, v, u, 5,
                                             lanes=lanes)
    rq, rv = tplanar.step_n_arrays(params, torch.tensor(q), torch.tensor(v),
                                   torch.tensor(u), 5)
    bad = ~(np.isfinite(gq).all(-1) & np.isfinite(gv).all(-1))
    ref_bad = ~(torch.isfinite(rq).all(-1)
                & torch.isfinite(rv).all(-1)).numpy()
    assert list(bad) == list(ref_bad) == [False, True, True, False]


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", cuda_planar.SMOOTH_LANES)
@pytest.mark.parametrize("B", [4096, 1000])
def test_cuda_kernel_matches_plain_version_on_the_card(params, B, lanes):
    """The kernel itself, on a GPU, at each lane-group size built, on the
    random and limit-active states: float64 at 1e-9, float32 at 2e-5 /
    2e-4, and one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    reps = -(-B // 120)
    q, v, u = (np.tile(np.concatenate([a, b]), (reps, 1))[:B]
               for a, b in zip(STATES["random"](),
                               STATES["limit_active"]()))
    for dtype, tq, tv in ((torch.float64, 1e-9, 1e-9),
                          (torch.float32, 2e-5, 2e-4)):
        a, b, c = (torch.tensor(x, dtype=dtype, device="cuda")
                   for x in (q, v, u))
        before = dict(cuda_planar.launch_counts)
        gq, gv = cuda_planar.cuda_step_n_batched(params, a, b, c, 5,
                                                 lanes=lanes)
        torch.cuda.synchronize()
        before["planar_step_smooth"] += 1
        assert cuda_planar.launch_counts == before
        rq, rv = tplanar.step_n_arrays(params, a, b, c, 5)
        torch.testing.assert_close(gq, rq, rtol=tq, atol=tq)
        torch.testing.assert_close(gv, rv, rtol=tv, atol=tv)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", cuda_planar.LANES)
@pytest.mark.parametrize("name,cone", CONTACT_CASES,
                         ids=["hopper", "walker2d", "half_cheetah",
                              "hopper_elliptic"])
def test_cuda_contact_kernel_matches_plain_version_on_the_card(name, cone,
                                                               lanes):
    """The contact kernel itself, on a GPU, at each lane-group size built:
    float64 at 1e-9, float32 at 3e-4 / 3e-3, one launch of that kernel
    counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    p, qpos0 = contact_params(name, cone)
    n = CONTACT_MODELS[name][1]
    parts = [contact_states(p, qpos0, k, B=100, seed=i)
             for i, k in enumerate(("resting", "penetrating", "limits"))]
    q, v, u = (np.concatenate([x[i] for x in parts]) for i in range(3))
    for dtype, (tq, tv) in ((torch.float64, CONTACT_TOLS[np.float64]),
                            (torch.float32, CONTACT_TOLS[np.float32])):
        a, b, c = (torch.tensor(x, dtype=dtype, device="cuda")
                   for x in (q, v, u))
        before = dict(cuda_planar.launch_counts)
        gq, gv = cuda_planar.cuda_step_n_batched(p, a, b, c, n,
                                                 lanes=lanes)
        torch.cuda.synchronize()
        before["planar_step_contact"] += 1
        assert cuda_planar.launch_counts == before
        rq, rv = tplanar.step_n_arrays(p, a, b, c, n)
        torch.testing.assert_close(gq, rq, rtol=tq, atol=tq)
        torch.testing.assert_close(gv, rv, rtol=tv,
                                   atol=tv * max(1.0, rv.abs().max().item()))


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|optax|gymnasium)\b"
    r"|from\s+(jax|flax|optax|gymnasium)\b"
    r"|import\s+mjrl_tpu(\s|\.|$)|from\s+mjrl_tpu(\s|\.))", re.M)


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, files in os.walk(os.path.join(REPO, "mjrl_tpu_torch")):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    out += [os.path.join(REPO, "examples", f)
            for f in sorted(os.listdir(os.path.join(REPO, "examples")))
            if f.startswith("torch_") and f.endswith(".py")]
    return out


def test_port_imports_nothing_of_jax_or_the_jax_package():
    """mjrl_tpu_torch, chip_smoke.py and the port's example import torch,
    numpy and the standard library: never jax, flax, optax, gymnasium or
    mjrl_tpu."""
    hits = []
    for path in _port_sources():
        with open(path) as f:
            src = f.read()
        for m in _FORBIDDEN.finditer(src):
            hits.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert not hits, hits
    names = {os.path.relpath(p, REPO) for p in _port_sources()}
    assert len(names) > 33
    assert {"mjrl_tpu_torch/physics/mjcf.py",
            "mjrl_tpu_torch/envs/gym_suite.py",
            "examples/torch_hopper_npg.py"} <= names


def test_forbidden_import_pattern_catches_what_it_should():
    for bad in ("import jax", "  from jax import numpy", "import optax",
                "from flax import struct", "import mjrl_tpu",
                "import gymnasium", "from gymnasium.envs import mujoco",
                "from mjrl_tpu.envs import x", "import mjrl_tpu.ops as o"):
        assert _FORBIDDEN.search(bad), bad
    for ok in ("import mjrl_tpu_torch", "from mjrl_tpu_torch.envs import x",
               "# import jax would be wrong here", "import torch"):
        assert not _FORBIDDEN.search(ok), ok
