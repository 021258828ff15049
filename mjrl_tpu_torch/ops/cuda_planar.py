"""The planar whole-control-step kernels for NVIDIA Hopper, and their wrapper.

Counterpart of ``mjrl_tpu/ops/pallas_planar.py`` (``pallas_step_n_batched``
and both branches of its ``_kernel``).  The kernels are hand-written CUDA
C++, each a ``.cu`` file (launch, layout) around a header with the
per-environment arithmetic, a template on the scalar type and on a
model-traits struct:

- ``planar_step_smooth``: ``csrc/planar_step.cu`` around
  ``csrc/planar_body.cuh`` — smooth Euler chains (the swimmer);
- ``planar_step_contact``: ``csrc/planar_contact_step.cu`` around
  ``csrc/planar_contact.cuh`` — trees with ground contacts and/or RK4
  (hopper, walker2d, half-cheetah).

``emit_model_header`` writes the traits struct from a ``PlanarParams`` —
sizes, tree structure, contact tables, the ownership of constraint rows by
the lanes of a group (``lane_layout``) and every physical constant as
``constexpr`` — into the build directory, so the model's structure unrolls
at compile time, as the Pallas kernel bakes its constants at trace time.

Both kernels step each environment on a group of ``L`` lanes of a warp,
``L`` fixed per build: ``SMOOTH_LANES`` for the smooth kernel, ``LANES`` for
the contact kernel (``kernel_lanes``); ``default_lanes`` picks each model's
``L`` from measurements on an H100 (``PERF.md``).

Build: ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, loaded with ``ctypes``; at first use, from ``csrc/`` alone, into
``mjrl_tpu_torch/_build/<hash>/``, one library per model and ``L``.
Importing this module needs neither CUDA nor ``nvcc``; asking for a kernel
without them raises.

``cuda_step_n_batched`` is the one entry: for CUDA tensors it launches the
kernel the model needs (``needs_contact_path``) and raises if it cannot; for
CPU tensors, and only then, it runs the plain PyTorch version
``physics.planar.step_n_arrays``.  There is no gradient: the policy
gradient never differentiates through the physics.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time

import torch

from mjrl_tpu_torch.physics.model import ELLIPTIC as ELLIPTIC_CONE, EULER
from mjrl_tpu_torch.physics.planar import (PGS_SWEEPS, POWER_ITERS, SWEEPS,
                                           SWEEPS_WARM, PlanarParams,
                                           _planar_soc, _tree_tables,
                                           chain_mask, fluid_constants,
                                           n_planar_rows,
                                           needs_contact_path, step_n_arrays)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel name -> (.cu file, headers it includes, C entry prefix)
KERNELS = {
    "planar_step_smooth": ("planar_step.cu", ("planar_body.cuh",),
                           "planar_step"),
    "planar_step_contact": ("planar_contact_step.cu",
                            ("planar_body.cuh", "planar_contact.cuh"),
                            "planar_contact_step"),
}

# launches made by cuda_step_n_batched, per kernel (plain integers; callers
# that want a per-phase count set them to 0 first)
launch_counts = {name: 0 for name in KERNELS}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


# lane-group sizes the kernels are built for (each divides 32): the contact
# kernel's, and the smooth kernel's
LANES = (1, 8, 16, 32)
SMOOTH_LANES = (1, 2, 4, 8)

# the contact kernel's lanes per environment, by model (nv, constraint rows):
# the fastest of LANES on an H100 at 4096 environments, in float32 and in
# float64 (chip_smoke.py, PERF.md section 6)
CHOSEN_LANES = {
    (6, 38): 8,      # Hopper
    (9, 62): 8,      # Walker2d
    (9, 70): 8,      # HalfCheetah
}


# the smooth kernel's lanes per environment, by model (nv, bodies, limited
# dofs): the fastest of SMOOTH_LANES on an H100 at 4096 environments, in
# float32 and in float64 (chip_smoke.py, PERF.md section 6)
CHOSEN_SMOOTH_LANES = {
    (7, 5, 4): 1,    # Swimmer
}


def default_lanes(p: PlanarParams) -> int:
    """Lanes per environment of the kernel that steps ``p``: the measured
    choice for the swimmer and the gym models; for another model, the
    measured models' choice (smooth 1, contact 8)."""
    if kernel_name(p) == "planar_step_smooth":
        return CHOSEN_SMOOTH_LANES.get(
            (p.nv, p.nbody, sum(1 for x in p.limited if x)), 1)
    return CHOSEN_LANES.get((p.nv, n_planar_rows(p)), 8)


def kernel_lanes(p: PlanarParams):
    """The lane-group sizes the kernel that steps ``p`` is built for."""
    return SMOOTH_LANES if kernel_name(p) == "planar_step_smooth" else LANES


def kernel_name(p: PlanarParams) -> str:
    """The kernel that steps ``p``: the same test as the TPU kernel's
    branch (contacts or RK4 -> the contact kernel)."""
    return "planar_step_contact" if needs_contact_path(p) \
        else "planar_step_smooth"


def kernel_source(name: str) -> str:
    return "mjrl_tpu_torch/csrc/" + KERNELS[name][0]

_libs = {}          # (PlanarParams, lanes) -> (kernel functions, build info)
_host_libs = {}     # (PlanarParams, lanes) -> ctypes lib (g++ build)


# ---------------------------------------------------------------------------
# model-traits header
# ---------------------------------------------------------------------------

def _lit(x):
    """C++ double literal that round-trips the python float."""
    s = repr(float(x))
    if "inf" in s or "nan" in s:
        raise ValueError(f"non-finite model constant {x!r}")
    return s


def _accessor(name, ctype, values, dims):
    """constexpr accessor over a flattened table: name(i[, j[, k]])."""
    flat = list(values)
    lits = [(_lit(x) if ctype == "double" else str(int(x))) for x in flat] \
        or ["0"]
    args = ", ".join(f"int i{k}" for k in range(len(dims)))
    idx, stride = [], 1
    for k in reversed(range(len(dims))):
        idx.append(f"i{k} * {stride}" if stride != 1 else f"i{k}")
        stride *= dims[k]
    index = " + ".join(reversed(idx))
    return (f"  PLANAR_HD static constexpr {ctype} {name}({args}) {{\n"
            f"    constexpr {ctype} t[] = {{{', '.join(lits)}}};\n"
            f"    return t[{index}];\n  }}\n")


def _shared_contacts(p: PlanarParams):
    """Per-contact constants (k, b, solimp, mu, invweight, condim), points
    (plane-sphere, capsule end caps) first, then capsule-capsule pairs."""
    return ([c[5:11] for c in p.contacts_pt]
            + [c[8:14] for c in p.contacts_cc])


def _row_layout(p: PlanarParams):
    """The constraint rows in the plain version's order -> (first row of
    each contact or -1, elliptic triple of each contact or -1, friction of
    each triple, first row of the elliptic block).  Rows: limits, then per
    contact one normal row (condim 1) or 4 pyramidal facets inline;
    elliptic triples go to the block [n(K), t1(K), t2(K)] that starts at the
    last value."""
    elliptic = p.cone == ELLIPTIC_CONE
    con_row, con_tri, tri_mu = [], [], []
    r = sum(1 for x in p.limited if x)
    for (_kc, _bc, _si, mu, _iw, cd) in _shared_contacts(p):
        if cd == 1:
            con_row.append(r); con_tri.append(-1); r += 1
        elif elliptic:
            con_row.append(-1); con_tri.append(len(tri_mu))
            tri_mu.append(mu)
        else:
            con_row.append(r); con_tri.append(-1); r += 4
    soc_start, ntri = r, len(tri_mu)
    if soc_start + 3 * ntri != n_planar_rows(p):
        raise AssertionError("row layout disagrees with n_planar_rows")
    if ntri and _planar_soc(p) != (soc_start, ntri, tuple(tri_mu)):
        raise AssertionError("elliptic block disagrees with _planar_soc")
    return con_row, con_tri, tri_mu, soc_start


def lane_layout(p: PlanarParams, lanes: int):
    """Which lane of a group of ``lanes`` owns each constraint row, and in
    which of its slots -> (lane per row, slot per row, slots per lane,
    triple groups).

    Elliptic triple k (rows soc + k, soc + K + k, soc + 2K + k) goes whole
    to lane k % L, slots 3 (k // L) + 0, 1, 2: the cone projection and the
    shared tangent scale mix its rows.  Every other row, in order, goes to
    the lane that holds fewest rows so far (the lowest such lane) at its
    next free slot; without triples that is row r -> lane r % L, slot
    r // L.  A lane then holds at most max(3 ceil(K / L), ceil(C / L)) <=
    ceil(C / L) + 2 slots."""
    if lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES}, got {lanes}")
    _, _, tri_mu, soc = _row_layout(p)
    ntri = len(tri_mu)
    nrows = soc + 3 * ntri
    lane, slot = [0] * nrows, [0] * nrows
    load = [0] * lanes
    for k in range(ntri):
        owner, group = k % lanes, k // lanes
        for part in range(3):
            r = soc + part * ntri + k
            lane[r], slot[r] = owner, 3 * group + part
        load[owner] += 3
    for r in range(soc):
        owner = min(range(lanes), key=lambda i: (load[i], i))
        lane[r], slot[r] = owner, load[owner]
        load[owner] += 1
    return lane, slot, max(load), -(-ntri // lanes)


def emit_model_header(p: PlanarParams) -> str:
    """``struct PlanarModel`` for ``csrc/planar_body.cuh``: the sizes,
    the tree and every constant of ``p`` as constexpr tables.  Derived
    constants (fluid coefficients, clamped solimp mid, floored width) are
    computed here in double precision exactly as the plain version
    computes them in python floats."""
    nv, nb, nu = p.nv, p.nbody, len(p.actuators)
    par, hs, jp = _tree_tables(p)
    chain = chain_mask(p)
    lim = [d for d in range(nv) if p.limited[d]]
    has_fluid = bool(p.viscosity or p.density)
    fl = [fluid_constants(p, b) for b in range(nb)]
    stiffness = p.stiffness if p.stiffness else (0.0,) * nv
    spring_ref = p.spring_ref if p.spring_ref else (0.0,) * nv

    def solimp_row(si):
        d0, dw, width, mid, power = si
        return [d0, dw, max(width, 1e-12),
                min(max(mid, 1e-4), 1.0 - 1e-4), power]

    def solimp_inv(si):          # 1 / width, 1 / mid, 1 / (1 - mid)
        _, _, width, mid, _ = solimp_row(si)
        return [1.0 / width, 1.0 / mid, 1.0 / (1.0 - mid)]

    pts, ccs = p.contacts_pt, p.contacts_cc
    shared = _shared_contacts(p)
    con_row, con_tri, tri_mu, soc_start = _row_layout(p)
    ntri = len(tri_mu)
    nrows = soc_start + 3 * ntri
    layouts = [lane_layout(p, L) for L in LANES]

    pairs = [(d, e) for d in range(nv) for e in range(d, nv)]
    flat2 = lambda rows: [x for r in rows for x in r]
    out = ["// generated by mjrl_tpu_torch/ops/cuda_planar.py::"
           "emit_model_header — do not edit\n#pragma once\n"
           "#if defined(__CUDACC__)\n"
           "#define PLANAR_HD __host__ __device__ __forceinline__\n"
           "#else\n#define PLANAR_HD inline\n#endif\n\n"
           "struct PlanarModel {\n"
           f"  static constexpr int NV = {nv}, NB = {nb}, NU = {nu}, "
           f"NL = {len(lim)};\n"
           "  // the smallest limited dof (0 without limits)\n"
           f"  static constexpr int LIM_DOF_MIN = {min(lim, default=0)};\n"
           f"  static constexpr int PGS_SWEEPS = {PGS_SWEEPS};\n"
           f"  static constexpr int NPT = {len(pts)}, NCC = {len(ccs)}, "
           f"NROWS = {nrows}, NTRI = {ntri}, SOC_START = {soc_start};\n"
           f"  static constexpr int SWEEPS = {SWEEPS}, SWEEPS_WARM = "
           f"{SWEEPS_WARM}, POWER_ITERS = {POWER_ITERS};\n"
           "  static constexpr bool CONTACT_PATH = "
           f"{str(needs_contact_path(p)).lower()};\n"
           "  static constexpr bool RK4 = "
           f"{str(p.integrator != EULER).lower()};\n"
           f"  static constexpr double H = {_lit(p.timestep)};\n"
           f"  static constexpr bool HAS_FLUID = {str(has_fluid).lower()};\n"
           "  static constexpr bool HAS_GRAVITY = "
           f"{str(tuple(p.gravity2) != (0.0, 0.0)).lower()};\n"
           "  static constexpr bool HAS_SPRINGS = "
           f"{str(bool(any(stiffness))).lower()};\n"
           "  static constexpr bool HAS_DAMPING = "
           f"{str(bool(any(p.damping))).lower()};\n"
           "  // row ownership by the lanes of a group, per L in LANES\n"
           "  PLANAR_HD static constexpr int lanes_index(int L) {\n"
           "    return " + "".join(f"L == {L} ? {i} : "
                                    for i, L in enumerate(LANES))
           + "-1;\n  }\n"]
    A = _accessor
    out += [
        A("parent", "int", par, (nb,)),
        A("body_dof", "int", p.body_dof, (nb,)),
        A("chain", "int", flat2(chain), (nb, nv)),
        A("hinge_sign", "double", hs, (nb,)),
        A("offset", "double", flat2(p.offsets), (nb, 2)),
        A("jpos", "double", flat2(jp), (nb, 2)),
        A("com", "double", flat2(p.com), (nb, 2)),
        A("mass", "double", p.mass, (nb,)),
        A("izz", "double", p.izz, (nb,)),
        A("r0", "double", [x for r in p.r0 for row in r for x in row],
          (nb, 3, 3)),
        A("fluid_cv", "double", [f[0] for f in fl], (nb,)),
        A("fluid_cw", "double", [f[1] for f in fl], (nb,)),
        A("fluid_qf", "double", flat2([f[2] for f in fl]), (nb, 3)),
        A("fluid_qt", "double", flat2([f[3] for f in fl]), (nb, 3)),
        A("gravity", "double", p.gravity2, (2,)),
        A("slide_dir", "double", flat2(p.slide_dirs), (2, 2)),
        A("slide_ref", "double", p.slide_ref, (2,)),
        A("damping", "double", p.damping, (nv,)),
        A("armature", "double", p.armature, (nv,)),
        A("stiffness", "double", stiffness, (nv,)),
        A("spring_ref", "double", spring_ref, (nv,)),
        A("lim_dof", "int", lim, (len(lim),)),
        A("lim_lo", "double", [p.lo[d] for d in lim], (len(lim),)),
        A("lim_hi", "double", [p.hi[d] for d in lim], (len(lim),)),
        A("limit_k", "double", [p.limit_k[d] for d in lim], (len(lim),)),
        A("limit_b", "double", [p.limit_b[d] for d in lim], (len(lim),)),
        A("invweight0", "double", [p.invweight0[d] for d in lim],
          (len(lim),)),
        A("solimp", "double", flat2([solimp_row(p.solimp[d]) for d in lim]),
          (len(lim), 5)),
        A("solimp_inv", "double",
          flat2([solimp_inv(p.solimp[d]) for d in lim]), (len(lim), 3)),
        # the upper triangle of an nv x nv matrix, entry by entry, row-major
        A("pair_row", "int", [d for d, _ in pairs], (len(pairs),)),
        A("pair_col", "int", [e for _, e in pairs], (len(pairs),)),
        A("act_dof", "int", [a[0] for a in p.actuators], (nu,)),
        A("gear", "double", [a[1] for a in p.actuators], (nu,)),
        A("ctrl_lo", "double", [a[2] for a in p.actuators], (nu,)),
        A("ctrl_hi", "double", [a[3] for a in p.actuators], (nu,)),
        A("ctrl_limited", "int", [bool(a[4]) for a in p.actuators], (nu,)),
        # ---- contacts ----
        A("pt_body", "int", [c[0] for c in pts], (len(pts),)),
        A("pt_local", "double", flat2([c[1] for c in pts]), (len(pts), 2)),
        A("pt_radius", "double", [c[2] for c in pts], (len(pts),)),
        A("pt_up", "double", flat2([c[3] for c in pts]), (len(pts), 2)),
        A("pt_h0", "double", [c[4] for c in pts], (len(pts),)),
        A("cc_body", "int", flat2([(c[0], c[4]) for c in ccs]),
          (len(ccs), 2)),
        # endpoints: [pair][A0, A1, B0, B1][x, y]
        A("cc_end", "double",
          [x for c in ccs for pt in (c[1], c[2], c[5], c[6]) for x in pt],
          (len(ccs), 4, 2)),
        A("cc_radius", "double", flat2([(c[3], c[7]) for c in ccs]),
          (len(ccs), 2)),
        A("con_k", "double", [c[0] for c in shared], (len(shared),)),
        A("con_b", "double", [c[1] for c in shared], (len(shared),)),
        A("con_solimp", "double",
          flat2([solimp_row(c[2]) for c in shared]), (len(shared), 5)),
        A("con_mu", "double", [c[3] for c in shared], (len(shared),)),
        A("con_invweight", "double", [c[4] for c in shared],
          (len(shared),)),
        # pyramidal facet regularizer scale iw * 2 mu^2 (1 + mu^2)
        A("con_pyramid_weight", "double",
          [c[4] * 2.0 * c[3] * c[3] * (1.0 + c[3] * c[3]) for c in shared],
          (len(shared),)),
        A("con_condim", "int", [c[5] for c in shared], (len(shared),)),
        A("con_row", "int", con_row, (len(shared),)),
        A("con_tri", "int", con_tri, (len(shared),)),
        A("tri_mu", "double", tri_mu, (ntri,)),
        A("own_lane", "int", [x for lay in layouts for x in lay[0]],
          (len(LANES), nrows)),
        A("own_slot", "int", [x for lay in layouts for x in lay[1]],
          (len(LANES), nrows)),
        A("slots", "int", [lay[2] for lay in layouts], (len(LANES),)),
        A("tri_groups", "int", [lay[3] for lay in layouts], (len(LANES),)),
        "};\n"]
    return "".join(out)


# ---------------------------------------------------------------------------
# builds
# ---------------------------------------------------------------------------

def _build_dir_for(header: str, sources) -> str:
    h = hashlib.sha256(header.encode())
    for name in sources:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16])


def _write_header(bdir, header, name="planar_model.cuh"):
    os.makedirs(bdir, exist_ok=True)
    path = os.path.join(bdir, name)
    if not os.path.exists(path):
        fd, tmp = tempfile.mkstemp(dir=bdir, suffix=".cuh")
        with os.fdopen(fd, "w") as f:
            f.write(header)
        os.replace(tmp, path)


def _compile(cmd, out_path, log_path):
    """Run the compiler into a temp file and rename into place, so a
    concurrent loader never sees a partial library.  Returns seconds."""
    bdir = os.path.dirname(out_path)
    fd, tmp = tempfile.mkstemp(dir=bdir, suffix=".so.tmp")
    os.close(fd)
    t0 = time.time()
    try:
        proc = subprocess.run(cmd + ["-o", tmp], capture_output=True,
                              text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"kernel build failed ({' '.join(cmd)}):\n{log}")
        with open(log_path, "w") as f:
            f.write(log)
        os.replace(tmp, out_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return time.time() - t0


def find_nvcc():
    cand = shutil.which("nvcc")
    if cand is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(cuda_home, "bin", "nvcc")
        if not os.path.exists(cand):
            return None
    return cand


def _parse_ptxas(log: str):
    """``-Xptxas -v`` output -> {kernel: {registers, spill_stores,
    spill_loads, stack_frame}}."""
    info, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = info.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                      r" (\d+) bytes spill loads", line)
        if m and "stack_frame" not in cur:   # later lines: libm helpers
            cur["stack_frame"], cur["spill_stores"], cur["spill_loads"] = \
                map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return info


def _lanes_for(p: PlanarParams, lanes):
    """The lane-group size a build or launch of ``p``'s kernel uses:
    ``lanes``, or the model's default for None; raises for a size the
    kernel is not built for."""
    if lanes is None:
        return default_lanes(p)
    allowed = kernel_lanes(p)
    if lanes not in allowed:
        raise ValueError(f"{kernel_name(p)}: lanes must be one of {allowed},"
                         f" got {lanes}")
    return int(lanes)


def build_kernel(p: PlanarParams, lanes=None):
    """Build (or find built) the CUDA library for ``p`` at ``lanes`` per
    environment (None: the model's default) -> (lib path, info dict with
    build seconds and ptxas figures)."""
    source, headers, _ = KERNELS[kernel_name(p)]
    lanes = _lanes_for(p, lanes)
    defines = [f"-DPLANAR_LANES={lanes}"]
    header = emit_model_header(p)
    bdir = _build_dir_for(header + " ".join(defines), (source,) + headers)
    so = os.path.join(bdir, "libplanar_step.so")
    log_path = os.path.join(bdir, "nvcc.log")
    seconds = 0.0
    if not os.path.exists(so):
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "the planar CUDA kernel needs nvcc (CUDA toolkit) to build;"
                " none found on PATH or under CUDA_HOME")
        _write_header(bdir, header)
        seconds = _compile(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             *defines, "-I", bdir, "-I", CSRC_DIR,
             os.path.join(CSRC_DIR, source)], so, log_path)
    with open(log_path) as f:
        ptxas = _parse_ptxas(f.read())
    return so, dict(build_seconds=seconds, ptxas=ptxas, build_dir=bdir)


def build_kernels(items):
    """Build several kernels at once, one ``nvcc`` per item, all started
    together.  items: ``(PlanarParams, lanes)`` -> list of (lib path, info
    dict) in order."""
    from concurrent.futures import ThreadPoolExecutor
    items = list(items)
    with ThreadPoolExecutor(max(1, len(items))) as pool:
        return list(pool.map(lambda it: build_kernel(*it), items))


def _load_kernel(p: PlanarParams, lanes):
    key = (p, lanes)
    hit = _libs.get(key)
    if hit is None:
        so, info = build_kernel(p, lanes)
        lib = ctypes.CDLL(so)
        vp = ctypes.c_void_p
        entry = KERNELS[kernel_name(p)][2]
        fns = {}
        for dtype, suffix in ((torch.float32, "_f32"),
                              (torch.float64, "_f64")):
            fn = fns[dtype] = getattr(lib, entry + suffix)
            fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                           vp]
            fn.restype = ctypes.c_int
        dims = (ctypes.c_int * 5)()
        lib.planar_model_dims(dims)
        if tuple(dims)[:3] != (p.nv, p.nbody, len(p.actuators)):
            raise RuntimeError("kernel library built for another model")
        if dims[4] != lanes:
            raise RuntimeError(f"kernel library built for {dims[4]} lanes, "
                               f"not {lanes}")
        hit = _libs[key] = (fns, info)
    return hit


def kernel_build_info(p: PlanarParams, lanes=None):
    """Build figures of the kernel for ``p`` (builds it if needed)."""
    return _load_kernel(p, _lanes_for(p, lanes))[1]


def load_host_body(p: PlanarParams, lanes: int = 1):
    """The kernel body compiled with g++ for the host -> ctypes lib.  For
    tests: lets the kernel's arithmetic be checked where there is no GPU.
    ``lanes`` 1: ``csrc/planar_host.cpp``, one thread per environment
    (``planar_host_step_f32/_f64``); another of ``kernel_lanes(p)``: the
    body with the lanes of a group as fibers, ``csrc/planar_host_lanes.cpp``
    (``planar_host_lanes_step_f32/_f64``, one library for every ``L``)."""
    lib = _host_libs.get((p, lanes))
    if lib is None:
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found")
        if lanes not in kernel_lanes(p):
            raise ValueError(f"no host harness for {lanes} lanes of "
                             f"{kernel_name(p)}")
        source, prefix = (("planar_host.cpp", "planar_host_step")
                          if lanes == 1 else
                          ("planar_host_lanes.cpp", "planar_host_lanes_step"))
        header = emit_model_header(p)
        bdir = _build_dir_for(header, (source, "planar_body.cuh",
                                       "planar_contact.cuh"))
        so = os.path.join(bdir, "lib" + source.replace(".cpp", ".so"))
        if not os.path.exists(so):
            _write_header(bdir, header)
            _compile([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                      "-I", bdir, "-I", CSRC_DIR,
                      os.path.join(CSRC_DIR, source)],
                     so, os.path.join(bdir, source + ".log"))
        lib = ctypes.CDLL(so)
        for suffix, ct in (("_f32", ctypes.c_float),
                           ("_f64", ctypes.c_double)):
            fn = getattr(lib, prefix + suffix)
            ptr = ctypes.POINTER(ct)
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_int,
                           ctypes.c_int] + ([ctypes.c_int] if lanes != 1
                                            else [])
            fn.restype = None if lanes == 1 else ctypes.c_int
        _host_libs[p, lanes] = lib
    return lib


def host_step_n_batched(p: PlanarParams, qpos, qvel, ctrl, n: int,
                        lanes: int = 1):
    """numpy (B, nv), (B, nv), (B, nu) -> stepped numpy arrays through the
    g++ build of the kernel body (float32 or float64) at ``lanes`` per
    environment; raises if the lanes of a group make different numbers of
    group reductions or end with different bits."""
    import numpy as np
    lib = load_host_body(p, lanes)
    dt = np.dtype(qpos.dtype)
    prefix = "planar_host_step" if lanes == 1 else "planar_host_lanes_step"
    suffix, ct = {np.dtype(np.float32): ("_f32", ctypes.c_float),
                  np.dtype(np.float64): ("_f64", ctypes.c_double)}[dt]
    fn = getattr(lib, prefix + suffix)
    q, v, u = (np.ascontiguousarray(a, dt) for a in (qpos, qvel, ctrl))
    qo, vo = np.empty_like(q), np.empty_like(v)
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ct))
    args = (ptr(q), ptr(v), ptr(u), ptr(qo), ptr(vo), q.shape[0], int(n))
    if lanes == 1:
        fn(*args)
        return qo, vo
    rc = fn(*args, int(lanes))
    if rc < 0:
        raise RuntimeError(f"the {lanes} lanes of a group made different "
                           "numbers of group reductions")
    if rc > 0:
        raise RuntimeError(f"{rc} environments' lanes ended with different "
                           "bits")
    return qo, vo


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def cuda_step_n_batched(p: PlanarParams, qpos, qvel, ctrl, n: int,
                        lanes=None):
    """(B, nv), (B, nv), (B, nu) -> stepped (B, nv) x2: one whole control
    step (``n`` substeps) for every environment.

    CUDA tensors: one launch of the hand-written kernel the model needs
    (smooth, or contact / RK4) on the current stream, no synchronisation;
    anything the kernel does not take raises.  ``lanes``: lanes per
    environment (one of ``kernel_lanes(p)``; None: the model's
    ``default_lanes``).  CPU tensors: the plain PyTorch version."""
    lanes = _lanes_for(p, lanes)
    if qpos.device.type == "cpu":
        return step_n_arrays(p, qpos, qvel, ctrl, n)
    if qpos.device.type != "cuda":
        raise ValueError(f"unsupported device {qpos.device}")
    nv, nu = p.nv, len(p.actuators)
    if qpos.dim() != 2 or qpos.shape[1] != nv:
        raise ValueError(f"qpos must be (B, {nv}), got {tuple(qpos.shape)}")
    B = qpos.shape[0]
    if tuple(qvel.shape) != (B, nv) or tuple(ctrl.shape) != (B, nu):
        raise ValueError(
            f"qvel must be ({B}, {nv}) and ctrl ({B}, {nu}), got "
            f"{tuple(qvel.shape)} and {tuple(ctrl.shape)}")
    if B < 1 or nu < 1 or int(n) < 0:
        raise ValueError("need B >= 1, nu >= 1, n >= 0")
    if qpos.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernel takes float32 or float64, got {qpos.dtype}")
    for name, t in (("qvel", qvel), ("ctrl", ctrl)):
        if t.dtype != qpos.dtype or t.device != qpos.device:
            raise TypeError(f"{name}: dtype/device differ from qpos "
                            f"({t.dtype}, {t.device})")
    for name, t in (("qpos", qpos), ("qvel", qvel), ("ctrl", ctrl)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    fns, _ = _load_kernel(p, lanes)
    qout = torch.empty_like(qpos)
    vout = torch.empty_like(qvel)
    fn = fns[qpos.dtype]
    with torch.cuda.device(qpos.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(qpos.data_ptr(), qvel.data_ptr(), ctrl.data_ptr(),
                qout.data_ptr(), vout.data_ptr(), B, int(n), stream)
    name = kernel_name(p)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launch_counts[name] += 1
    return qout, vout
