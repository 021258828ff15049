"""The planar whole-control-step kernel for NVIDIA Hopper, and its wrapper.

Counterpart of ``mjrl_tpu/ops/pallas_planar.py`` (``pallas_step_n_batched``
and the smooth branch of its ``_kernel``).  The kernel is hand-written CUDA
C++: ``csrc/planar_step.cu`` (launch, layout) around
``csrc/planar_body.cuh`` (the per-environment arithmetic, a template on the
scalar type and on a model-traits struct).  ``emit_model_header`` writes
that struct from a ``PlanarParams`` — sizes, tree structure and every
physical constant as ``constexpr`` — into the build directory, so the body
unrolls completely, as the Pallas kernel bakes its constants at trace time.

Build: ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, loaded with ``ctypes``; at first use, from ``csrc/`` alone, into
``mjrl_tpu_torch/_build/<hash>/``.  Importing this module needs neither CUDA
nor ``nvcc``; asking for the kernel without them raises.

``cuda_step_n_batched`` launches the kernel for CUDA tensors and raises if
it cannot; for CPU tensors, and only then, it runs the plain PyTorch
version ``physics.planar.step_n_arrays``.  There is no gradient: the policy
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

from mjrl_tpu_torch.physics.planar import (PGS_SWEEPS, PlanarParams,
                                           _tree_tables, chain_mask,
                                           fluid_constants,
                                           needs_contact_path, step_n_arrays)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

KERNEL_NAME = "planar_step_smooth"
KERNEL_SOURCE = "mjrl_tpu_torch/csrc/planar_step.cu"

# number of kernel launches made by cuda_step_n_batched (plain integer;
# callers that want a per-phase count set it to 0 first)
launch_count = 0

_libs = {}          # PlanarParams -> (ctypes lib, build info dict)
_host_libs = {}     # PlanarParams -> ctypes lib (g++ build of the body)


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


def emit_model_header(p: PlanarParams) -> str:
    """``struct PlanarModel`` for ``csrc/planar_body.cuh``: the sizes,
    the tree and every constant of ``p`` as constexpr tables.  Derived
    constants (fluid coefficients, clamped solimp mid, floored width) are
    computed here in double precision exactly as the plain version
    computes them in python floats."""
    if needs_contact_path(p):
        raise NotImplementedError("K2, ROADMAP queue 2")
    nv, nb, nu = p.nv, p.nbody, len(p.actuators)
    par, hs, jp = _tree_tables(p)
    chain = chain_mask(p)
    lim = [d for d in range(nv) if p.limited[d]]
    has_fluid = bool(p.viscosity or p.density)
    fl = [fluid_constants(p, b) for b in range(nb)]
    stiffness = p.stiffness if p.stiffness else (0.0,) * nv
    spring_ref = p.spring_ref if p.spring_ref else (0.0,) * nv

    def solimp_row(d):
        d0, dw, width, mid, power = p.solimp[d]
        return [d0, dw, max(width, 1e-12),
                min(max(mid, 1e-4), 1.0 - 1e-4), power]

    flat2 = lambda rows: [x for r in rows for x in r]
    out = ["// generated by mjrl_tpu_torch/ops/cuda_planar.py::"
           "emit_model_header — do not edit\n#pragma once\n"
           "#if defined(__CUDACC__)\n"
           "#define PLANAR_HD __host__ __device__ __forceinline__\n"
           "#else\n#define PLANAR_HD inline\n#endif\n\n"
           "struct PlanarModel {\n"
           f"  static constexpr int NV = {nv}, NB = {nb}, NU = {nu}, "
           f"NL = {len(lim)};\n"
           f"  static constexpr int PGS_SWEEPS = {PGS_SWEEPS};\n"
           f"  static constexpr double H = {_lit(p.timestep)};\n"
           f"  static constexpr bool HAS_FLUID = {str(has_fluid).lower()};\n"
           "  static constexpr bool HAS_GRAVITY = "
           f"{str(tuple(p.gravity2) != (0.0, 0.0)).lower()};\n"
           "  static constexpr bool HAS_SPRINGS = "
           f"{str(bool(any(stiffness))).lower()};\n"
           "  static constexpr bool HAS_DAMPING = "
           f"{str(bool(any(p.damping))).lower()};\n"]
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
        A("solimp", "double", flat2([solimp_row(d) for d in lim]),
          (len(lim), 5)),
        A("act_dof", "int", [a[0] for a in p.actuators], (nu,)),
        A("gear", "double", [a[1] for a in p.actuators], (nu,)),
        A("ctrl_lo", "double", [a[2] for a in p.actuators], (nu,)),
        A("ctrl_hi", "double", [a[3] for a in p.actuators], (nu,)),
        A("ctrl_limited", "int", [bool(a[4]) for a in p.actuators], (nu,)),
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


def _write_header(bdir, header):
    os.makedirs(bdir, exist_ok=True)
    path = os.path.join(bdir, "planar_model.cuh")
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


def build_kernel(p: PlanarParams):
    """Build (or find built) the CUDA library for ``p`` ->
    (lib path, info dict with build seconds and ptxas figures)."""
    header = emit_model_header(p)
    bdir = _build_dir_for(header, ("planar_step.cu", "planar_body.cuh"))
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
             "-I", bdir, "-I", CSRC_DIR,
             os.path.join(CSRC_DIR, "planar_step.cu")], so, log_path)
    with open(log_path) as f:
        ptxas = _parse_ptxas(f.read())
    return so, dict(build_seconds=seconds, ptxas=ptxas, build_dir=bdir)


def _load_kernel(p: PlanarParams):
    hit = _libs.get(p)
    if hit is None:
        so, info = build_kernel(p)
        lib = ctypes.CDLL(so)
        vp = ctypes.c_void_p
        for fn in (lib.planar_step_f32, lib.planar_step_f64):
            fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, ctypes.c_int,
                           vp]
            fn.restype = ctypes.c_int
        dims = (ctypes.c_int * 4)()
        lib.planar_model_dims(dims)
        if tuple(dims)[:3] != (p.nv, p.nbody, len(p.actuators)):
            raise RuntimeError("kernel library built for another model")
        hit = _libs[p] = (lib, info)
    return hit


def kernel_build_info(p: PlanarParams):
    """Build figures of the kernel for ``p`` (builds it if needed)."""
    return _load_kernel(p)[1]


def load_host_body(p: PlanarParams):
    """The kernel body compiled with g++ for the host (csrc/planar_host.cpp)
    -> ctypes lib with planar_host_step_f32/_f64.  For tests: lets the
    kernel's arithmetic be checked where there is no GPU."""
    lib = _host_libs.get(p)
    if lib is None:
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found")
        header = emit_model_header(p)
        bdir = _build_dir_for(header, ("planar_host.cpp", "planar_body.cuh"))
        so = os.path.join(bdir, "libplanar_host.so")
        if not os.path.exists(so):
            _write_header(bdir, header)
            _compile([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                      "-I", bdir, "-I", CSRC_DIR,
                      os.path.join(CSRC_DIR, "planar_host.cpp")],
                     so, os.path.join(bdir, "gxx.log"))
        lib = ctypes.CDLL(so)
        for fn, ct in ((lib.planar_host_step_f32, ctypes.c_float),
                       (lib.planar_host_step_f64, ctypes.c_double)):
            ptr = ctypes.POINTER(ct)
            fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_int,
                           ctypes.c_int]
            fn.restype = None
        _host_libs[p] = lib
    return lib


def host_step_n_batched(p: PlanarParams, qpos, qvel, ctrl, n: int):
    """numpy (B, nv), (B, nv), (B, nu) -> stepped numpy arrays through the
    g++ build of the kernel body (float32 or float64)."""
    import numpy as np
    lib = load_host_body(p)
    dt = qpos.dtype
    fn, ct = {np.dtype(np.float32): (lib.planar_host_step_f32,
                                     ctypes.c_float),
              np.dtype(np.float64): (lib.planar_host_step_f64,
                                     ctypes.c_double)}[np.dtype(dt)]
    q, v, u = (np.ascontiguousarray(a, dt) for a in (qpos, qvel, ctrl))
    qo, vo = np.empty_like(q), np.empty_like(v)
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ct))
    fn(ptr(q), ptr(v), ptr(u), ptr(qo), ptr(vo), q.shape[0], int(n))
    return qo, vo


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def cuda_step_n_batched(p: PlanarParams, qpos, qvel, ctrl, n: int):
    """(B, nv), (B, nv), (B, nu) -> stepped (B, nv) x2: one whole control
    step (``n`` substeps) for every environment.

    CUDA tensors: one launch of the hand-written kernel on the current
    stream, no synchronisation; anything the kernel does not take raises.
    CPU tensors: the plain PyTorch version."""
    global launch_count
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
    lib, _ = _load_kernel(p)
    qout = torch.empty_like(qpos)
    vout = torch.empty_like(qvel)
    fn = lib.planar_step_f32 if qpos.dtype == torch.float32 \
        else lib.planar_step_f64
    with torch.cuda.device(qpos.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(qpos.data_ptr(), qvel.data_ptr(), ctrl.data_ptr(),
                qout.data_ptr(), vout.data_ptr(), B, int(n), stream)
    if rc != 0:
        raise RuntimeError(f"planar_step kernel launch failed: CUDA error "
                           f"{rc}")
    launch_count += 1
    return qout, vout
