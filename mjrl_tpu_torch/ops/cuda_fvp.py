"""The NPG update's Fisher-vector product as one hand-written kernel (K3),
its plain PyTorch version, and their wrapper.

F v is the Hessian of the mean KL(old || new) of the Gaussian policy at new
= old, times v.  With a state-independent ``log_std`` it has a closed form
(``csrc/fvp_body.cuh``): for the mean network's parameters, mean_i m_i
J_i^T diag(coef) J_i v with coef = out_scale^2 * 2 / (2 exp(log_std)^2 +
1e-8), J_i the Jacobian of row i's network output; for ``log_std``, v times
4t (2t - 1e-8) / (2t + 1e-8)^2, t = exp(log_std)^2, times this rank's share
of the count; no cross term.  That is the double backward's mathematics
without the terms multiplied by mu_old - mu_new = 0.

- ``fvp_cuda``: the kernel, ``csrc/fvp.cu`` around ``csrc/fvp_body.cuh``:
  per row the forward from the observation, the tangent forward, u = coef *
  dout * m and the backward of u, then the outer products summed per block
  and a fixed-order reduction; one main launch and one reduce launch a
  product, nothing of size N written to device memory.
- ``fvp_plain``: the same arithmetic in plain PyTorch (explicit tangent
  forward, explicit backward, no autograd), for CPU tensors and for shapes
  the kernel does not take.
- ``FisherVectorProduct``: F v at fixed parameters and rows, flat in and
  flat out; ``kernel_rows`` is the one place that decides, from the shapes,
  which of the two a CUDA tensor takes.

The kernel is generated per shape (depth, widths, nonlinearity) and dtype:
``emit_model_header`` writes the sizes and offsets as ``constexpr`` into the
build directory.  Build: ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``, at first use into
``mjrl_tpu_torch/_build/<hash>/``.  Importing this module needs neither
CUDA nor ``nvcc``.
"""

import ctypes
import os
import shutil
from typing import NamedTuple

import torch

from mjrl_tpu_torch.ops.cuda_planar import (CSRC_DIR, _build_dir_for,
                                            _compile, _parse_ptxas,
                                            _write_header, find_nvcc)

KERNEL = "fisher_vector_product"
SOURCES = ("fvp.cu", "fvp_body.cuh")

# products computed by the kernel (plain integer; callers that want a
# per-phase count set it to 0 first)
launch_counts = {KERNEL: 0}


def reset_launch_counts():
    launch_counts[KERNEL] = 0


# What the kernel takes: every layer's input and output at most MAX_WIDTH
# wide (the widths it is held to on the card: chip_smoke.py, the gpu
# tests), and a block's shared memory (weights, tangent, the tile's
# activations and gradients, accumulators) within an H100's 227 KB at one
# of ROW_CHOICES rows a tile, the most rows that fit.  Anything else takes
# the plain closed form.
MAX_WIDTH = 64
SMEM_BYTES = 232448
ROW_CHOICES = (128, 64, 32)
SMEM_PER_SM = 233472           # an H100 SM's shared memory, 228 KB
# warps an SM: the blocks that fit by shared memory share them (PERF.md,
# K3: 16 warps an SM measured faster than 8 and than 32 with its spills)
WARPS_PER_SM = 16

_libs = {}         # (shape, dtype) -> (launch fn, max grid, info)
_host_libs = {}    # (shape, rows, threads) -> ctypes lib (g++ build)


class FvpShape(NamedTuple):
    sizes: tuple     # (obs_dim, *hidden_sizes, act_dim)
    relu: bool       # the hidden nonlinearity: relu, else tanh


def shape_of(params, nonlinearity):
    """The policy's shape from its parameter dict; ``mlp_forward`` takes
    any nonlinearity but "tanh" as relu, and so does this."""
    n = sum(1 for k in params if k.startswith("layers.")
            and k.endswith(".weight"))
    sizes = (params["layers.0.weight"].shape[1],) + tuple(
        params[f"layers.{i}.weight"].shape[0] for i in range(n))
    return FvpShape(tuple(int(s) for s in sizes), nonlinearity != "tanh")


def flat_keys(n_layers):
    """The kernel's flat parameter order: each layer's weight then bias,
    then log_std."""
    return [f"layers.{i}.{w}" for i in range(n_layers)
            for w in ("weight", "bias")] + ["log_std"]


def _r4(n):
    return (n + 3) // 4 * 4


def layout(shape: FvpShape):
    """Sizes and offsets of the kernel's shared memory and flat vector.
    The G buffers hold G_{L-1} first, then G_0 .. G_{L-2}; the hidden
    layers' tangents (``SCRH`` rows a buffer, two buffers in turn from row
    ``SCR`` where there are two hidden layers or more) alias the rows after
    G_{L-1}."""
    ins, outs = shape.sizes[:-1], shape.sizes[1:]
    L = len(outs)
    kp = [_r4(k + 1) for k in ins]
    jp = [_r4(j) for j in outs]
    pre = lambda xs: [sum(xs[:i]) for i in range(len(xs))]
    wsz = [j * k for j, k in zip(jp, kp)]
    nb = [(j // 4) * (k // 2) for j, k in zip(jp, kp)]
    pw, pb, p = [], [], 0
    for k, j in zip(ins, outs):
        pw.append(p)
        pb.append(p + j * k)
        p += j * k + j
    hidden = outs[:-1]
    scrh = max(hidden, default=0)
    nbuf = min(len(hidden), 2)
    grow = [jp[-1] + g for g in pre(jp[:-1])] + [0]
    return dict(L=L, ins=list(ins), outs=list(outs), kp=kp, jp=jp,
                woff=pre(wsz), hrow=pre(kp), grow=grow, boff=pre(nb),
                pw=pw, pb=pb, WSIZE=sum(wsz), HROWS=sum(kp),
                GROWS=max(sum(jp), jp[-1] + nbuf * scrh), SCR=jp[-1],
                SCRH=scrh, NBLK=sum(nb), PLS=p, P=p + outs[-1])


def smem_bytes(shape: FvpShape, rows, itemsize):
    """Bytes of shared memory a block of ``rows`` rows needs
    (``fvp::Body::SIZE``)."""
    lay = layout(shape)
    n = (2 * lay["WSIZE"] + (lay["HROWS"] + lay["GROWS"]) * (rows + 4)
         + 8 * lay["NBLK"] + _r4(shape.sizes[-1]) + 2 * _r4(shape.sizes[0])
         + rows)
    return n * itemsize


def kernel_rows(shape: FvpShape, dtype):
    """Rows a tile of the kernel for ``shape`` in ``dtype``, or None where
    the kernel does not take it (a width over MAX_WIDTH, shared memory over
    SMEM_BYTES at every row choice, another dtype): the one place that
    decides between the kernel and the plain closed form."""
    if dtype not in (torch.float32, torch.float64):
        return None
    if max(shape.sizes) > MAX_WIDTH:
        return None
    itemsize = torch.finfo(dtype).bits // 8
    for rows in ROW_CHOICES:
        if smem_bytes(shape, rows, itemsize) <= SMEM_BYTES:
            return rows
    return None


def launch_plan(shape: FvpShape, dtype):
    """(rows a tile, threads a block, blocks an SM) of the kernel for
    ``shape`` in ``dtype``: as many blocks as fit by shared memory (at most
    4), each with its share of WARPS_PER_SM; the registers are capped so
    that as many fit by registers."""
    rows = kernel_rows(shape, dtype)
    if rows is None:
        raise ValueError(f"the Fisher-vector kernel does not take {shape} "
                         f"in {dtype}")
    nbytes = smem_bytes(shape, rows, torch.finfo(dtype).bits // 8)
    blocks = max(1, min(SMEM_PER_SM // (nbytes + 1024), 4))
    threads = max(128, 32 * WARPS_PER_SM // blocks // 32 * 32)
    return rows, threads, blocks


# ---------------------------------------------------------------------------
# shape-traits header and builds
# ---------------------------------------------------------------------------

def emit_model_header(shape: FvpShape) -> str:
    lay = layout(shape)

    def acc(name, values):
        lits = ", ".join(str(int(x)) for x in values)
        return (f"  FVP_HD static constexpr int {name}(int l) {{\n"
                f"    constexpr int t[] = {{{lits}}};\n"
                f"    return t[l];\n  }}\n")

    out = ["// Generated by mjrl_tpu_torch/ops/cuda_fvp.py::emit_model_header;"
           " do not edit.\n",
           f"// policy sizes {list(shape.sizes)}, "
           f"{'relu' if shape.relu else 'tanh'}\n",
           "#pragma once\n\n",
           "#if defined(__CUDACC__)\n"
           "#define FVP_HD __host__ __device__ __forceinline__\n"
           "#else\n#define FVP_HD inline\n#endif\n\n",
           "struct FvpModel {\n",
           f"  static constexpr int L = {lay['L']};\n",
           "  static constexpr bool RELU = "
           f"{'true' if shape.relu else 'false'};\n"]
    for key in ("WSIZE", "HROWS", "GROWS", "SCR", "SCRH", "NBLK", "PLS",
                "P"):
        out.append(f"  static constexpr int {key} = {lay[key]};\n")
    for name, key in (("in", "ins"), ("out", "outs"), ("kp", "kp"),
                      ("jp", "jp"), ("woff", "woff"), ("hrow", "hrow"),
                      ("grow", "grow"), ("boff", "boff"), ("pw", "pw"),
                      ("pb", "pb")):
        out.append(acc(name, lay[key]))
    out.append("};\n")
    return "".join(out)


def _ctype(dtype):
    return {torch.float32: "float", torch.float64: "double"}[dtype]


def build_kernel(shape: FvpShape, dtype=torch.float32):
    """Build (or find built) the CUDA library for ``shape`` in ``dtype`` ->
    (lib path, info dict with rows a tile, build seconds and ptxas
    figures).  Raises for a shape the kernel does not take."""
    rows, threads, blocks = launch_plan(shape, dtype)
    nbytes = smem_bytes(shape, rows, torch.finfo(dtype).bits // 8)
    defines = [f"-DFVP_T={_ctype(dtype)}", f"-DFVP_ROWS={rows}",
               f"-DFVP_THREADS={threads}", f"-DFVP_MIN_BLOCKS={blocks}"]
    header = emit_model_header(shape)
    bdir = _build_dir_for(header + " ".join(defines), SOURCES)
    so = os.path.join(bdir, "libfvp.so")
    log_path = os.path.join(bdir, "nvcc.log")
    seconds = 0.0
    if not os.path.exists(so):
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                "the Fisher-vector CUDA kernel needs nvcc (CUDA toolkit) to "
                "build; none found on PATH or under CUDA_HOME")
        _write_header(bdir, header, "fvp_model.cuh")
        seconds = _compile(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             *defines, "-I", bdir, "-I", CSRC_DIR,
             os.path.join(CSRC_DIR, "fvp.cu")], so, log_path)
    with open(log_path) as f:
        ptxas = _parse_ptxas(f.read())
    return so, dict(rows=rows, threads=threads, min_blocks=blocks,
                    build_seconds=seconds, ptxas=ptxas, build_dir=bdir,
                    smem_bytes=nbytes)


def _load_kernel(shape: FvpShape, dtype):
    key = (shape, dtype)
    hit = _libs.get(key)
    if hit is None:
        so, info = build_kernel(shape, dtype)
        lib = ctypes.CDLL(so)
        vp = ctypes.c_void_p
        fn = lib.fvp_launch
        fn.argtypes = [vp, vp, ctypes.c_longlong, vp, vp, vp, vp, vp, vp, vp,
                       ctypes.c_int, vp, vp]
        fn.restype = ctypes.c_int
        dims = (ctypes.c_int * 6)()
        lib.fvp_dims(dims)
        lay = layout(shape)
        if tuple(dims) != (lay["P"], 8 * lay["NBLK"], info["rows"],
                           info["threads"],
                           info["smem_bytes"], torch.finfo(dtype).bits // 8):
            raise RuntimeError(f"kernel library built for another shape: "
                               f"{tuple(dims)}")
        grid = ctypes.c_int(0)
        lib.fvp_max_grid.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.fvp_max_grid.restype = ctypes.c_int
        rc = lib.fvp_max_grid(ctypes.byref(grid))
        if rc != 0:
            raise RuntimeError(f"{KERNEL}: setting up the kernel failed: CUDA "
                               f"error {rc}")
        info["max_grid"] = grid.value
        hit = _libs[key] = (fn, grid.value, info)
    return hit


def load_host_body(shape: FvpShape, rows: int = 32, threads: int = 256):
    """The kernel's arithmetic compiled with g++ for the host
    (``csrc/fvp_host.cpp``, one block's work in plain loops) -> ctypes lib
    with ``fvp_host_f32`` / ``fvp_host_f64``.  For tests: lets the kernel's
    arithmetic be checked where there is no GPU."""
    lib = _host_libs.get((shape, rows, threads))
    if lib is None:
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found")
        header = emit_model_header(shape)
        defines = [f"-DFVP_ROWS={rows}", f"-DFVP_THREADS={threads}"]
        bdir = _build_dir_for(header + " ".join(defines),
                              ("fvp_host.cpp", "fvp_body.cuh"))
        so = os.path.join(bdir, "libfvp_host.so")
        if not os.path.exists(so):
            _write_header(bdir, header, "fvp_model.cuh")
            _compile([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", *defines,
                      "-I", bdir, "-I", CSRC_DIR,
                      os.path.join(CSRC_DIR, "fvp_host.cpp")],
                     so, os.path.join(bdir, "fvp_host.log"))
        lib = ctypes.CDLL(so)
        vp = ctypes.c_void_p
        for name in ("fvp_host_f32", "fvp_host_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [vp, vp, ctypes.c_longlong] + [vp] * 7
            fn.restype = None
        _host_libs[shape, rows, threads] = lib
    return lib


def fvp_host(shape: FvpShape, theta, v, in_shift, in_scale, coef, cls, obs,
             mask=None, rows=32, threads=256):
    """``fvp_plain``'s inputs as CPU tensors -> F v through the g++ build
    of the kernel's arithmetic (float32 or float64)."""
    lib = load_host_body(shape, rows, threads)
    fn = {torch.float32: lib.fvp_host_f32,
          torch.float64: lib.fvp_host_f64}[obs.dtype]
    args = [t.contiguous() for t in (obs, theta, v, in_shift, in_scale, coef,
                                     cls)]
    m = None if mask is None else mask.to(obs.dtype).contiguous()
    out = torch.empty_like(args[2])
    o, th, vv, sh, sc, cf, cl = (t.data_ptr() for t in args)
    fn(o, None if m is None else m.data_ptr(), obs.shape[0], th, vv, sh, sc,
       cf, cl, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# the plain version and the kernel's wrapper
# ---------------------------------------------------------------------------

def _split(shape: FvpShape, flat):
    """Flat vector -> ([(W, b) per layer], log_std part)."""
    lay = layout(shape)
    layers = []
    for k, j, pw, pb in zip(lay["ins"], lay["outs"], lay["pw"], lay["pb"]):
        layers.append((flat[pw:pb].view(j, k), flat[pb:pb + j]))
    return layers, flat[lay["PLS"]:]


def fvp_plain(shape: FvpShape, theta, v, in_shift, in_scale, coef, cls, obs,
              mask=None):
    """F v (flat, this rank's share, no damping) in plain PyTorch: the
    kernel's arithmetic as tensor operations, an explicit tangent forward
    and an explicit backward, no autograd."""
    layers, _ = _split(shape, theta)
    tangent, v_ls = _split(shape, v)
    act = torch.relu if shape.relu else torch.tanh
    dact = ((lambda a: (a > 0).to(a.dtype)) if shape.relu
            else (lambda a: 1.0 - a * a))
    h = (obs - in_shift) / (in_scale + 1e-8)
    hs, dh = [h], None
    for i, ((w, b), (dw, db)) in enumerate(zip(layers, tangent)):
        dz = h @ dw.T + db
        if dh is not None:
            dz = dz + dh @ w.T
        if i + 1 == len(layers):
            break
        h = act(h @ w.T + b)
        dh = dact(h) * dz
        hs.append(h)
    g = coef * dz
    if mask is not None:
        g = g * mask[:, None]
    parts = []
    for i in reversed(range(len(layers))):
        parts = [(g.T @ hs[i]).reshape(-1), torch.sum(g, 0)] + parts
        if i > 0:
            g = (g @ layers[i][0]) * dact(hs[i])
    return torch.cat(parts + [cls * v_ls])


def fvp_cuda(shape: FvpShape, theta, v, in_shift, in_scale, coef, cls, obs,
             mask=None):
    """``fvp_plain`` on the card: one launch of K3 and one of its
    reduction on the current stream, no synchronisation.  Raises on
    anything the kernel does not take: another device or dtype, a
    non-contiguous tensor, a wrong size, a shape outside ``kernel_rows``."""
    if obs.device.type != "cuda":
        raise ValueError(f"{KERNEL}: needs CUDA tensors, got {obs.device}")
    if kernel_rows(shape, obs.dtype) is None:
        raise ValueError(f"{KERNEL}: the kernel does not take {shape} in "
                         f"{obs.dtype}")
    lay = layout(shape)
    n = obs.shape[0]
    want = {"obs": (n, shape.sizes[0]), "theta": (lay["P"],),
            "v": (lay["P"],), "in_shift": (shape.sizes[0],),
            "in_scale": (shape.sizes[0],), "coef": (shape.sizes[-1],),
            "cls": (shape.sizes[-1],)}
    named = {"obs": obs, "theta": theta, "v": v, "in_shift": in_shift,
             "in_scale": in_scale, "coef": coef, "cls": cls}
    if mask is not None:
        want["mask"] = (n,)
        named["mask"] = mask
    if n < 1:
        raise ValueError(f"{KERNEL}: no rows")
    for name, t in named.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{KERNEL}: {name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != obs.dtype or t.device != obs.device:
            raise TypeError(f"{KERNEL}: {name} is {t.dtype} on {t.device}, "
                            f"not {obs.dtype} on {obs.device}")
        if not t.is_contiguous():
            raise ValueError(f"{KERNEL}: {name} must be contiguous")
    fn, grid, _ = _load_kernel(shape, obs.dtype)
    with torch.cuda.device(obs.device):
        partial = torch.empty(grid * 8 * lay["NBLK"], dtype=obs.dtype,
                              device=obs.device)
        out = torch.empty_like(v)
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(obs.data_ptr(), None if mask is None else mask.data_ptr(), n,
                theta.data_ptr(), v.data_ptr(), in_shift.data_ptr(),
                in_scale.data_ptr(), coef.data_ptr(), cls.data_ptr(),
                partial.data_ptr(), grid, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{KERNEL} launch failed: CUDA error {rc}")
    launch_counts[KERNEL] += 1
    return out


class FisherVectorProduct:
    """F v at fixed parameters and rows: flat ``v`` (in ``keys``' order) ->
    this rank's share of F v, flat, without damping.

    ``rows`` is this rank's count of valid rows and ``count`` every rank's
    (at least 1).  CUDA tensors of a shape ``kernel_rows`` takes go to the
    kernel; every other tensor to the plain closed form."""

    def __init__(self, params, nonlinearity, transforms, obs, mask, rows,
                 count):
        self.shape = shape_of(params, nonlinearity)
        self.keys = flat_keys(len(self.shape.sizes) - 1)
        self.theta = torch.cat([params[k].detach().reshape(-1)
                                for k in self.keys])
        self.obs = obs.contiguous()
        self.mask = None if mask is None else \
            mask.to(obs.dtype).contiguous()
        self.in_shift = transforms.in_shift.contiguous()
        self.in_scale = transforms.in_scale.contiguous()
        std = torch.exp(params["log_std"].detach())
        den = 2.0 * std ** 2 + 1e-8
        var = std ** 2
        self.coef = (transforms.out_scale ** 2 * (2.0 / den)
                     / count).contiguous()
        self.cls = (4.0 * var * (2.0 * var - 1e-8) / den ** 2
                    * (rows / count)).contiguous()
        self.use_kernel = (obs.device.type == "cuda" and kernel_rows(
            self.shape, obs.dtype) is not None)

    def __call__(self, v):
        fn = fvp_cuda if self.use_kernel else fvp_plain
        return fn(self.shape, self.theta, v, self.in_shift, self.in_scale,
                  self.coef, self.cls, self.obs, self.mask)
