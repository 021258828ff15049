"""Native (C++) host-side path operations (counterpart of
``mjrl_tpu/native/__init__.py``).

Compiled with ``g++ -O3 -shared -fPIC`` at first use into
``mjrl_tpu_torch/_build/<hash>/libpathops.so`` (the hash is the source's)
and bound via ctypes (no pybind11).  Unlike the JAX package this module
never falls back: when the build or the load fails it raises, naming the
compiler's error.  The numpy loops it replaces are kept as the plain
versions (``*_plain``), which the tests hold the native ops to.

- ``pack_paths(list_of_2d_arrays) -> (padded (N,T,D) f32, mask (N,T) f32)``
- ``discount_sums(list_of_1d, gamma) -> list_of_1d``
- ``gae_advantages(rewards_list, values_list, terminated, gamma, lam)``

This is host C++, not a device kernel: the arrays are numpy's.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

from mjrl_tpu_torch.ops.cuda_planar import BUILD_DIR

SRC = os.path.join(os.path.dirname(__file__), "src", "pathops.cpp")


def build():
    """Build (or find built) the library -> its path; raises with the
    compiler's output when g++ is missing or fails."""
    with open(SRC, "rb") as f:
        source = f.read()
    bdir = os.path.join(BUILD_DIR,
                        hashlib.sha256(b"pathops" + source).hexdigest()[:16])
    so = os.path.join(bdir, "libpathops.so")
    if os.path.exists(so):
        return so
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("native pathops need g++ to build; none on PATH")
    os.makedirs(bdir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=bdir, suffix=".so.tmp")
    os.close(fd)
    try:
        cmd = [gxx, "-O3", "-shared", "-fPIC", SRC, "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"native pathops build failed ({' '.join(cmd)})"
                               f":\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)     # a concurrent loader never sees a partial .so
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.lru_cache(maxsize=None)
def _load():
    lib = ctypes.CDLL(build())
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.pack_paths.argtypes = [f32p, i64p, ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_int64, f32p, f32p]
    lib.discount_sums.argtypes = [f64p, i64p, ctypes.c_int64,
                                  ctypes.c_double, f64p]
    lib.gae_advantages.argtypes = [f64p, f64p, i64p, u8p, ctypes.c_int64,
                                   ctypes.c_double, ctypes.c_double, f64p]
    for fn in (lib.pack_paths, lib.discount_sums, lib.gae_advantages):
        fn.restype = None
    return lib


def available():
    """True when the library builds (or is built) and loads.  Nothing in
    the port picks another path on it: the path ops raise without the
    library."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _ragged(xs):
    """list of 1-D arrays -> (lengths (n,) int64, contiguous float64
    concatenation)."""
    lengths = np.array([len(x) for x in xs], np.int64)
    flat = np.ascontiguousarray(
        np.concatenate([np.asarray(x, np.float64).reshape(-1) for x in xs]),
        np.float64)
    return lengths, flat


def _split(out, lengths):
    return np.split(out, np.cumsum(lengths)[:-1])


def _pack_shape(arrays, max_len):
    dim = arrays[0].shape[1] if arrays[0].ndim > 1 else 1
    lengths = np.array([a.shape[0] for a in arrays], np.int64)
    T = int(max_len or lengths.max())
    return dim, lengths, T


def pack_paths(arrays, max_len=None):
    """list of (len_i, D) float arrays -> ((N, T, D) f32, (N, T) f32
    mask), T = ``max_len`` or the longest."""
    dim, lengths, T = _pack_shape(arrays, max_len)
    out = np.zeros((len(arrays), T, dim), np.float32)
    mask = np.zeros((len(arrays), T), np.float32)
    flat = np.ascontiguousarray(
        np.concatenate([np.asarray(a).reshape(a.shape[0], dim)
                        for a in arrays]), np.float32)
    _load().pack_paths(_ptr(flat, ctypes.c_float),
                       _ptr(lengths, ctypes.c_int64), len(arrays), T, dim,
                       _ptr(out, ctypes.c_float), _ptr(mask, ctypes.c_float))
    return out, mask


def discount_sums(xs, gamma):
    """list of (len_i,) arrays -> list of same-shape reverse discounted
    sums (float64)."""
    lengths, flat = _ragged(xs)
    out = np.empty_like(flat)
    _load().discount_sums(_ptr(flat, ctypes.c_double),
                          _ptr(lengths, ctypes.c_int64), len(xs),
                          float(gamma), _ptr(out, ctypes.c_double))
    return _split(out, lengths)


def gae_advantages(rewards, values, terminated, gamma, lam):
    """Ragged GAE: lists of (len_i,) rewards / values, terminated (n,)
    bools -> list of advantage arrays (float64)."""
    lengths, r = _ragged(rewards)
    lengths_v, v = _ragged(values)
    if not np.array_equal(lengths, lengths_v):
        raise ValueError("rewards and values differ in their lengths")
    term = np.ascontiguousarray(np.asarray(terminated, bool), np.uint8)
    if term.shape != lengths.shape:
        raise ValueError("one terminated flag per path")
    out = np.empty_like(r)
    _load().gae_advantages(_ptr(r, ctypes.c_double), _ptr(v, ctypes.c_double),
                           _ptr(lengths, ctypes.c_int64),
                           _ptr(term, ctypes.c_uint8), len(rewards),
                           float(gamma), float(lam),
                           _ptr(out, ctypes.c_double))
    return _split(out, lengths)


# -- the plain versions (numpy loops), for the tests --------------------------

def pack_paths_plain(arrays, max_len=None):
    dim, _, T = _pack_shape(arrays, max_len)
    out = np.zeros((len(arrays), T, dim), np.float32)
    mask = np.zeros((len(arrays), T), np.float32)
    for i, a in enumerate(arrays):
        t = min(a.shape[0], T)
        out[i, :t] = np.asarray(a).reshape(a.shape[0], dim)[:t]
        mask[i, :t] = 1.0
    return out, mask


def discount_sums_plain(xs, gamma):
    outs = []
    for x in xs:
        x = np.asarray(x, np.float64)
        y, run = np.empty_like(x), 0.0
        for t in range(len(x) - 1, -1, -1):
            run = x[t] + gamma * run
            y[t] = run
        outs.append(y)
    return outs


def gae_advantages_plain(rewards, values, terminated, gamma, lam):
    outs = []
    for r, v, term in zip(rewards, values, terminated):
        r, v = np.asarray(r, np.float64), np.asarray(v, np.float64)
        n = len(r)
        bootstrap = 0.0 if term or n == 0 else v[n - 1]
        y, run = np.empty_like(r), 0.0
        for t in range(n - 1, -1, -1):
            v_next = v[t + 1] if t + 1 < n else bootstrap
            run = r[t] + gamma * v_next - v[t] + gamma * lam * run
            y[t] = run
        outs.append(y)
    return outs
