"""Profiling helpers (counterpart of ``mjrl_tpu/utils/profiling.py``).

The agents' coarse wall-clock log keys (``time_sampling``, ``time_npg``,
...) stay where they are; this module adds a context manager around
``torch.profiler`` (CPU and, where a card is present, CUDA activities)
that writes a Chrome trace, viewable in Perfetto or ``chrome://tracing``,
and a timing utility for a callable.

    with profiling.trace("/tmp/trace"):
        agent.train_step(...)
"""

import contextlib
import dataclasses
import os
import tempfile
import time

import torch


@contextlib.contextmanager
def trace(log_dir=None):
    """Trace the enclosed block; on exit the trace is written to
    ``log_dir/trace.json`` (default: ``mjrl_tpu_torch_trace`` in the
    temporary directory).  Yields the profiler (``key_averages()``,
    ``events()``)."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "mjrl_tpu_torch_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()    # the block's last kernels finish
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _sync(out):
    """Wait for the devices of every CUDA tensor in ``out`` (a tensor, or
    nested tuples, lists, dicts and dataclasses of them)."""
    if torch.is_tensor(out):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _sync(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _sync(v)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        _sync(vars(out))


def time_jitted(fn, *args, iters=10, warmup=1):
    """Median wall-clock seconds of ``fn(*args)``; each call ends when the
    devices of its output tensors have finished."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
