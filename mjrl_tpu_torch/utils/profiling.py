"""Profiling helpers (counterpart of ``mjrl_tpu/utils/profiling.py``).

The agents' coarse wall-clock log keys (``time_sampling``, ``time_npg``,
...) stay where they are; this module adds a context manager around
``torch.profiler`` (CPU and, where a card is present, CUDA activities)
that writes a Chrome trace, viewable in Perfetto or ``chrome://tracing``,
the program's own spans, and a timing utility for a callable.

    with profiling.trace("/tmp/trace"):
        agent.train_step(...)

Spans.  The program marks where its work happens with ``span(name)`` (or
the decorator ``spanned(name)``).  Tracing is on exactly while a
``torch.profiler`` session (or ``emit_nvtx``) runs; otherwise ``span``
returns one shared no-op context: no range, no clock read, no allocation.
While it is on, a span enters a profiler range named ``mjrl.<name>`` (the
RecordFunction that ``record_function`` enters, by its fast entry where
the torch build has one: without ``record_function``'s user annotation,
whose correlation on the card costs ~0.1 ms a span under CUDA tracing),
so it sits on the profiler's host timeline, and records its host start
and end on the profiler's clock (``time.time_ns()``), its parent span and
the id of its root span (``train_step`` in training: every span of one
iteration shares it).  A root span opened with a CUDA ``device`` puts its
tree on the card: each timed span of it (``timed=True``, the default)
records a pair of timing events on the current stream.  A span adds no
synchronize and draws no random number.

``device_s`` of a timed span is the stream's elapsed time between its two
events (resolved when first read; a span holds no tensor), its host
seconds off the card.  Work a span leaves to the host, such as Python
between launches, shows in ``device_s`` as the stream's idle time.  A span
made with ``timed=False`` has host seconds alone (``device_s`` None):
``control_step``, ``policy`` and ``env_step``, whose three event pairs a
control step would slow the profiled rollout.

The spans (each ``mjrl.<name>``; host seconds only where marked *):

- ``train_step``: one iteration of ``BatchREINFORCE.train_step``;
- ``rollout`` > ``control_step``* (x T) > ``policy``* (forward, noise,
  action), ``env_step``* (the planar kernel's launch and its wrapper's
  ops), ``reset`` (autoreset of terminating envs: the fresh states and the
  row select);
- ``gae``: returns, baseline values, GAE and whitening;
- ``update`` > ``vpg_grad``, ``cg`` > ``fvp`` (one per CG iteration, and
  one for ``x0``), ``line_search`` (the KL guard);
- ``fit``: the baseline's fit;
- ``collective``: one all-reduce of ``Mesh.all_reduce_sum``.

The recorder keeps the last ``KEEP`` root spans with their trees, so a long
profiled run does not grow it.  ``last_step()`` gives the last
``train_step``'s spans per name, ``steps()`` every kept tree's, ``trees()``
the spans themselves; ``clear()`` forgets them.
"""

import collections
import contextlib
import dataclasses
import functools
import itertools
import json
import os
import tempfile
import time

import torch

KEEP = 8                       # root spans (iterations) the recorder keeps
PREFIX = "mjrl."
_OFF = contextlib.nullcontext()
_tracing = torch.autograd._profiler_enabled


def _range(name):
    """A profiler range named ``name``: the fast entry where the torch
    build has it, else ``record_function``."""
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is None:
        return torch.autograd.profiler.record_function(name)
    return fast(name)


def _mark():
    """A timing event recorded on the current stream."""
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class Span:
    """One recorded stretch of the program (see the module's docstring)."""

    __slots__ = ("name", "id", "parent", "step", "start_ns", "end_ns",
                 "card", "timed", "_start", "_end", "_device_s", "_range",
                 "_device", "_recorder")

    def __init__(self, recorder, name, device, timed):
        self._recorder, self.name = recorder, name
        self._device, self.timed = device, timed
        self._start = self._end = self._device_s = None

    def __enter__(self):
        rec = self._recorder
        parent = rec._stack[-1] if rec._stack else None
        self.id = next(rec._ids)
        if parent is None:
            self.parent, self.step = None, self.id
            rec._tree = []
            self.card = (self._device is not None
                         and torch.device(self._device).type == "cuda")
        else:
            self.parent, self.step = parent.id, parent.step
            self.card = parent.card
        self._range = _range(PREFIX + self.name)
        self._range.__enter__()
        self.start_ns = time.time_ns()
        if self.card and self.timed:
            self._start = _mark()
        rec._stack.append(self)
        return self

    def __exit__(self, *exc):
        if self._start is not None:
            self._end = _mark()
        self.end_ns = time.time_ns()
        self._range.__exit__(*exc)
        self._range = None
        self._recorder._close(self)
        return False

    @property
    def host_s(self):
        return (self.end_ns - self.start_ns) / 1e9

    @property
    def device_s(self):
        """The stream's seconds between the span's two events (the host's
        off the card; None where the span is not timed); waits for the
        second event the first time it is read."""
        if self._device_s is None and self.timed:
            if self._start is None:
                self._device_s = self.host_s
            else:
                self._end.synchronize()
                self._device_s = self._start.elapsed_time(self._end) / 1e3
                self._start = self._end = None
        return self._device_s


class Recorder:
    """The spans of the last ``KEEP`` root spans, each tree a list of its
    spans in the order they closed (the root last)."""

    def __init__(self):
        self._trees = collections.deque(maxlen=KEEP)
        self._ids = itertools.count(1)
        self._stack = []            # the open spans, the root first
        self._tree = []             # the closed spans of the open root

    def _close(self, span):
        while self._stack and self._stack.pop() is not span:
            pass
        self._tree.append(span)
        if span.parent is None:
            self._trees.append(self._tree)
            self._tree = []

    def span(self, name, device=None, timed=True):
        """The span ``name`` (a no-op while tracing is off).  ``device``
        of a root span: a CUDA device puts its tree's timed spans on the
        card's clock.  ``timed=False``: host seconds alone."""
        if not _tracing():
            return _OFF
        return Span(self, name, device, timed)

    def clear(self):
        self._trees.clear()

    def trees(self):
        """The kept trees, oldest first, each a list of its spans in the
        order they closed (the root last)."""
        return [list(t) for t in self._trees]

    def steps(self):
        """Each kept tree: its root's name and id and its spans per name."""
        return [{"root": t[-1].name, "step": t[-1].step, "spans": table(t)}
                for t in self.trees()]

    def last_step(self):
        """The spans per name of the last ``train_step``'s tree, or None."""
        for t in reversed(self.trees()):
            if t[-1].name == "train_step":
                return table(t)
        return None


def timed_parent(span, by_id):
    """The nearest timed span above ``span`` in its tree, or None."""
    p = by_id.get(span.parent)
    while p is not None and not p.timed:
        p = by_id.get(p.parent)
    return p


def table(spans):
    """Spans of one tree -> {name: count, host_s, device_s, self_device_s
    (``device_s`` less that of the nearest timed spans below it)}; the two
    device columns are None for a span that is not timed."""
    by_id = {s.id: s for s in spans}
    below = collections.Counter()
    for s in spans:
        p = timed_parent(s, by_id) if s.timed else None
        if p is not None:
            below[p.id] += s.device_s
    out = {}
    for s in spans:
        row = out.setdefault(s.name, {"count": 0, "host_s": 0.0,
                                      "device_s": None,
                                      "self_device_s": None})
        row["count"] += 1
        row["host_s"] += s.host_s
        if s.timed:
            row["device_s"] = (row["device_s"] or 0.0) + s.device_s
            row["self_device_s"] = ((row["self_device_s"] or 0.0)
                                    + s.device_s - below[s.id])
    return out


RECORDER = Recorder()
span = RECORDER.span
clear = RECORDER.clear
steps = RECORDER.steps
trees = RECORDER.trees
last_step = RECORDER.last_step


def spanned(name):
    """Decorator: each call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned_fn(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned_fn
    return wrap


@contextlib.contextmanager
def trace(log_dir=None):
    """Trace the enclosed block; on exit the trace is written to
    ``log_dir/trace.json`` (default: ``mjrl_tpu_torch_trace`` in the
    temporary directory) and the program's spans, per name for each
    recorded iteration (``steps()``), to ``log_dir/spans.json``.  The
    recorder is cleared on entry.  Yields the profiler (``key_averages()``,
    ``events()``)."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "mjrl_tpu_torch_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()    # the block's last kernels finish
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(steps(), f, indent=1)


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
