"""Reading a profiled iteration from torch.profiler's raw Kineto events.

The measured iteration is the host span ``portbench.iteration1`` (the one
before it warms the profiler up: its first kernel events can be lost).
From the device's events inside that span come: the union of their
intervals (the device's busy time), each kernel's time by name (the
breakdown, and a kernel's time per launch for its roofline), and the idle
gaps between them, each labelled by the benchmark span the host was last
in (rollout, update, fit) and the host operation running when it began.
The tables of ``key_averages()`` are not built: for a hundred thousand
launches they cost more than the iteration.
"""

import bisect

import torch

WINDOW_SPAN = "portbench.iteration1"
PHASE_PREFIX = "portbench."


def _start(e):
    return e.start_ns()


def _end(e):
    return e.start_ns() + e.duration_ns()


def read(events, top=10):
    """-> dict(window_s, busy_s, durations (seconds of each device
    operation, by name), device_ops, idle_gaps)."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    spans = [e for e in events if e.device_type() == cpu
             and e.name() == WINDOW_SPAN]
    if not spans:
        raise RuntimeError("the profiled iteration's span is missing")
    w0, w1 = _start(spans[0]), _end(spans[0])
    dev = sorted(((max(_start(e), w0), min(_end(e), w1), e.name())
                  for e in events if e.device_type() == cuda
                  and not e.is_user_annotation()
                  and not e.name().startswith(PHASE_PREFIX)
                  and _end(e) > w0 and _start(e) < w1),
                 key=lambda x: x[0])
    merged = []
    for s, t, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    by_name, durations = {}, {}
    for s, t, name in dev:
        by_name[name] = by_name.get(name, 0) + (t - s)
        durations.setdefault(name, []).append((t - s) / 1e9)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    gaps, prev = [], w0
    for s, t in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = sorted((e for e in events if e.device_type() == cpu
                   and w0 <= _start(e) < w1), key=_start)
    phases = [e for e in host if e.name().startswith(PHASE_PREFIX)
              and e.name() != WINDOW_SPAN]
    phase_starts = [_start(e) for e in phases]
    host_starts = [_start(e) for e in host]

    def label(t):
        i = bisect.bisect_right(phase_starts, t) - 1
        phase = phases[i].name()[len(PHASE_PREFIX):] if i >= 0 else "other"
        op = None
        for j in range(bisect.bisect_right(host_starts, t) - 1, -1, -1):
            e = host[j]
            if _end(e) >= t and not e.name().startswith(PHASE_PREFIX):
                op = e.name()
                break
            if t - _start(e) > 5e9:
                break
        return phase if op is None else f"{phase}: {op}"

    return dict(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                durations=durations,
                device_ops=[[n, v / 1e9] for n, v in ops],
                idle_gaps=[[label(s), (t - s) / 1e9] for s, t in gaps])
