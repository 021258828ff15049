"""Seconds of returns, baseline values, GAE and whitening in the profiled
iteration: ``device_s`` of the program's ``gae`` span (the card's stream
between the span's two timing events), from the program's span recorder
(``mjrl_tpu_torch.utils.profiling``).  The profiled iteration runs under
torch.profiler, so a stretch the host paces carries the profiler's own
cost per operation; both sides of a comparison are profiled alike.  None
where the program records no such span."""


def read(ctx):
    try:
        from mjrl_tpu_torch.utils.profiling import last_step
    except ImportError:
        return None
    row = (last_step() or {}).get("gae")
    return row["device_s"] if row else None
