"""Seconds of the rollout's autoreset in the profiled iteration: the
``device_s`` of the program's ``reset`` spans summed over the control
steps (the fresh states of a whole-batch reset and the row select; only
envs that terminate reset), from the program's span recorder
(``mjrl_tpu_torch.utils.profiling``).  The profiled iteration runs under
torch.profiler, so a stretch the host paces carries the profiler's own
cost per operation; both sides of a comparison are profiled alike.  None
where the program records no such span."""


def read(ctx):
    try:
        from mjrl_tpu_torch.utils.profiling import last_step
    except ImportError:
        return None
    row = (last_step() or {}).get("reset")
    return row["device_s"] if row else None
