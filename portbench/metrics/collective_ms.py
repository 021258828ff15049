"""Device milliseconds of the NCCL kernels in the profiled iteration on
rank 0: the collectives' time on the card, waiting for the slowest rank
included."""


def read(ctx):
    times = [t for name, ts in ctx["trace"]["durations"].items()
             if "nccl" in name.lower() for t in ts]
    return 1e3 * sum(times) if times else None
