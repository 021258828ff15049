"""The share of an iteration in which no operation ran on the card, in %:
one minus the device's busy time in the profiled iteration (the union of
its operations' intervals) over the mean seconds of the window's
unprofiled iterations.  The profiler's own host cost slows the host-paced
rollout of the profiled iteration, not the card's work, so its wall time
would overstate the idle share."""


def read(ctx):
    per_iteration = ctx["seconds"] / ctx["iterations"]
    return 100.0 * (1.0 - ctx["trace"]["busy_s"] / per_iteration)
