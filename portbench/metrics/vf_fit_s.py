"""Seconds of the baseline's fit per iteration: the mean of the agent
log's ``time_VF`` over the window's iterations."""


def read(ctx):
    t = ctx["log"].get("time_VF")
    return sum(t) / len(t) if t else None
