"""Seconds of returns, GAE and the NPG update per iteration: the mean of
the agent log's ``time_npg`` over the window's iterations."""


def read(ctx):
    t = ctx["log"].get("time_npg")
    return sum(t) / len(t) if t else None
