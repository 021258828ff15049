"""Control steps per second of the rollouts, over every card: all rows x
horizon over the agent log's ``time_sampling`` (rank 0's), summed over
the window's iterations."""


def read(ctx):
    t = ctx["log"].get("time_sampling")
    if not t:
        return None
    return ctx["rows_total"] * ctx["horizon"] * len(t) / sum(t)
