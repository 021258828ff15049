"""Collectives the agent issues per iteration over the ranks of a cell on
several cards: the program's own count (``Mesh.collectives``) over the
window's iterations."""


def read(ctx):
    if ctx["ranks"] < 2:
        return None
    return ctx["collectives"] / ctx["iterations"]
