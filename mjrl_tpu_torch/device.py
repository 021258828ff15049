"""Device selection shared by every constructor of the port."""

import torch


def default_device():
    """``cuda`` when a GPU is available, ``cpu`` otherwise."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def resolve_device(device=None):
    """``None`` -> ``default_device()``; anything else -> ``torch.device``."""
    return default_device() if device is None else torch.device(device)


def make_generator(seed, device=None):
    """A seeded ``torch.Generator`` living on ``device`` (the port's
    counterpart of a ``jax.random.PRNGKey``)."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(seed))
    return g
