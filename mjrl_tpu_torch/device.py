"""Device selection shared by every constructor of the port."""

import torch


def default_device():
    """``cuda``: the port runs on the GPU.  Without one this raises; the CPU
    is used only when a caller asks for it (``device="cpu"``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA GPU found (torch.cuda.is_available() is false): the "
            "port runs on the GPU; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None):
    """``None`` -> ``default_device()``; anything else -> ``torch.device``."""
    return default_device() if device is None else torch.device(device)


def make_generator(seed, device=None):
    """A seeded ``torch.Generator`` living on ``device`` (the port's
    counterpart of a ``jax.random.PRNGKey``)."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(seed))
    return g
