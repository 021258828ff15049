"""Device selection shared by every constructor of the port, and the device
the port's objects unpickle onto."""

import contextlib
import pickle
import threading
import warnings

import torch


def default_device():
    """``cuda``: the port runs on the GPU (this process's current card).
    Without one this raises; the CPU is used only when a caller asks for it
    (``device="cpu"``)."""
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


# -- unpickling ----------------------------------------------------------------

_unpickling = threading.local()


@contextlib.contextmanager
def unpickling_onto(device):
    """Within the block, the port's objects unpickle onto ``device`` (None:
    each onto the kind of device it was saved from, see
    ``unpickled_device``)."""
    prev = getattr(_unpickling, "device", None)
    _unpickling.device = None if device is None else torch.device(device)
    try:
        yield
    finally:
        _unpickling.device = prev


def unpickled_device(saved):
    """The device an object pickled from device ``saved`` unpickles onto:
    the loader's choice (``unpickling_onto``, ``load_pickle``); else a card
    pickle goes to this process's current card (raising without one) and a
    CPU pickle stays on the CPU."""
    chosen = getattr(_unpickling, "device", None)
    if chosen is not None:
        return chosen
    saved = torch.device(saved)
    if saved.type == "cpu":
        return saved
    try:
        return default_device()
    except RuntimeError as e:
        raise RuntimeError(
            f"this pickle was made on {saved} and there is no CUDA GPU "
            "here: load it with device=\"cpu\" (mjrl_tpu_torch.device."
            "load_pickle(path, device=\"cpu\"))") from e


def restore_generator(state, device, seed, saved):
    """A generator on ``device`` at the saved ``state`` (from a generator
    on device ``saved``).  A state of another device kind does not load,
    and raises; only when the loader itself moved the object to another
    kind of device (``unpickling_onto``) does the stream restart from
    ``seed``, with a warning that it is not the saved stream."""
    g = torch.Generator(device=device)
    try:
        set_generator_state(g, state)
    except ValueError:
        moved = getattr(_unpickling, "device", None) is not None \
            and torch.device(saved).type != torch.device(device).type
        if not moved:
            raise
        warnings.warn(
            f"moved from {saved} to {device}: the generator restarts from "
            f"seed {seed}, not the saved random stream", RuntimeWarning,
            stacklevel=2)
        g.manual_seed(int(seed))
    return g


def set_generator_state(generator, state):
    """``generator.set_state(state)``; a state of another device kind
    raises, naming both."""
    try:
        generator.set_state(state)
    except RuntimeError as e:
        raise ValueError(
            f"a generator state of {state.numel()} bytes does not load into "
            f"a {generator.device.type} generator: it was saved from "
            "another kind of device, and that random stream cannot "
            "continue here; it is not reseeded") from e


def load_pickle(path, device=None):
    """Unpickle ``path`` with the port's objects on ``device`` (None: see
    ``unpickled_device``)."""
    with open(path, "rb") as f, unpickling_onto(device):
        return pickle.load(f)
