"""Data parallelism over ranks (counterpart of ``mjrl_tpu/parallel/mesh.py``).

The JAX package shards the batch axis over a device mesh and lets GSPMD
insert the cross-device reductions.  The port splits the batch axis over the
R ranks of a ``torch.distributed`` process group, one process per rank, and
writes every cross-rank reduction out as a collective:

- a rollout made under a mesh holds this rank's rows only (B / R of the
  batch); each rank launches the planar kernel on its own rows;
- every random draw is made for the whole batch on every rank, from
  generators seeded alike, and each rank keeps its rows of it, so R ranks
  reproduce the one-rank stream;
- sums over rows (advantage whitening, the surrogate and KL means, the
  policy gradient, each Fisher-vector product, the baselines' normal
  equations and minibatch gradients) are all-reduced; everything after a
  reduction (CG, the line searches, the least-squares solve, Adam) runs
  replicated, and every rank takes the same branch.

Every collective is built on ``all_reduce`` (gloo over CUDA tensors offers
``broadcast`` and ``all_reduce`` only): a gather is an all-reduce of a
zero-padded buffer in which each rank fills its own slot.  A mesh without
a process group has one rank and its collectives are identities; a mesh
of more ranks needs one (a group of world size 1 issues its collectives).

The module functions take ``mesh=None`` for the unsharded path: then they
reduce nothing.
"""

from dataclasses import dataclass, fields, is_dataclass

import torch
import torch.distributed as dist

from mjrl_tpu_torch.device import default_device
from mjrl_tpu_torch.utils.profiling import span

BATCH_AXIS = "batch"


class Mesh:
    """R ranks along one batch axis: the process group (None for one rank
    without a process group), this rank, R and this rank's device.
    ``collectives`` counts the collectives issued; under a profiler each
    is a ``collective`` span, timed on the card."""

    def __init__(self, group, rank, size, device, axis_name=BATCH_AXIS):
        if group is None and int(size) != 1:
            raise ValueError(f"a mesh of {size} ranks needs a process "
                             "group")
        self.group = group
        self.rank = int(rank)
        self.size = int(size)
        self.device = torch.device(device)
        self.axis_names = (axis_name,)
        self.collectives = 0

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, axis={self.axis_names[0]!r})")

    # -- rows ------------------------------------------------------------
    def rows(self, n):
        """This rank's slice of ``n`` rows split evenly; ``n`` must divide
        by R, as JAX's batch sharding needs an even split."""
        n = int(n)
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over "
                             f"{self.size} ranks")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def cut(self, x):
        """This rank's part of rows that every rank holds alike (a demo
        set, a replicated batch): ``torch.tensor_split``, so the count
        need not divide by R."""
        return torch.tensor_split(x, self.size)[self.rank]

    # -- collectives -----------------------------------------------------
    def all_reduce_sum(self, x):
        """Sum of ``x`` over the ranks (a new tensor; ``x`` is kept)."""
        if self.group is None:
            return x
        with span("collective", device=self.device):
            out = x.detach().clone().contiguous()
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        self.collectives += 1
        return out

    def barrier(self):
        """Return once every rank has called it (at once without a process
        group): an all-reduce whose result the host reads."""
        if self.group is not None:
            t = torch.zeros(1, device=self.device)
            dist.all_reduce(t, group=self.group)
            t.item()

    def check_same(self, name, values):
        """Raise unless every rank holds the same floats ``values`` (NaN
        equal to NaN): one gather."""
        if self.group is None:
            return
        x = torch.tensor([[float(v) for v in values]], dtype=torch.float64,
                         device=self.device)
        every = self.gather(x)
        same = (every == x) | (torch.isnan(every) & torch.isnan(x))
        if not bool(same.all()):
            raise RuntimeError(f"the ranks disagree on {name}: "
                               f"{every.tolist()}")

    def gather(self, x):
        """Every rank's rows of ``x`` (each rank holding as many), in rank
        order: one all-reduce of a zero-padded buffer."""
        if self.group is None:
            return x
        dtype = x.dtype
        if not dtype.is_floating_point:    # exact below 2**53
            x = x.to(torch.float64)
        n = x.shape[0]
        buf = x.new_zeros((self.size * n,) + tuple(x.shape[1:]))
        buf[self.rank * n:(self.rank + 1) * n] = x
        return self.all_reduce_sum(buf).to(dtype)


def make_mesh(n_devices=None, devices=None, axis_name=BATCH_AXIS,
              device=None):
    """A 1-D mesh over the batch axis: every rank of the initialized
    process group, or one rank without one (or with ``n_devices=1``).
    This rank's device: ``device``, else ``devices[rank]`` (one
    ``torch.device`` per rank), else this process's current card, which
    raises without one (the CPU only when asked for).  Raises when
    ``n_devices`` exceeds the world."""
    if dist.is_available() and dist.is_initialized():
        world, rank, group = dist.get_world_size(), dist.get_rank(), \
            dist.group.WORLD
    else:
        world, rank, group = 1, 0, None
    if devices is not None and n_devices is None:
        n_devices = len(devices)
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"a mesh of {n} ranks needs {n} processes; the "
                         f"process group has {world}")
    if n == 1 and world > 1:
        rank, group = 0, None          # this process alone, unsharded
    elif n != world:
        raise ValueError(f"a mesh spans the whole process group ({world} "
                         f"ranks) or one rank, not {n}")
    if device is None and devices is not None:
        if len(devices) != n:
            raise ValueError(f"{len(devices)} devices for {n} ranks")
        device = devices[rank]
    elif device is None:
        default_device()                   # raises without a card
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group, rank, n, device, axis_name)


@dataclass(frozen=True)
class RowSharding:
    """The rows of a batch that a rank holds: its own (``batch``) or all
    of them (replicated).  ``rows(n)`` is the slice, ``sharding(x)`` the
    rows of ``x``."""
    mesh: Mesh
    batch: bool

    def rows(self, n):
        return self.mesh.rows(n) if self.batch else slice(0, int(n))

    def __call__(self, x):
        return x[self.rows(x.shape[0])]


def batch_sharding(mesh, axis_name=BATCH_AXIS):
    """This rank's rows of the batch axis."""
    return RowSharding(mesh, True)


def replicated_sharding(mesh):
    """Every row, on every rank."""
    return RowSharding(mesh, False)


def _map_rows(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_rows(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_rows(fn, v) for v in tree)
    if is_dataclass(tree):
        return type(tree)(**{f.name: _map_rows(fn, getattr(tree, f.name))
                             for f in fields(tree)})
    return tree


def shard_rollout_keys(x, mesh, axis_name=BATCH_AXIS):
    """This rank's rows of a whole-batch tensor, or of every tensor of a
    tree (dicts, tuples, dataclasses such as an EnvState): start states,
    action noise, reset draws.  ``x`` itself when ``mesh`` is None."""
    if mesh is None:
        return x
    sharding = batch_sharding(mesh, axis_name)
    return _map_rows(sharding, x)


# -- the collectives the layers above call (identities for mesh=None) ------

def all_reduce_sum(x, mesh):
    return x if mesh is None else mesh.all_reduce_sum(x)


def all_reduce_tree(tree, mesh, extra=None):
    """Sum over the ranks of every tensor of a dict (and of the 1-D tensor
    ``extra``, returned second when given), flattened into one buffer: one
    collective."""
    if mesh is None:
        return tree if extra is None else (tree, extra)
    keys = list(tree)
    parts = [tree[k].reshape(-1) for k in keys]
    if extra is not None:
        parts.append(extra.reshape(-1).to(parts[0].dtype))
    flat = all_reduce_sum(torch.cat(parts), mesh)
    out, i = {}, 0
    for k in keys:
        n = tree[k].numel()
        out[k] = flat[i:i + n].reshape(tree[k].shape)
        i += n
    return out if extra is None else (out, flat[i:])


def gather_rows(x, mesh):
    """Every rank's rows of ``x`` in rank order (``x`` for mesh=None)."""
    return x if mesh is None else mesh.gather(x)


def row_offset(n_local, mesh):
    """(first global row of this rank, global row count) of a batch split
    evenly over the ranks, each holding ``n_local`` rows."""
    if mesh is None:
        return 0, int(n_local)
    return mesh.rank * int(n_local), mesh.size * int(n_local)


def local_index(idx, lo, n_local):
    """Global row indices ``idx`` -> (indices into this rank's rows, 0/1
    weight of the rows this rank holds).  Rows of other ranks point at a
    row of this one with weight 0, so the shapes stay fixed and nothing
    waits on the host."""
    local = idx - lo
    own = (local >= 0) & (local < n_local)
    return torch.clamp(local, 0, max(int(n_local) - 1, 0)), own


def masked_mean_grad(terms, mask, params, mesh):
    """Gradient (a dict keyed like ``params``, leaves that require grad)
    of the mean of ``terms`` over the rows where ``mask`` is 1, of every
    rank: the gradient of this rank's sum and its count, all-reduced in one
    collective, then divided."""
    num = torch.sum(terms * mask)
    grads = torch.autograd.grad(num, list(params.values()))
    grads, den = all_reduce_tree(dict(zip(params, grads)), mesh,
                                 extra=torch.sum(mask).detach().reshape(1))
    den = torch.clamp(den[0], min=1.0)
    return {k: g / den for k, g in grads.items()}
