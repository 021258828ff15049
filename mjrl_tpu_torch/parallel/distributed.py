"""Multi-process data parallelism through ``torch.distributed``
(counterpart of ``mjrl_tpu/parallel/distributed.py``).

The JAX package brings up ``jax.distributed`` and lets GSPMD insert the
cross-host reductions.  The port starts one process per rank (one per
card), joins them in a process group, and issues the reductions itself
(``parallel/mesh.py``).  Single-process use is the default: every helper
reduces nothing when no process group was initialized.

A launch on every card of one host, the same script in every process,
through PyTorch's own launcher (the port's counterpart of JAX seeing every
local chip in one process)::

    torchrun --standalone --nproc-per-node R train.py

    from mjrl_tpu_torch.parallel import distributed as dist
    dist.initialize()                    # env-driven; no-op without the vars
    mesh = dist.global_mesh()            # every rank of the group
    agent = NPG(..., mesh=mesh)          # each rank rolls out B / R rows
    train_agent(job, agent, ...)         # rank 0 writes the job directory

or, without ``torchrun``, ``MJRL_COORDINATOR=localhost:29500
MJRL_NUM_PROCS=R MJRL_PROC_ID=<r> python train.py`` in each process.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as tdist

from mjrl_tpu_torch.device import default_device
from mjrl_tpu_torch.parallel.mesh import BATCH_AXIS, all_reduce_sum, \
    make_mesh

DEFAULT_TIMEOUT_S = 300


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_ids=None, backend=None,
               timeout=DEFAULT_TIMEOUT_S, device=None):
    """Join the process group from arguments or the environment.

    The environment, where an argument is not given:
      MJRL_COORDINATOR  host:port of rank 0
      MJRL_NUM_PROCS    number of processes (ranks)
      MJRL_PROC_ID      this process's rank
    or, without MJRL_COORDINATOR, what ``torchrun`` sets: MASTER_ADDR and
    MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK.

    No-op returning False when no address is given; True once the group
    is up.  ``device``: None binds this process's card as its current
    device (``local_device_ids[0]``, else LOCAL_RANK, else the rank modulo
    the cards), and raises without one; ``"cpu"`` binds none.  Call it
    before anything touches CUDA: the port's bare ``"cuda"`` devices and
    generators then name this card.  ``backend``: NCCL on a card, gloo on
    the CPU; gloo over CUDA tensors only when asked for (ranks sharing one
    card, which NCCL refuses).  ``timeout``: seconds a collective may wait
    before it fails."""
    if tdist.is_initialized():
        return True
    env = os.environ
    address = coordinator_address or env.get("MJRL_COORDINATOR")
    if address is not None:
        init_method = f"tcp://{address}"
        num_processes = env["MJRL_NUM_PROCS"] if num_processes is None \
            else num_processes
        process_id = env["MJRL_PROC_ID"] if process_id is None \
            else process_id
    elif "MASTER_ADDR" in env and "MASTER_PORT" in env:
        init_method = "env://"             # torchrun's store, where it has one
        num_processes = env["WORLD_SIZE"] if num_processes is None \
            else num_processes
        process_id = env["RANK"] if process_id is None else process_id
    else:
        return False
    num_processes, process_id = int(num_processes), int(process_id)
    if device is None:
        default_device()                   # raises without a card
        if local_device_ids:
            card = local_device_ids[0]
        elif "LOCAL_RANK" in env:
            card = int(env["LOCAL_RANK"])
        else:
            card = process_id % torch.cuda.device_count()
        device = torch.device("cuda", card)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    tdist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout))
    return True


def is_distributed():
    return tdist.is_initialized() and tdist.get_world_size() > 1


def global_mesh(axis_name=BATCH_AXIS, device=None):
    """1-D mesh over every rank of the process group, this rank on
    ``device`` (default: its current card; ``"cpu"`` when asked for)."""
    return make_mesh(axis_name=axis_name, device=device)


class HostSharded:
    """A globally batched array of which this rank holds its own rows
    (every rank as many): ``local`` (local_n, ...), ``shape`` the global
    shape (R * local_n, ...)."""

    def __init__(self, mesh, local):
        self.mesh, self.local = mesh, local

    @property
    def shape(self):
        return (self.mesh.size * self.local.shape[0],) \
            + tuple(self.local.shape[1:])

    def sum(self):
        """Sum of every element over all ranks: one all-reduce."""
        return all_reduce_sum(self.local.sum(), self.mesh)

    def gather(self):
        """The whole array, on every rank."""
        return self.mesh.gather(self.local)


def host_sharded(mesh, local_array, axis_name=BATCH_AXIS):
    """This rank's rows (local_n, ...) of a globally batched array, as a
    tensor on the mesh's device, with the global shape known."""
    local = torch.as_tensor(np.asarray(local_array), device=mesh.device)
    return HostSharded(mesh, local)


def all_hosts_mean(mesh, local_scalar):
    """Mean over the ranks of a float (logging, metrics): one
    all-reduce."""
    x = torch.tensor([float(local_scalar)], dtype=torch.float64,
                     device=mesh.device)
    return float(all_reduce_sum(x, mesh)[0]) / mesh.size


class HostShardedBuffer:
    """FIFO replay buffer whose storage lives per rank (the MBRL real-data
    buffer, sharded over processes).

    Each rank appends only the paths IT collected; ``global_batch`` draws
    a minibatch of this rank's data, so a fit that all-reduces its
    gradients sees the union of all ranks' data without any rank holding
    all of it."""

    def __init__(self, max_steps, seed=0):
        self.max_steps = int(max_steps)
        self._data = {}
        self._rng = np.random.RandomState(seed)

    def add_paths(self, paths):
        cols = {}
        for p in paths:
            s, a = np.asarray(p["observations"]), np.asarray(p["actions"])
            cols.setdefault("s", []).append(s[:-1])
            cols.setdefault("a", []).append(a[:-1])
            cols.setdefault("sp", []).append(s[1:])
            if "rewards" in p:
                cols.setdefault("r", []).append(
                    np.asarray(p["rewards"])[:-1])
        for k, v in cols.items():
            new = np.concatenate(v)
            old = self._data.get(k)
            cat = new if old is None else np.concatenate([old, new])
            self._data[k] = cat[-self.max_steps:]

    @property
    def local_steps(self):
        return 0 if not self._data else len(next(iter(self._data.values())))

    def local_batch(self, n):
        idx = self._rng.randint(0, max(self.local_steps, 1), size=n)
        return {k: v[idx] for k, v in self._data.items()}

    def global_batch(self, mesh, per_host_n):
        """{name: HostSharded of global shape (R * per_host_n, ...)}."""
        local = self.local_batch(per_host_n)
        return {k: host_sharded(mesh, v) for k, v in local.items()}
