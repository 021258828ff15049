"""Structured checkpointing of an agent's whole training state
(counterpart of ``mjrl_tpu/utils/checkpoint.py``).

The pickle-per-object path of ``utils/train_agent.py`` stays; this module
writes one file holding everything a training run needs to resume where it
stopped: the policy's parameters (new and old) and transforms, the
baseline's state, the optimizer state where the agent has one, the
agent's generator state (the JAX package's ``rng_key``), the running
score and the iteration:

    save_agent_checkpoint(dir, agent, iteration)     # dir/state_<i>.pt
    iteration = restore_agent_checkpoint(dir, agent)

Tensors are stored on the CPU (``torch.save``) and restored to the
agent's device: under a mesh (``agent.mesh``) rank 0 alone writes, every
rank waits for it, and each rank restores onto its own card.  A baseline
that owns a generator (``MLPBaseline``: its fits draw their permutations
from it) also stores that generator's state, so that a resumed run draws
what the uninterrupted one would have.

``enable_compilation_cache()`` has no XLA cache to configure: it returns
the directory where the port keeps the kernels it builds (nvcc and g++,
built once per machine and source).
"""

import os
import tempfile

import numpy as np
import torch

from mjrl_tpu_torch.device import set_generator_state
from mjrl_tpu_torch.models.fc_network import Transforms
from mjrl_tpu_torch.ops.cuda_planar import BUILD_DIR
from mjrl_tpu_torch.ops.flat import tree_to


def enable_compilation_cache():
    """-> the directory of the port's built kernels."""
    return BUILD_DIR


def _agent_state(agent, iteration):
    policy = agent.policy
    state = dict(
        policy_params=tree_to(policy.params, "cpu"),
        policy_old_params=tree_to(policy.old_params, "cpu"),
        policy_transforms=tuple(t.detach().cpu() for t in policy.transforms),
        baseline_state=tree_to(agent.baseline.state, "cpu"),
        generator_state=agent.generator.get_state(),
        running_score=float(agent.running_score
                            if agent.running_score is not None else np.nan),
        iteration=int(iteration),
    )
    if hasattr(agent.baseline, "generator"):
        state["baseline_generator_state"] = \
            agent.baseline.generator.get_state()
    if hasattr(agent, "opt_state"):
        state["opt_state"] = tree_to(agent.opt_state, "cpu")
    return state


def save_agent_checkpoint(ckpt_dir, agent, iteration):
    """Write ``ckpt_dir/state_<iteration>.pt`` (rank 0 of a mesh; every
    rank returns once it is written) -> the directory."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    mesh = getattr(agent, "mesh", None)
    if mesh is None or mesh.rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".pt.tmp")
        os.close(fd)
        try:
            torch.save(_agent_state(agent, iteration), tmp)
            os.replace(tmp, os.path.join(ckpt_dir, f"state_{iteration}.pt"))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if mesh is not None:
        mesh.barrier()
    return ckpt_dir


def latest_checkpoint(ckpt_dir):
    """The largest iteration with a ``state_<i>.pt`` in ``ckpt_dir``, or
    None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        stem, ext = os.path.splitext(name)
        if name.startswith("state_") and ext == ".pt":
            try:
                steps.append(int(stem.split("_")[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore_agent_checkpoint(ckpt_dir, agent, iteration=None):
    """Restore in place onto the agent's device (under a mesh, this rank's
    card); returns the checkpoint's iteration (or None when there is no
    checkpoint).  A generator state saved from another kind of device
    raises."""
    iteration = latest_checkpoint(ckpt_dir) if iteration is None \
        else iteration
    if iteration is None:
        return None
    state = torch.load(
        os.path.join(os.path.abspath(ckpt_dir), f"state_{iteration}.pt"),
        map_location="cpu", weights_only=True)
    mesh = getattr(agent, "mesh", None)
    dev = agent.device if mesh is None else mesh.device
    agent.policy.params = tree_to(state["policy_params"], dev)
    agent.policy.old_params = tree_to(state["policy_old_params"], dev)
    agent.policy.transforms = Transforms(
        *(t.to(dev) for t in state["policy_transforms"]))
    agent.baseline.state = tree_to(state["baseline_state"], dev)
    set_generator_state(agent.generator, state["generator_state"])
    if "baseline_generator_state" in state:
        set_generator_state(agent.baseline.generator,
                            state["baseline_generator_state"])
    rs = float(state["running_score"])
    agent.running_score = None if np.isnan(rs) else rs
    if "opt_state" in state and hasattr(agent, "opt_state"):
        agent.opt_state = tree_to(state["opt_state"], dev)
    return int(state["iteration"])
