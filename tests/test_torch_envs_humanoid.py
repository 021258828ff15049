"""Port vs JAX package: Humanoid-v3 (CPU, float64), and the copied MJCF
files.

- Two control steps from the MuJoCo golden contact states against the JAX
  env's vmapped ``step`` at 1e-9: 111 condim-1 slots capped at 64 rows,
  29 condim-3 slots with four facets each, two fixed-tendon rows, the
  rows rebuilt at every RK4 stage.
- ``envs/mjcf/{ant,humanoid}.xml`` are byte-identical to the installed
  gymnasium's (skipped where gymnasium is absent).
"""

import os

import jax.numpy as jnp
import pytest
import torch

from mjrl_tpu.envs.gym_suite import HumanoidEnv as JaxHumanoid
from mjrl_tpu_torch.envs.gym_suite import HumanoidEnv

from test_torch_collision3d import MJCF
from test_torch_envs_contact import compare_steps, step_both
from test_torch_mjcf_m9b import one_torch_thread  # noqa: F401


def test_humanoid_control_steps_match_jax():
    jenv = JaxHumanoid(dtype=jnp.float64)
    tenv = HumanoidEnv(dtype=torch.float64, device="cpu")
    m = tenv.model
    assert tenv._planar is None and (m.nv, m.ntendon) == (23, 2)
    assert (m.solver, m.row_freeze_step, m.contact_topk) == (1, False, 64)
    compare_steps("humanoid", step_both(jenv, tenv, "humanoid", {}))


@pytest.mark.parametrize("name", ["ant", "humanoid"])
def test_mjcf_copies_are_gymnasiums(name):
    gymnasium = pytest.importorskip("gymnasium")
    src = os.path.join(os.path.dirname(gymnasium.__file__), "envs",
                       "mujoco", "assets", f"{name}.xml")
    with open(src, "rb") as a, open(os.path.join(MJCF, f"{name}.xml"),
                                     "rb") as b:
        assert a.read() == b.read()
