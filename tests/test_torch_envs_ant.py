"""Port vs JAX package: Ant-v3 (CPU, float64).

- Two control steps from the MuJoCo golden contact states against the JAX
  env's vmapped ``step`` at 1e-9, at the default implicit solver (25
  condim-3 slots, four pyramidal facets each, the rows rebuilt at every
  RK4 stage) and on the penalty path.
- Specs of every new registry id; the JAX envs' reset draws injected into
  the port give the same observations at 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.envs.gym_suite import AntEnv as JaxAnt
from mjrl_tpu.envs.peg_insertion import PegEnv as JaxPeg
from mjrl_tpu_torch import envs as tenvs
from mjrl_tpu_torch.envs.gym_suite import AntEnv
from mjrl_tpu_torch.envs.peg_insertion import PegEnv

from test_torch_envs_contact import B, compare_steps, step_both
from test_torch_mjcf_m9b import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("solver", ["newton", "penalty"])
def test_ant_control_steps_match_jax(solver):
    jenv = JaxAnt(dtype=jnp.float64, solver=solver)
    tenv = AntEnv(dtype=torch.float64, device="cpu", solver=solver)
    m = tenv.model
    assert tenv._planar is None and m.nv == 14
    assert (m.solver, m.row_freeze_step, m.contact_topk) == (
        int(solver == "newton"), False, 0)
    compare_steps(f"ant {solver}", step_both(jenv, tenv, "ant", {}))


def test_specs_registry_and_injected_resets():
    for env_id, spec in (("mjrl_peg_insertion-v0", (20, 7, 50)),
                         ("Ant-v3", (27, 8, 1000)), ("Ant-v4", (27, 8, 1000)),
                         ("Humanoid-v3", (45, 17, 1000)),
                         ("Humanoid-v4", (45, 17, 1000))):
        env = tenvs.make(env_id, device="cpu")
        assert tuple(env.spec.__dict__.values()) == spec, env_id
    for jcls, tcls in ((JaxPeg, PegEnv), (JaxAnt, AntEnv)):
        jenv, tenv = jcls(dtype=jnp.float64), tcls(dtype=torch.float64,
                                                   device="cpu")
        js = jax.jit(jax.vmap(jenv.reset))(
            jax.random.split(jax.random.PRNGKey(3), B))
        sc = {k: np.asarray(x) for k, x in js.scenery.items()}
        ts = tenv.state_from_qpos_qvel(np.asarray(js.physics.qpos),
                                       np.asarray(js.physics.qvel), sc)
        np.testing.assert_allclose(ts.obs.numpy(), np.asarray(js.obs),
                                   rtol=1e-12, atol=1e-12)
