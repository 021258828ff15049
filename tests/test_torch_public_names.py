"""Port vs JAX package: public names of the JAX package's modules that the
port's matching modules carry as thin wrappers (CPU, float64).

- ``physics/dynamics.py``: ``body_spatial_inertias``, ``mass_matrix`` and
  ``bias_force`` on numpy-seeded reacher and Ant states, at 1e-10 relative
  to each quantity's largest entry;
- ``models/fc_network.py::init_linear``: the JAX layer's layout and shapes,
  nn.Linear's bounds (the streams differ, so the draws are not compared);
- ``native.available``: the library builds and loads here, as the JAX
  package's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu import native as jnative
from mjrl_tpu.envs import assets as jassets
from mjrl_tpu.envs.gym_suite import AntEnv as JaxAnt
from mjrl_tpu.models import fc_network as jfc
from mjrl_tpu.physics import dynamics as jdyn
from mjrl_tpu.physics.kinematics import fwd_kinematics as jax_fk
from mjrl_tpu_torch import native
from mjrl_tpu_torch.envs import assets as tassets
from mjrl_tpu_torch.envs.gym_suite import AntEnv
from mjrl_tpu_torch.models import fc_network as tfc
from mjrl_tpu_torch.physics import dynamics as dyn
from mjrl_tpu_torch.physics.kinematics import fwd_kinematics

REL, N = 1e-10, 6


def _ant_states(rng, model):
    q = np.asarray(model.qpos0) + rng.uniform(-0.4, 0.4, (N, model.nq))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    return q


MODELS = {
    "reacher": (lambda: jassets.reacher_model().finalize(jnp.float64),
                lambda: tassets.reacher_model(solver="penalty"),
                lambda rng, m: rng.uniform(-2.4, 1.8, (N, 7))),
    "ant": (lambda: JaxAnt(dtype=jnp.float64).model,
            lambda: AntEnv(dtype=torch.float64, device="cpu").model,
            _ant_states),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def terms(request):
    jbuild, tbuild, qdraw = MODELS[request.param]
    jm, tm = jbuild(), tbuild()
    rng = np.random.RandomState(5)
    q = qdraw(rng, tm)
    v = rng.uniform(-3, 3, (N, tm.nv))

    def jax_terms(q, v):
        d = jax_fk(jm, q)
        cdof = jdyn.compute_cdof(jm, d)
        cvel, cdd = jdyn.compute_velocities(jm, d, cdof, v)
        return dict(inertias=jdyn.body_spatial_inertias(jm, d),
                    M=jdyn.mass_matrix(jm, d, cdof),
                    bias=jdyn.bias_force(jm, d, cdof, cvel, cdd, v))

    want = jax.jit(jax.vmap(jax_terms))(jnp.asarray(q), jnp.asarray(v))
    tq, tv = torch.tensor(q), torch.tensor(v)
    d = fwd_kinematics(tm, tq)
    cdof = dyn.compute_cdof(tm, d)
    cvel, cdd = dyn.compute_velocities(tm, d, cdof, tv)
    got = dict(inertias=dyn.body_spatial_inertias(tm, d),
               M=dyn.mass_matrix(tm, d, cdof),
               bias=dyn.bias_force(tm, d, cdof, cvel, cdd, tv))
    # the wrappers agree with the hot path they wrap
    m, bias = dyn.mass_and_bias(tm, d, cdof, cvel, cdd, tv)
    assert torch.equal(got["M"], m) and torch.equal(got["bias"], bias)
    return want, got


@pytest.mark.parametrize("quantity", ["inertias", "M", "bias"])
def test_dynamics_names_match_jax(terms, quantity):
    want, got = terms
    w, g = np.asarray(want[quantity]), got[quantity].numpy()
    assert g.shape == w.shape
    scale = max(np.abs(w).max(), 1e-300)
    np.testing.assert_allclose(g, w, rtol=REL, atol=REL * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_init_linear_layout_and_bounds_match_jax(dtype):
    jl = jfc.init_linear(jax.random.PRNGKey(0), 50, 40)
    tl = tfc.init_linear(torch.Generator().manual_seed(0), 50, 40, dtype)
    assert set(tl) == set(jl) == {"w", "b"}
    for k in jl:
        assert tuple(tl[k].shape) == tuple(jl[k].shape)
        assert tl[k].dtype == dtype
    k = 1.0 / np.sqrt(50)
    assert float(tl["w"].abs().max()) <= k
    assert float(tl["w"].abs().max()) > 0.95 * k     # 2000 draws span it
    assert abs(float(np.abs(np.asarray(jl["w"])).max())
               - float(tl["w"].abs().max())) < 0.05 * k
    again = tfc.init_linear(torch.Generator().manual_seed(0), 50, 40, dtype)
    assert torch.equal(again["w"], tl["w"])
    assert torch.equal(again["b"], tl["b"])


def test_native_available():
    assert native.available() is True
    assert native.available() == jnative.available()
