"""Port vs JAX package: the planar whole-control-step function.

``mjrl_tpu_torch.physics.planar.step_n_arrays`` is the plain PyTorch version
of the CUDA kernel; ``ops.cuda_planar.cuda_step_n_batched`` takes it for CPU
tensors.  Both are held to the JAX package's ``step_n_arrays`` (float64,
``jax.vmap`` over the batch — the reference the Pallas kernel itself is
tested against, never the Pallas call) at rtol = atol = 1e-10: the two are
the same arithmetic in the same order, so only last-digit differences of
the elementary functions remain.

Limit-active states are generated OFF the limit boundary (0.1..0.5 rad past
the +-1.5 stops): exactly on a stop the branch ``below >= above`` could
legitimately differ between implementations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.envs.assets import swimmer_model as jax_swimmer_model
from mjrl_tpu.physics import planar as jplanar
from mjrl_tpu_torch.envs.assets import swimmer_model
from mjrl_tpu_torch.ops import cuda_planar
from mjrl_tpu_torch.physics import planar as tplanar
from mjrl_tpu_torch.physics.model import RK4

from test_torch_kernel_host import STATES, limit_active_states, random_states

TOL = 1e-10


@pytest.fixture(scope="module")
def params():
    pj = jplanar.extract_planar(
        jax_swimmer_model().finalize(jnp.float64, solver="newton"))
    pt = tplanar.extract_planar(swimmer_model(solver="newton"))
    return pj, pt


@pytest.fixture(scope="module")
def jax_step(params):
    """One jitted JAX reference per substep count; every state set has 60
    rows, so each is compiled once."""
    pj, _ = params
    fns = {}

    def get(n):
        if n not in fns:
            fns[n] = jax.jit(jax.vmap(
                lambda q, v, u: jplanar.step_n_arrays(pj, q, v, u, n)))
        return fns[n]
    return get


@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("name", list(STATES))
def test_step_n_arrays_matches_jax(params, jax_step, name, n):
    """step_n_arrays (float64) vs the JAX reference at 1e-10."""
    _, pt = params
    q, v, u = (np.asarray(a, np.float64) for a in STATES[name]())
    rq, rv = jax_step(n)(q, v, u)
    gq, gv = tplanar.step_n_arrays(pt, torch.tensor(q), torch.tensor(v),
                                   torch.tensor(u), n)
    assert gq.dtype == torch.float64 and tuple(gq.shape) == q.shape
    np.testing.assert_allclose(gq.numpy(), np.asarray(rq), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=TOL,
                               atol=TOL)


def test_limit_active_states_engage_the_limit_solver(params):
    """The limit-active set really exercises the joint-limit dual: with the
    limits switched off the same states step elsewhere."""
    _, pt = params
    q, v, u = (torch.tensor(a) for a in limit_active_states())
    free = pt._replace(limited=(0.0,) * 7)
    _, v_lim = tplanar.step_n_arrays(pt, q, v, u, 1)
    _, v_free = tplanar.step_n_arrays(free, q, v, u, 1)
    assert (v_lim - v_free).abs().max() > 1.0


def test_wrapper_takes_plain_version_for_cpu_tensors(params):
    """cuda_step_n_batched on CPU tensors = step_n_arrays exactly (0.0),
    and counts no kernel launch."""
    _, pt = params
    q, v, u = (torch.tensor(a) for a in random_states(8))
    before = cuda_planar.launch_count
    gq, gv = cuda_planar.cuda_step_n_batched(pt, q, v, u, 5)
    rq, rv = tplanar.step_n_arrays(pt, q, v, u, 5)
    assert torch.equal(gq, rq) and torch.equal(gv, rv)
    assert cuda_planar.launch_count == before


def test_float32_plain_version_close_to_float64(params):
    """The float32 plain version stays within the kernel's float32 bounds
    (q 2e-5, v 2e-4) of the float64 one on the random states."""
    _, pt = params
    q, v, u = (torch.tensor(a) for a in random_states(32))
    rq, rv = tplanar.step_n_arrays(pt, q, v, u, 5)
    gq, gv = tplanar.step_n_arrays(pt, q.float(), v.float(), u.float(), 5)
    assert gq.dtype == torch.float32
    np.testing.assert_allclose(gq.double().numpy(), rq.numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(gv.double().numpy(), rv.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_contact_and_rk4_models_not_ported(params):
    _, pt = params
    q, v, u = (torch.tensor(a) for a in random_states(2))
    with pytest.raises(NotImplementedError, match="K2"):
        tplanar.step_n_arrays(pt._replace(integrator=RK4), q, v, u, 1)
    with pytest.raises(NotImplementedError, match="K2"):
        cuda_planar.emit_model_header(pt._replace(integrator=RK4))


def test_kernel_needs_nvcc_and_says_so(params, monkeypatch):
    """Asking for the CUDA build where there is no nvcc raises; nothing
    falls back to the plain version."""
    _, pt = params
    monkeypatch.setattr(cuda_planar, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_planar, "BUILD_DIR",
                        cuda_planar.BUILD_DIR + "_absent")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_planar.build_kernel(pt)


def test_model_header_bakes_the_model_in(params):
    """The generated traits header carries the sizes and constants of the
    PlanarParams it was made from, and changes with them."""
    _, pt = params
    h = cuda_planar.emit_model_header(pt)
    assert "NV = 7, NB = 5, NU = 4, NL = 4" in h
    assert "PGS_SWEEPS = 12" in h and "H = 0.005" in h
    assert "HAS_FLUID = true" in h and "HAS_DAMPING = false" in h
    assert repr(float(pt.invweight0[3])) in h
    other = cuda_planar.emit_model_header(pt._replace(timestep=0.004))
    assert other != h
