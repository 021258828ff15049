"""The Fisher-vector product's plain closed form (``ops/cuda_fvp.py``, what
``make_hvp`` runs on CPU tensors) against the JAX package's ``make_hvp``
(jvp of the KL's gradient) and against the double backward the port used
before, written here as the oracle (CPU, float64, numpy-seeded inputs).

Tolerance 1e-8 against JAX, as ``test_torch_npg.py`` holds the product;
1e-10 against the oracle, which computes the same Hessian by autograd (the
closed form drops only terms multiplied by an exact zero).  Non-identity
input and output transforms, and damping, in every case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjrl_tpu.algos import functional as jF
from mjrl_tpu.models import policies as jpol
from mjrl_tpu.models.fc_network import Transforms as JTransforms
from mjrl_tpu_torch import convert
from mjrl_tpu_torch.algos import functional as tF
from mjrl_tpu_torch.models import policies as tpol
from mjrl_tpu_torch.models.fc_network import make_transforms

from test_torch_policy import numpy_params, numpy_transforms, to_jax

OBS, ACT, N, DAMPING = 12, 4, 160, 1e-3
T64 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float64)


def double_backward(policy, params, transforms, obs, mask, damping):
    """The port's former product: the KL's first-order graph kept, each
    product a double backward (``retain_graph``)."""
    p = tF._leaf_params(params)
    with torch.enable_grad():
        kl = tF._local_share(tF._kl_terms(policy, p, tF._detach(params),
                                          transforms, obs), mask, None)
        grad_kl = torch.autograd.grad(kl, list(p.values()), create_graph=True)

    def hvp(v):
        with torch.enable_grad():
            gv = sum(torch.sum(g * v[k]) for g, k in zip(grad_kl, p))
            hv = torch.autograd.grad(gv, list(p.values()), retain_graph=True)
        return {k: h + damping * v[k] for k, h in zip(p, hv)}
    return hvp


CASES = [((), "tanh", False, 1.0), ((), "tanh", True, 1.0),
         ((16,), "tanh", False, 1.0), ((16,), "relu", True, 1.0),
         ((16,), "relu", False, 1.0), ((16,), "tanh", True, 1.0),
         ((8, 8), "tanh", False, 1.0), ((8, 8), "relu", True, 1.0),
         ((8, 8), "relu", False, 1.0), ((8, 8), "tanh", True, 1.0),
         ((8, 8), "tanh", True, 0.25), ((16,), "relu", False, 0.25)]


@pytest.mark.parametrize(
    "hidden, nonlinearity, masked, frac", CASES,
    ids=[f"{'-'.join(map(str, h)) or 'linear'}_{nl}"
         f"{'_masked' if m else ''}{'_frac%g' % f if f < 1 else ''}"
         for h, nl, m, f in CASES])
def test_closed_form_matches_jax_and_double_backward(hidden, nonlinearity,
                                                     masked, frac):
    """F v + damping v of depth 0, 1 and 2 policies, tanh and relu, masked
    or not, on all rows or on the ``hvp_sample_frac`` subset (the rows
    ``randperm`` of the generator picks, handed to JAX and the oracle)."""
    rng = np.random.RandomState(len(hidden) * 10 + masked)
    p_np = numpy_params(11 + len(hidden), hidden=hidden)
    t_np = numpy_transforms(12)
    v_np = numpy_params(13 + len(hidden), hidden=hidden)
    obs = rng.normal(size=(N, OBS))
    mask = (rng.uniform(size=N) > 0.25).astype(np.float64) if masked \
        else None
    tcfg = tpol.GaussianMLP(OBS, ACT, hidden, nonlinearity=nonlinearity,
                            dtype=torch.float64, device="cpu")
    tparams = convert.params_from_numpy(p_np, torch.float64, "cpu")
    ttr = make_transforms(OBS, ACT, *t_np, dtype=torch.float64, device="cpu")
    v = convert.params_from_numpy(v_np, torch.float64, "cpu")
    gen = torch.Generator().manual_seed(5) if frac < 1 else None
    got = tF.make_hvp(tcfg, tparams, ttr, T64(obs),
                      None if mask is None else T64(mask), DAMPING, gen,
                      frac)(v)
    if frac < 1:
        idx = torch.randperm(N, generator=torch.Generator().manual_seed(5))
        idx = idx[:max(1, int(N * frac))].numpy()
        obs, mask = obs[idx], None if mask is None else mask[idx]
    want = double_backward(tcfg, tparams, ttr, T64(obs),
                           None if mask is None else T64(mask),
                           DAMPING)(v)
    for k in tparams:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-10, atol=1e-10)
    jcfg = jpol.GaussianMLP(OBS, ACT, hidden, nonlinearity=nonlinearity)
    hv_j = jF.make_hvp(jcfg, to_jax(p_np), JTransforms(*to_jax(list(t_np))),
                       jnp.asarray(obs),
                       None if mask is None else jnp.asarray(mask),
                       damping=DAMPING)(to_jax(v_np))
    ours = convert.params_to_numpy(got)
    for lt, lj in zip(ours["layers"], hv_j["layers"]):
        np.testing.assert_allclose(lt["w"], np.asarray(lj["w"]), rtol=1e-8,
                                   atol=1e-8)
        np.testing.assert_allclose(lt["b"], np.asarray(lj["b"]), rtol=1e-8,
                                   atol=1e-8)
    np.testing.assert_allclose(ours["log_std"], np.asarray(hv_j["log_std"]),
                               rtol=1e-8, atol=1e-8)
