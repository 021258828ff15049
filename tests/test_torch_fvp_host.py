"""The Fisher-vector product kernel's arithmetic (K3, ``csrc/fvp_body.cuh``)
compiled for the host with g++ behind ``csrc/fvp_host.cpp`` and held to the
plain closed form ``ops/cuda_fvp.py::fvp_plain``.

The harness runs one block's work in plain loops: the tile load, every
thread's steps of the forward, tangent and backward, every thread's outer
products, tile after tile, and the reduction, at the rows a tile, threads a
row and rows a thread the kernel is built with.  Float64 at 1e-12 of the
largest entry (the same products, summed in another order); float32 at
1e-5, the rounding of sums over a few hundred rows.  Batches that end
inside a tile, masks with zeros, non-identity transforms, depth 0 to 3,
widths up to 64 rising and falling, tanh and relu.

The launch, the layout and the device build are checked on the card by
``chip_smoke.py`` and by the ``gpu``-marked test below.  This file imports
nothing of JAX, so that test also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_fvp_host.py -m gpu
"""

import shutil

import pytest
import torch

from mjrl_tpu_torch.ops import cuda_fvp

SHAPES = [((12, 4), False), ((12, 16, 4), True), ((12, 8, 8, 4), False),
          ((11, 32, 32, 3), False), ((12, 64, 64, 4), True),
          ((5, 8, 16, 3), False), ((7, 64, 32, 5), True),
          ((9, 6, 7, 5, 2), False)]


def problem(shape, n, dtype, seed, masked=True):
    """Random inputs of ``fvp_plain`` for ``shape``: flat parameters and
    direction, transforms, coefficients, observations and a mask."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, dtype=torch.float64)
    lay = cuda_fvp.layout(shape)
    d, a = shape.sizes[0], shape.sizes[-1]
    theta = 0.5 * rn(lay["P"])
    args = [theta, rn(lay["P"]), 0.3 * rn(d), 0.5 + rn(d).abs(),
            0.1 + rn(a).abs(), 0.1 + rn(a).abs(), 2.0 * rn(n, d),
            (torch.rand(n, generator=g, dtype=torch.float64) > 0.2).double()
            if masked else None]
    return [None if x is None else x.to(dtype) for x in args]


@pytest.mark.parametrize("sizes, relu", SHAPES,
                         ids=["-".join(map(str, s)) + ("_relu" if r else "")
                              for s, r in SHAPES])
def test_host_body_matches_plain_version(sizes, relu):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    shape = cuda_fvp.FvpShape(sizes, relu)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for n, masked in ((301, True), (128, False)):
            args = problem(shape, n, dtype, n)
            args[-1] = args[-1] if masked else None
            want = cuda_fvp.fvp_plain(shape, *args)
            got = cuda_fvp.fvp_host(shape, *args, rows=128)
            gap = float((got.double() - want.double()).abs().max()
                        / want.double().abs().max())
            assert gap <= tol, (dtype, n, masked, gap)


def test_one_place_decides_kernel_or_plain():
    """``kernel_rows`` takes widths up to 64 in float32 and float64 within
    the shared memory of a block; everything else, and every CPU tensor,
    takes the plain closed form."""
    f32, f64 = torch.float32, torch.float64
    cell = cuda_fvp.FvpShape((12, 32, 32, 4), False)
    assert cuda_fvp.kernel_rows(cell, f32) == 128
    assert cuda_fvp.kernel_rows(cuda_fvp.FvpShape((12, 64, 64, 4), True),
                                f64) is not None
    assert cuda_fvp.kernel_rows(cell, torch.float16) is None
    assert cuda_fvp.kernel_rows(cuda_fvp.FvpShape((376, 64, 64, 17), False),
                                f32) is None
    assert cuda_fvp.kernel_rows(cuda_fvp.FvpShape((12, 65, 4), False),
                                f32) is None
    for sizes, relu in SHAPES:
        shape = cuda_fvp.FvpShape(sizes, relu)
        for dt in (f32, f64):
            rows = cuda_fvp.kernel_rows(shape, dt)
            assert rows in cuda_fvp.ROW_CHOICES
            assert cuda_fvp.smem_bytes(shape, rows, dt.itemsize) \
                <= cuda_fvp.SMEM_BYTES
    params = {"layers.0.weight": torch.zeros(32, 12),
              "layers.0.bias": torch.zeros(32),
              "layers.1.weight": torch.zeros(4, 32),
              "layers.1.bias": torch.zeros(4), "log_std": torch.zeros(4)}
    assert cuda_fvp.shape_of(params, "tanh") == cuda_fvp.FvpShape(
        (12, 32, 4), False)
    tr = [torch.zeros(12), torch.ones(12), torch.zeros(4), torch.ones(4)]
    from mjrl_tpu_torch.models.fc_network import Transforms
    fv = cuda_fvp.FisherVectorProduct(params, "relu", Transforms(*tr),
                                      torch.zeros(5, 12), None,
                                      torch.tensor(5.0), torch.tensor(5.0))
    assert not fv.use_kernel and fv.shape.relu


def test_make_hvp_keeps_no_graph_and_launches_nothing_on_cpu():
    """On CPU tensors ``make_hvp`` runs the plain closed form: no kernel
    launch, no autograd graph behind the product, the same product with
    autograd on or off, and F v + damping v in the parameters' layout."""
    from mjrl_tpu_torch.algos import functional as F
    from mjrl_tpu_torch.models.policies import GaussianMLP
    g = torch.Generator().manual_seed(0)
    pol = GaussianMLP(6, 2, (8, 8), dtype=torch.float64, device="cpu")
    params, tr = pol.init(g)
    obs = torch.randn(50, 6, generator=g, dtype=torch.float64)
    v = {k: torch.randn(x.shape, generator=g, dtype=torch.float64)
         for k, x in params.items()}
    before = dict(cuda_fvp.launch_counts)
    hvp = F.make_hvp(pol, params, tr, obs, damping=0.5)
    out = hvp(v)
    with torch.enable_grad():
        again = hvp({k: x.requires_grad_(True) for k, x in v.items()})
    assert cuda_fvp.launch_counts == before
    assert list(out) == list(params)
    for k in params:
        assert out[k].shape == params[k].shape
        assert out[k].grad_fn is None and again[k].grad_fn is None
        torch.testing.assert_close(out[k], again[k], rtol=0, atol=0)
    # log_std's block: (F v)_ls = 4t(2t - 1e-8) / (2t + 1e-8)^2 v_ls, ~2 v_ls
    t = torch.exp(params["log_std"]) ** 2
    want = 4 * t * (2 * t - 1e-8) / (2 * t + 1e-8) ** 2 * v["log_std"]
    torch.testing.assert_close(out["log_std"] - 0.5 * v["log_std"], want)


@pytest.mark.gpu
@pytest.mark.parametrize("sizes, relu", SHAPES[:5],
                         ids=["-".join(map(str, s)) + ("_relu" if r else "")
                              for s, r in SHAPES[:5]])
def test_cuda_kernel_matches_plain_version_on_the_card(sizes, relu):
    """The kernel itself on a GPU against the plain version on the same
    card: float64 at 1e-12, float32 at 1e-5 of the largest entry, one
    launch counted per product, and a refusal of a non-contiguous input."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    shape = cuda_fvp.FvpShape(sizes, relu)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        args = [None if x is None else x.cuda()
                for x in problem(shape, 100_003, dtype, 7)]
        before = cuda_fvp.launch_counts[cuda_fvp.KERNEL]
        got = cuda_fvp.fvp_cuda(shape, *args)
        torch.cuda.synchronize()
        assert cuda_fvp.launch_counts[cuda_fvp.KERNEL] == before + 1
        want = cuda_fvp.fvp_plain(*[shape] + [None if x is None else x.double()
                                              for x in args])
        gap = float((got.double() - want).abs().max() / want.abs().max())
        assert gap <= tol, (dtype, gap)
        obs = args[6]
        args[6] = torch.cat([obs, obs], 1)[:, ::2]
        with pytest.raises(ValueError, match="contiguous"):
            cuda_fvp.fvp_cuda(shape, *args)
