"""Port vs JAX package: the native path ops and the host-side sample
processing (CPU).

``mjrl_tpu_torch.native`` (its own copy of ``pathops.cpp``, built with g++
into ``mjrl_tpu_torch/_build/``) against ``mjrl_tpu.native`` and against
the port's plain numpy loops, on ragged lists that include paths of length
1 and 0.  ``pack_paths`` copies floats, so it is held exactly; the sums and
GAE run the same double-precision recurrences in both, held at 1e-12.
``utils/process_samples.py`` against ``mjrl_tpu.utils.process_samples``
at 1e-12.
"""

import numpy as np
import pytest

from mjrl_tpu import native as jnative
from mjrl_tpu.utils import process_samples as jps
from mjrl_tpu_torch import native
from mjrl_tpu_torch.utils import process_samples as tps

TOL = 1e-12
LENGTHS = [5, 1, 0, 7, 1, 3]


def ragged(seed, dim=None):
    rng = np.random.RandomState(seed)
    shape = (lambda n: (n,)) if dim is None else (lambda n: (n, dim))
    return [rng.normal(size=shape(n)) for n in LENGTHS]


def assert_lists(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def test_native_builds_into_the_build_dir():
    so = native.build()
    assert so.endswith("libpathops.so") and "_build" in so
    assert native.build() == so                 # found, not rebuilt


@pytest.mark.parametrize("dim,max_len", [(3, None), (1, None), (4, 4)])
def test_pack_paths_matches_jax_and_plain(dim, max_len):
    arrays = ragged(0, dim)
    out, mask = native.pack_paths(arrays, max_len)
    for ref in (native.pack_paths_plain(arrays, max_len),
                jnative.pack_paths(arrays, max_len)):
        np.testing.assert_array_equal(out, ref[0])
        np.testing.assert_array_equal(mask, ref[1])
    assert out.dtype == mask.dtype == np.float32
    assert mask.sum() == sum(min(n, max_len or 99) for n in LENGTHS)


def test_pack_paths_of_1d_arrays():
    arrays = ragged(1)
    out, mask = native.pack_paths(arrays)
    want = jnative.pack_paths(arrays)
    np.testing.assert_array_equal(out, want[0])
    np.testing.assert_array_equal(mask, want[1])


@pytest.mark.parametrize("gamma", [0.0, 0.95, 1.0])
def test_discount_sums_match_jax_and_plain(gamma):
    xs = ragged(2)
    got = native.discount_sums(xs, gamma)
    assert_lists(got, native.discount_sums_plain(xs, gamma), TOL)
    assert_lists(got, jnative.discount_sums(xs, gamma), TOL)


@pytest.mark.parametrize("gamma,lam", [(0.99, 0.95), (1.0, 1.0),
                                       (0.9, 0.0)])
def test_gae_advantages_match_jax_and_plain(gamma, lam):
    rewards, values = ragged(3), ragged(4)
    terminated = [True, False, False, True, True, False]
    got = native.gae_advantages(rewards, values, terminated, gamma, lam)
    assert_lists(got, native.gae_advantages_plain(rewards, values,
                                                  terminated, gamma, lam),
                 TOL)
    assert_lists(got, jnative.gae_advantages(rewards, values, terminated,
                                             gamma, lam), TOL)


def test_gae_rejects_mismatched_lengths():
    with pytest.raises(ValueError):
        native.gae_advantages([np.ones(3)], [np.ones(2)], [False], 0.9, 0.9)


def test_build_failure_raises_naming_the_compiler_error(tmp_path,
                                                        monkeypatch):
    """No quiet fallback: a source that does not compile raises, and the
    message carries g++'s error."""
    bad = tmp_path / "pathops.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    native._load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="error"):
            native.discount_sums([np.ones(2)], 0.9)
    finally:
        native._load.cache_clear()


class _Baseline:
    """predict(path) -> a fixed function of the observations."""

    def predict(self, path):
        return np.tanh(path["observations"] @ np.array([0.3, -0.2]))


def paths(seed):
    rng = np.random.RandomState(seed)
    out = []
    for n, term in zip([6, 1, 4, 9], [True, False, False, True]):
        out.append(dict(rewards=rng.normal(size=n),
                        observations=rng.normal(size=(n, 2)),
                        terminated=term))
    return out


@pytest.mark.parametrize("gae_lambda,normalize", [(0.97, False),
                                                  (0.97, True),
                                                  (None, False)])
def test_process_samples_match_jax(gae_lambda, normalize):
    tp, jp = paths(5), paths(5)
    tps.compute_returns(tp, 0.99)
    jps.compute_returns(jp, 0.99)
    tps.compute_advantages(tp, _Baseline(), 0.99, gae_lambda, normalize)
    jps.compute_advantages(jp, _Baseline(), 0.99, gae_lambda, normalize)
    for a, b in zip(tp, jp):
        for k in ("returns", "baseline", "advantages"):
            np.testing.assert_allclose(a[k], b[k], rtol=TOL, atol=TOL)
    x = np.random.RandomState(6).normal(size=8)
    for terminal in (0.0, 2.5):
        np.testing.assert_allclose(tps.discount_sum(x, 0.9, terminal),
                                   jps.discount_sum(x, 0.9, terminal),
                                   rtol=TOL, atol=TOL)
