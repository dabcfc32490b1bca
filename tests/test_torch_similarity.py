"""Parity of the port's similarity layer with the JAX reference, on the CPU.

Inputs are made with numpy from a seed and go through both packages.
Tolerances:
- floats: rtol=1e-5, atol=1e-6 — both sides compute in f32, but XLA and
  torch sum in different orders;
- the co-rated moments and cosine d1 on integer ratings: equal — every
  moment is an exact integer in f32 (P·25 < 2^24), and the cosine
  epilogue is the same IEEE operations in the same order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import similarity as jsim
from repro.kernels import ops as jops
from repro_torch.core import similarity as tsim
from repro_torch.kernels import ops as tops

RTOL, ATOL = 1e-5, 1e-6
MEASURES = tsim.MEASURES


def _ratings(u, p, density=0.35, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    return r * (rng.random((u, p)) < density)


def _both(fn_j, fn_t, *arrays, **kw):
    got_j = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    got_t = fn_t(*(torch.as_tensor(a) for a in arrays), **kw)
    return np.asarray(got_j), got_t.numpy()


def test_constants_match_reference():
    assert tsim.EPS == jsim.EPS
    assert tsim.MEASURES == jsim.MEASURES


def test_corated_moments_match_reference_exactly():
    """Equal: integer ratings make every moment exact in f32."""
    r = _ratings(57, 83, seed=1)
    lm = r[[3, 9, 20, 41]]
    got_j = jsim.corated_moments(jnp.asarray(r), jnp.asarray(lm))
    got_t = tsim.corated_moments(torch.as_tensor(r), torch.as_tensor(lm))
    for a, b in zip(got_j, got_t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("measure", MEASURES)
def test_masked_similarity_matches_reference(measure):
    """Cosine equal (exact moments, same IEEE epilogue); the others within
    rtol=1e-5, atol=1e-6."""
    r = _ratings(64, 90, seed=2)
    want, got = _both(jsim.masked_similarity, tsim.masked_similarity,
                      r, r[:12], measure=measure)
    if measure == "cosine":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("measure", MEASURES)
def test_dense_similarity_matches_reference(measure):
    """rtol=1e-5, atol=1e-6: f32 GEMMs summed in different orders."""
    rng = np.random.default_rng(3)
    u = rng.normal(size=(41, 9)).astype(np.float32)
    v = rng.normal(size=(23, 9)).astype(np.float32)
    u[5] = 0.0  # a zero row: the EPS clamp keeps it finite
    want, got = _both(jsim.dense_similarity, tsim.dense_similarity, u, v,
                      measure=measure)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("measure", MEASURES)
def test_full_similarity_matrix_matches_reference(measure):
    """rtol=1e-5, atol=1e-6 (euclidean goes through 1/(1+d))."""
    r = _ratings(48, 70, seed=4)
    want, got = _both(jsim.full_similarity_matrix, tsim.full_similarity_matrix,
                      r, measure=measure)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_similarity_from_distance_matches_reference():
    d = np.linspace(0.0, 7.5, 31, dtype=np.float32)
    want, got = _both(jsim.similarity_from_distance,
                      tsim.similarity_from_distance, d)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("shape", [(37, 5, 61), (130, 17, 255)])
def test_kernel_op_matches_pallas_kernel(measure, shape):
    """The port's ``kernels.ops.masked_similarity`` (on CPU tensors, the
    plain version) against the JAX op, which runs the Pallas kernel in
    interpret mode, at ragged A, B and P. Cosine equal, others within
    rtol=1e-5, atol=1e-6."""
    a, b, p = shape
    r = _ratings(a + b, p, seed=5)
    want, got = _both(jops.masked_similarity, tops.masked_similarity,
                      r[:a], r[a:], measure=measure)
    assert got.shape == (a, b)
    if measure == "cosine":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_unknown_measure_raises():
    r = torch.as_tensor(_ratings(4, 6))
    with pytest.raises(ValueError, match="unknown measure"):
        tsim.masked_similarity(r, r, "manhattan")
    with pytest.raises(ValueError, match="unknown measure"):
        tsim.dense_similarity(r, r, "manhattan")
