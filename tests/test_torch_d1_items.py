"""d1's tensor-core route past 65,535 items, on the CPU: the guard's two
limits and the route's arithmetic at web_fit's P, held to the plain
version and to the JAX reference.

The guard (``kernels/ref.py::d1_guard_ref``) admits multiples of ½ with
|v| <= 8 while P <= ``ref.D1_HALF_ITEMS`` (every partial sum a multiple of
¼ below 64·P < 2^22), integers with |v| <= 8 while P <= ``ref.D1_MAX_ITEMS``
(every partial sum an integer below 64·P < 2^24), and nothing past it (the
host takes the f32 route). The route itself runs only on the card
(``tests/test_torch_gpu.py``); its arithmetic is
``ref.masked_similarity_tc_ref``.

Tolerances:
- the emulation against ``masked_similarity_ref`` on values the guard
  admits: bitwise, all three measures (every operand exact in bf16, every
  sum exact in f32 in any order);
- against the reference's Pallas kernel (interpret mode) at P = 65,536:
  cosine bitwise, pearson and euclidean within rtol=1e-5, atol=1e-6 — the
  parity rule between the two packages (XLA sums in another order).
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.masked_similarity import masked_similarity_kernel

from repro_torch.core.similarity import MEASURES
from repro_torch.kernels import cost, ref
from repro_torch.kernels import masked_similarity as d1

RTOL, ATOL = 1e-5, 1e-6
WEB_P = 65536  # web_fit's items: one past the half-star limit


def _stars(shape, seed, half=False, density=0.3):
    """Whole stars 1..5 (or half stars 0.5..5) on ``density`` of the cells,
    0 (missing) elsewhere."""
    rng = np.random.default_rng(seed)
    v = rng.integers(1, 11, shape) / 2 if half else rng.integers(1, 6, shape)
    return torch.as_tensor((v * (rng.random(shape) < density))
                           .astype(np.float32))


@pytest.mark.parametrize("items,half_ok,int_ok", [
    (ref.D1_HALF_ITEMS, True, True),
    (ref.D1_HALF_ITEMS + 1, False, True),
    (ref.D1_MAX_ITEMS, False, True),
    (ref.D1_MAX_ITEMS + 1, False, False)])
def test_guard_limits_by_item_count(items, half_ok, int_ok):
    """Half stars pass up to 65,535 items and fail past it; whole stars
    and ±8 integers pass up to 262,143; nothing passes past it."""
    half = torch.tensor([[0.5, 4.5, 0.0, -7.5, 8.0]])
    whole = torch.tensor([[1.0, 5.0, 0.0, -8.0, 8.0, -0.0]])
    assert ref.d1_guard_ref(half, items) == half_ok
    assert ref.d1_guard_ref(whole, items) == int_ok
    assert not ref.d1_guard_ref(torch.tensor([[8.5, 1.0]]), items)
    assert not ref.d1_guard_ref(torch.tensor([[float("nan")]]), items)


def test_guard_step_and_the_f32_limit():
    """The spacing the guard admits: ½, then 1, then none; 64·262,143 is
    below 2^24 = 64·262,144, the first integer sum f32 could not hold
    once one more term is added."""
    assert ref.d1_guard_step(1) == ref.d1_guard_step(ref.D1_HALF_ITEMS) == 0.5
    assert ref.d1_guard_step(ref.D1_HALF_ITEMS + 1) == 1.0
    assert ref.d1_guard_step(ref.D1_MAX_ITEMS) == 1.0
    assert ref.d1_guard_step(ref.D1_MAX_ITEMS + 1) is None
    assert 64 * ref.D1_MAX_ITEMS < 2 ** 24 == 64 * (ref.D1_MAX_ITEMS + 1)
    assert d1.MAX_ITEMS == ref.D1_MAX_ITEMS == 262143
    # the guard's default item count is the operand's last axis
    assert not ref.d1_guard_ref(torch.full((1, ref.D1_HALF_ITEMS + 1), 0.5))
    assert ref.d1_guard_ref(torch.full((1, ref.D1_HALF_ITEMS + 1), 3.0))


@pytest.mark.parametrize("measure", MEASURES)
def test_tc_arithmetic_is_bitwise_the_plain_version_at_web_fit_items(measure):
    """Whole stars at P = 65,536: the route's bf16 products with f32 sums
    equal the plain f32 moments bit for bit."""
    r = _stars((16 + 12, WEB_P), seed=1, density=0.05)
    ra, rb = r[:16], r[16:]
    assert ref.d1_guard_ref(ra) and ref.d1_guard_ref(rb)
    got = ref.masked_similarity_tc_ref(ra, rb, measure)
    want = ref.masked_similarity_ref(ra, rb, measure)
    assert torch.equal(got, want)


@pytest.mark.parametrize("measure", MEASURES)
def test_tc_arithmetic_is_exact_at_the_integer_limit(measure):
    """±8 integers with no zero at P = 262,143: x, y and |z| reach
    64·P = 16,777,152, just under 2^24, and stay exact."""
    p = ref.D1_MAX_ITEMS
    rng = np.random.default_rng(2)
    r = torch.as_tensor(rng.choice([-8.0, -3.0, 5.0, 8.0], (8, p))
                        .astype(np.float32))
    r[0] = 8.0
    r[5] = -8.0
    ra, rb = r[:4], r[4:]
    assert ref.d1_guard_ref(r)
    got = ref.masked_similarity_tc_ref(ra, rb, measure)
    want = ref.masked_similarity_ref(ra, rb, measure)
    assert torch.equal(got, want)
    x = (ra * ra) @ (rb != 0).float().T
    assert float(x.max()) == 64.0 * p < 2.0 ** 24


@pytest.mark.parametrize("measure", MEASURES)
def test_tc_arithmetic_matches_pallas_kernel_at_web_fit_items(measure):
    """The reference's Pallas kernel in interpret mode at P = 65,536 against
    the route's arithmetic: cosine bitwise, the others within rtol=1e-5,
    atol=1e-6."""
    r = _stars((12 + 10, WEB_P), seed=3, density=0.05)
    ra, rb = r[:12], r[12:]
    want = np.asarray(masked_similarity_kernel(
        jnp.asarray(ra.numpy()), jnp.asarray(rb.numpy()), measure,
        block=(16, 16, 4096)))
    got = ref.masked_similarity_tc_ref(ra, rb, measure).numpy()
    if measure == "cosine":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("measure", MEASURES)
def test_half_stars_past_the_limit_need_the_guard(measure):
    """Half stars at P = 65,536 fail the guard; the route's arithmetic
    there happens to stay exact on this sparse block, but nothing proves
    it, so the card takes the f32 result (the counted fallback)."""
    r = _stars((10 + 6, WEB_P), seed=4, half=True, density=0.05)
    assert not ref.d1_guard_ref(r)
    assert ref.d1_guard_ref(r, ref.D1_HALF_ITEMS)
    got = ref.masked_similarity_tc_ref(r[:10], r[10:], measure)
    want = ref.masked_similarity_ref(r[:10], r[10:], measure)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,p,aligned,lm", [
    (20, 3952, True, 21), (21, 65536, True, 21), (22, 65536, True, 32),
    (128, 65536, True, 32), (128, 3952, True, 32), (129, 65536, True, 21),
    (128, 65535, True, 21), (128, 65536, False, 21)])
def test_n_tile_and_workspace_follow_the_route(b, p, aligned, lm):
    """The cluster kernel (32 landmarks an N tile) takes 22..128 landmarks
    on 16-byte rows; the workspace holds the moments, the flag and the
    planes of that packing; the cost counts its columns."""
    assert cost.d1_n_tile(b, p, aligned) == lm
    a = 245760 if p == 65536 else 5976
    ws = d1._workspace_bytes(a, b, p, lm)
    atoms = 2 if lm == 32 else 1
    planes = -(-b // lm) * -(-p // 64) * atoms * 8192
    assert ws == -(-(24 * a * b + 16) // 16) * 16 + planes
    ops = cost.masked_similarity(a, b, p, True, aligned).ops
    assert ops == 2 * a * p * (192 if lm == 32 else 136) * -(-b // lm)


def test_web_fit_bounds():
    """At web_fit's shape R is 64.4 GB (19.2 ms at 3.35 TB/s; 19.3 with
    the landmarks and the output) and the cluster kernel's products, the
    6·B = 768 columns a row needs, 25.0 ms at 989 TFLOP/s: bound by
    operations. The f32 route's work: 369 ms."""
    tc = cost.masked_similarity(245760, 128, WEB_P, True)
    f32 = cost.masked_similarity(245760, 128, WEB_P, False)
    r_bytes = 4 * 245760 * WEB_P
    assert round(r_bytes / cost.HBM_BYTES_PER_S * 1e3, 1) == 19.2
    assert round(tc.bytes / cost.HBM_BYTES_PER_S * 1e3, 1) == 19.3
    assert tc.ops == 2 * 245760 * WEB_P * 768
    ms_, by = tc.bound()
    assert (round(ms_, 1), by) == (25.0, "operations")
    assert round(f32.bound()[0]) == 369
