"""d1's tensor-core route on the CPU: its arithmetic and its guard, held to
the plain version and to the JAX reference.

The route itself runs only on the card (``tests/test_torch_gpu.py``). Its
arithmetic is ``kernels/ref.py::masked_similarity_tc_ref``: operands
rounded to bf16 (a, [a≠0], a², and the stacked landmark planes), three
products with f32 sums, then the shared epilogue. Its guard is
``ref.d1_guard_ref``: every value a multiple of ½ with |v| <= 8 while
P <= ``ref.D1_HALF_ITEMS``, an integer with |v| <= 8 while
P <= ``ref.D1_MAX_ITEMS`` (``tests/test_torch_d1_items.py``).

Tolerances:
- the emulation against ``masked_similarity_ref`` on values the guard
  admits: bitwise, all three measures — every operand is exact in bf16,
  every product a multiple of ¼ and every sum below 2^22, so the moments
  are exact in any order and the epilogue is the same;
- against the reference's Pallas kernel (interpret mode): rtol=1e-5,
  atol=1e-6 for pearson and euclidean, cosine bitwise — the parity rule
  between the two packages (XLA sums in another order);
- on 0.1-step values the emulation is *not* the plain version: the guard
  is needed.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.masked_similarity import masked_similarity_kernel

from repro_torch.core.similarity import MEASURES
from repro_torch.kernels import masked_similarity as d1, ops, ref

RTOL, ATOL = 1e-5, 1e-6
# the ML-1M fit shape (5976, 20, 3952) cut 10× on every axis but the
# landmarks; ragged A, B and P: B = 23 spans two N tiles of 21, P = 1
SHAPES = [(598, 20, 396), (37, 5, 61), (130, 23, 255), (65, 3, 1)]


def _values(kind, shape, seed):
    """Rating-like blocks: whole stars 1..5, half stars 0.5..5, the guard's
    extremes (±8, ±7.5, ±½) and 0.1-step values (off the guard), each with
    ~60% zeros (missing)."""
    rng = np.random.default_rng(seed)
    if kind == "stars":
        v = rng.integers(1, 6, shape)
    elif kind == "half_stars":
        v = rng.integers(1, 11, shape) / 2
    elif kind == "extremes":
        v = rng.choice([-8.0, -7.5, -0.5, 0.5, 7.5, 8.0], shape)
    elif kind == "tenths":
        v = rng.integers(1, 51, shape) / 10
    else:
        raise ValueError(kind)
    return (v * (rng.random(shape) < 0.4)).astype(np.float32)


def _blocks(kind, a, b, p, seed=0):
    r = torch.as_tensor(_values(kind, (a + b, p), seed))
    return r[:a], r[a:]


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["stars", "half_stars", "extremes"])
def test_tc_route_arithmetic_is_bitwise_the_plain_version(kind, shape,
                                                           measure):
    ra, rb = _blocks(kind, *shape, seed=1)
    assert ref.d1_guard_ref(ra) and ref.d1_guard_ref(rb)
    got = ref.masked_similarity_tc_ref(ra, rb, measure)
    want = ref.masked_similarity_ref(ra, rb, measure)
    assert got.shape == shape[:2]
    assert torch.equal(got, want)


@pytest.mark.parametrize("measure", MEASURES)
def test_tc_route_arithmetic_is_exact_at_the_guards_limits(measure):
    """Every value ±8, P at the half-star bound: x and y reach
    64·P = 4,194,240, just under 2^22; the sums stay exact."""
    p = ref.D1_HALF_ITEMS
    rng = np.random.default_rng(2)
    r = torch.as_tensor(rng.choice([-8.0, 8.0], (6, p)).astype(np.float32))
    r[0, :] = 8.0
    r[4, ::3] = 0.0  # a row with missing items
    ra, rb = r[:4], r[4:]
    assert ref.d1_guard_ref(r)
    got = ref.masked_similarity_tc_ref(ra, rb, measure)
    want = ref.masked_similarity_ref(ra, rb, measure)
    assert torch.equal(got, want)
    x = (ra * ra) @ (rb != 0).float().T
    assert float(x.max()) == 64.0 * p < 2.0 ** 22


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("shape", [(598, 20, 396), (130, 23, 255)])
@pytest.mark.parametrize("kind", ["stars", "half_stars"])
def test_tc_route_arithmetic_matches_pallas_kernel(kind, shape, measure):
    """The reference's Pallas kernel in interpret mode against the route's
    arithmetic: cosine bitwise, the others within rtol=1e-5, atol=1e-6."""
    ra, rb = _blocks(kind, *shape, seed=3)
    want = np.asarray(masked_similarity_kernel(
        jnp.asarray(ra.numpy()), jnp.asarray(rb.numpy()), measure))
    got = ref.masked_similarity_tc_ref(ra, rb, measure).numpy()
    if measure == "cosine":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad", [0.25, 8.5, -8.5, 0.1, 3.3, 1e-30,
                                 float("nan"), float("inf"), float("-inf")])
def test_guard_rejects_values_the_route_cannot_hold(bad):
    r = torch.as_tensor(_values("half_stars", (7, 40), 4))
    assert ref.d1_guard_ref(r)
    r[3, 17] = bad
    assert not ref.d1_guard_ref(r)


def test_guard_rejects_tenths_and_admits_its_extremes():
    assert not ref.d1_guard_ref(torch.as_tensor(_values("tenths", (9, 50),
                                                        5)))
    assert ref.d1_guard_ref(torch.as_tensor(_values("extremes", (9, 50), 5)))
    assert ref.d1_guard_ref(torch.tensor([[-0.0, 0.0, 8.0, -8.0, 0.5]]))


def test_guard_bounds_are_where_bf16_stops_being_exact():
    """Every multiple of ½ in [-8, 8] and its square are bf16 values; 8.5²
    is not. 64·P stays below 2^22 up to D1_HALF_ITEMS and reaches it one
    item later; below 2^24 (where f32 stops holding every integer) up to
    D1_MAX_ITEMS, and reaches it one item later."""
    v = torch.arange(-16, 17, dtype=torch.float32) / 2
    for x in (v, v * v):
        assert torch.equal(x.bfloat16().float(), x)
    big = torch.tensor([8.5])
    assert not torch.equal((big * big).bfloat16().float(), big * big)
    assert 64 * ref.D1_HALF_ITEMS < 2 ** 22 == 64 * (ref.D1_HALF_ITEMS + 1)
    assert 64 * ref.D1_MAX_ITEMS < 2 ** 24 == 64 * (ref.D1_MAX_ITEMS + 1)
    top = torch.tensor([2.0 ** 24 - 1, 2.0 ** 24 + 1])
    assert float(top[0]) == 2 ** 24 - 1 and float(top[1]) != 2 ** 24 + 1
    assert d1.MAX_ITEMS == ref.D1_MAX_ITEMS


@pytest.mark.parametrize("measure", MEASURES)
def test_tc_route_arithmetic_is_not_the_plain_version_off_the_guard(measure):
    """0.1-step values are not bf16 values: the route's sums differ from the
    f32 ones, so such data must take the f32 route."""
    ra, rb = _blocks("tenths", 64, 20, 300, seed=6)
    assert not ref.d1_guard_ref(ra)
    got = ref.masked_similarity_tc_ref(ra, rb, measure)
    want = ref.masked_similarity_ref(ra, rb, measure)
    assert not torch.equal(got, want)
    torch.testing.assert_close(got, want, rtol=0.05, atol=0.05)


@pytest.mark.parametrize("route", d1.ROUTES)
def test_wrapper_takes_the_plain_version_on_cpu_for_every_route(route):
    ra, rb = _blocks("stars", 37, 5, 61, seed=7)
    got = ops.masked_similarity(ra, rb, "pearson", route=route)
    assert torch.equal(got, ref.masked_similarity_ref(ra, rb, "pearson"))


@pytest.mark.parametrize("route", ["bf16", "tensor_core"])
def test_wrapper_rejects_an_unknown_route(route):
    ra, rb = _blocks("stars", 4, 2, 6)
    with pytest.raises(ValueError, match="route"):
        ops.masked_similarity(ra, rb, route=route)
