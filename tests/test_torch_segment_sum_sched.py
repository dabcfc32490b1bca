"""The segment-sum kernel's schedule (``csrc/segment_sum.cu``), emulated
step by step on the CPU by ``kernels/ref.py::segment_sum_sched_ref``:
``build_csr``'s chunks and heavy-segment list, the warps' runs, load
groups and channel slices, the heavy blocks' stages.

The emulation is held bitwise to ``segment_sum_ref`` (the plain version)
and to ``jax.ops.segment_sum`` on the CPU, f32 and bf16 (every one adds a
segment's members in index order from +0, a bf16 sum rounded after every
add), at every width class of the kernel (H = 1, 31, 32, 33, 70, 128:
one to four channels a lane), one segment of 5,000 members, degrees at the
heavy threshold −1, 0 and +1, a large CSR (chunks of ``CHUNK``; every
other case takes ``CHUNK_MIN``), every segment empty, zero live edges and
the four index kinds of ``tests/test_torch_gnn.py``. A schedule that drops a
heavy segment or overlaps two chunks makes the emulation raise.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.kernels import ops  # noqa: F401 (import order)
from repro_torch.kernels import ref
from repro_torch.kernels import segment_sum as ss

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
T = ss.HEAVY


def _case(name, rng):
    """(index (E,) int32, mask (E,) f32, segments N, width H)."""
    e, n, h = 700, 60, 70
    mask = np.ones(e, np.float32)
    if name.startswith("h"):  # power-law degrees at width H
        h = int(name[1:])
        w = 1.0 / np.arange(1, n + 1) ** 0.7
        idx = rng.choice(n, size=e, p=w / w.sum())
    elif name.startswith("one_5000"):  # past HUGE; a bf16 row at H = 33
        e, n = 5000, 3                   # is 2-byte aligned
        h = 33 if name == "one_5000_h33" else h
        idx = np.full(e, 1)
        mask = np.ones(e, np.float32)
    elif name.startswith("deg"):  # segments of T-1, T, T+1 members
        d = T + int(name[3:])
        n = 9
        idx = np.repeat([1, 4, 5], d)
        idx = np.concatenate([idx, rng.choice([0, 2, 3, 6, 7, 8], 40)])
        e = idx.shape[0]
        mask = np.ones(e, np.float32)
    elif name == "large":  # minibatch_lg's layout: a dense head, then
        e, n, h = 9000, 126000, 8  # empty rows; chunks of CHUNK
        idx = rng.integers(0, 2000, e)
        mask = np.ones(e, np.float32)
        mask[::3] = 0
    elif name == "all_empty":  # every edge masked
        idx = rng.integers(0, n, e)
        mask = np.zeros(e, np.float32)
    elif name == "no_edges":
        e = 0
        idx = np.zeros(0, np.int64)
        mask = np.ones(0, np.float32)
    elif name == "random":
        idx = rng.integers(0, n, e)
    elif name == "power_law":
        w = 1.0 / np.arange(1, n + 1) ** 0.7
        idx = rng.choice(n, size=e, p=w / w.sum())
    elif name == "padded":  # the reference's padding: node 0, mask 0
        idx = rng.integers(0, n, e)
        idx[e // 2:] = 0
        mask[e // 2:] = 0
    else:  # "empty": every other segment has no member
        idx = 2 * rng.integers(0, n // 2, e)
    return idx.astype(np.int32), mask, n, h


CASES = ("h1", "h31", "h32", "h33", "h70", "h128", "one_5000",
         "one_5000_h33", "deg-1", "deg+0", "deg+1", "large", "all_empty",
         "no_edges", "random", "power_law", "padded", "empty")


def _sched(x, csr):
    return ref.segment_sum_sched_ref(x, csr.perm, csr.indptr, csr.chunk_rows,
                                     csr.heavy_rows, T)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_schedule_is_the_plain_version_and_jax_segment_sum(case, dtype):
    rng = np.random.default_rng(CASES.index(case))
    idx, mask, n, h = _case(case, rng)
    x = torch.as_tensor(rng.normal(size=(idx.shape[0], h)).astype(
        np.float32)).to(DTYPES[dtype])
    csr = ss.build_csr(torch.as_tensor(idx), n, torch.as_tensor(mask))
    got = _sched(x, csr)
    assert got.dtype == x.dtype and got.shape == (n, h)
    assert torch.equal(got, ref.segment_sum_ref(x, csr.perm, csr.indptr))
    assert torch.equal(got, ss.segment_sum(x, csr))
    # a masked edge's row, zeroed as the GNN zeroes its messages, adds +0
    live = torch.as_tensor(mask)[:, None] != 0
    zeroed = torch.where(live, x, torch.zeros((), dtype=x.dtype))
    j = jax.ops.segment_sum(
        jnp.asarray(zeroed.float().numpy()).astype(
            jnp.bfloat16 if dtype == "bf16" else jnp.float32),
        jnp.asarray(idx), num_segments=n)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))
    counts = csr.indptr[1:] - csr.indptr[:-1]
    assert not got[counts == 0].any()


@pytest.mark.parametrize("case", CASES)
def test_build_csr_schedule(case):
    """heavy_rows lists exactly the segments of more than HEAVY members,
    longest first (ties by index), then N; the chunks partition [0, N),
    each at most CHUNK rows and CHUNK + HEAVY light edges."""
    idx, mask, n, _ = _case(case, np.random.default_rng(CASES.index(case)))
    csr = ss.build_csr(torch.as_tensor(idx), n, torch.as_tensor(mask))
    counts = (csr.indptr[1:] - csr.indptr[:-1]).long()
    n_live = csr.perm.numel()
    heavy = sorted((counts > T).nonzero().flatten().tolist(),
                   key=lambda r: (-int(counts[r]), r))
    slots = csr.heavy_rows.tolist()
    assert len(slots) == n_live // (T + 1)
    assert slots == heavy + [n] * (len(slots) - len(heavy))
    if case.startswith("deg"):
        assert heavy == ([1, 4, 5] if case == "deg+1" else [])
    bounds = csr.chunk_rows.tolist()
    chunk = ss.chunk_size(n, n_live)
    assert chunk == (ss.CHUNK if case == "large" else ss.CHUNK_MIN)
    assert bounds[0] == 0 and bounds[-1] == n
    assert len(bounds) - 1 == -(-(n + n_live) // chunk)
    light = torch.where(counts > T, 0, counts)
    for rs, re in zip(bounds[:-1], bounds[1:]):
        assert rs <= re and re - rs <= chunk
        assert int(light[rs:re].sum()) <= chunk + T
    assert csr.chunk_rows.dtype == csr.heavy_rows.dtype == torch.int32


def test_schedule_that_misses_a_row_or_stores_one_twice_raises():
    rng = np.random.default_rng(7)
    idx = np.concatenate([np.full(200, 3), rng.integers(0, 300, 900)])
    csr = ss.build_csr(torch.as_tensor(idx.astype(np.int32)), 300)
    x = torch.randn(idx.shape[0], 33, generator=torch.Generator().manual_seed(
        0))
    assert torch.equal(_sched(x, csr), ref.segment_sum_ref(x, csr.perm,
                                                           csr.indptr))
    assert csr.heavy_rows.tolist()[0] == 3
    dropped = dataclasses.replace(csr, heavy_rows=torch.full_like(
        csr.heavy_rows, 300))
    with pytest.raises(AssertionError, match="stored 0 times"):
        _sched(x, dropped)
    b = csr.chunk_rows
    assert b[1] < b[2] < b[3]
    # chunk 1 runs on to chunk 2's end, and chunk 2 is walked again
    overlap = dataclasses.replace(csr, chunk_rows=torch.cat([b[:2], b[3:4],
                                                             b[2:]]))
    with pytest.raises(AssertionError, match="stored 2 times"):
        _sched(x, overlap)
