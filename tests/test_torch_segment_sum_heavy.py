"""The segment-sum kernel's heavy units and narrow runs
(``csrc/segment_sum.cu``), emulated step by step on the CPU by
``kernels/ref.py::segment_sum_sched_ref``: each heavy segment cut into
16-byte channel slices, a warp a unit, its members through a ring of
stages (the perm entries a ring ahead), the longest segments first; at
H ≤ 32 each run of rows walked into a tile and stored as one span, a run
without edges as a span of zeros.

The emulation is held bitwise to ``segment_sum_ref`` (the plain version)
and to ``jax.ops.segment_sum`` on the CPU, f32 and bf16 (every one adds a
segment's members in index order from +0, a bf16 sum rounded after every
add): a Zipf head of a few thousand members (BERT4Rec's generator) at
H = 64, 70 and 128; FM-like CSRs, 300 heavy segments of 65-800 members
(more than the 132 blocks the previous design ran) among ~100,000 mostly empty
rows, at H = 1 and 10; segments at the heavy threshold −1, 0 and +1 and at
stage and ring boundaries at H = 1 and 10. ``build_csr``'s heavy list and
the kernel's numbering of its units (:func:`_heavy_units`) give every
(heavy segment, slice) once, longest first, unused slots past N; a unit
or a span dropped or stored twice makes the emulation raise.
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


def _zipf(n, e, seed):
    """``e`` ids over ``n`` rows from BERT4Rec's generator
    (``data/synthetic.py::seq_rec_batch``): row 0 takes ~56% of them."""
    u = np.random.default_rng(seed).random(e)
    return np.minimum(u ** (-1.0 / 1.2) - 1.0, n - 1).astype(np.int32)


def _heavy_units(csr, h, dtype):
    """The kernel's heavy units at width ``h`` in ``dtype``, in the order
    it numbers them: ``(segment, c0, c1)``, channels [c0, c1) of a heavy
    segment — the ``n_huge`` first segments of ``heavy_rows`` in slices
    of SEG_SLOT_HUGE bytes, then the rest up to its first unused slot in
    slices of SEG_SLOT bytes."""
    size = torch.empty((), dtype=dtype).element_size()
    n_huge = int(csr.n_huge)
    units = []
    for i, row in enumerate(csr.heavy_rows.tolist()):
        if row >= csr.n:
            break
        width = (ref.SEG_SLOT_HUGE if i < n_huge
                 else ref.SEG_SLOT) // size
        units += [(row, c0, min(h, c0 + width)) for c0 in range(0, h, width)]
    return units


def _fm_like(seed, n=100_000, segments=300):
    """FM's CSR by field id in small: ``segments`` heavy rows of 65-800
    members and 15,000 light ids among ``n`` mostly empty rows."""
    rng = np.random.default_rng(seed)
    hot = rng.choice(n, segments, replace=False)
    idx = np.concatenate([np.repeat(hot, rng.integers(T + 1, 801, segments)),
                          rng.integers(0, n, 15_000)])
    return rng.permutation(idx).astype(np.int32), n


def _boundaries(seed):
    """Segments at the heavy threshold (T - 1, T, T + 1 members), at the
    huge one (HUGE, HUGE + 1) and at stage and ring edges (two stages,
    one past, the ring's worth, one past, the fill less one), among light
    ones; 2000 rows."""
    rng = np.random.default_rng(seed)
    stage, ring = ref.SEG_STAGE_BYTES // ref.SEG_SLOT, ref.SEG_RING
    sizes = [T - 1, T, T + 1, 2 * stage, 2 * stage + 1, ring * stage,
             ring * stage + 1, (2 * ring - 2) * stage - 1, ss.HUGE,
             ss.HUGE + 1]
    rows = rng.choice(2000, len(sizes), replace=False)
    light = rng.integers(0, 2000, 3000)
    idx = np.concatenate([np.repeat(rows, sizes),
                          light[~np.isin(light, rows)]])
    return rng.permutation(idx).astype(np.int32), 2000, dict(zip(rows, sizes))


CASES = {"zipf_h64": (64,), "zipf_h70": (70,), "zipf_h128": (128,),
         "fm_like_h1": (1,), "fm_like_h10": (10,), "bounds_h1": (1,),
         "bounds_h10": (10,)}


def _case(name):
    """(index (E,) int32, segments N, width H)."""
    (h,) = CASES[name]
    if name.startswith("zipf"):
        return _zipf(3000, 9000, 1), 3000, h
    if name.startswith("fm_like"):
        return (*_fm_like(2), h)
    idx, n, _ = _boundaries(3)
    return idx, n, h


def _sched(x, csr):
    return ref.segment_sum_sched_ref(x, csr.perm, csr.indptr, csr.chunk_rows,
                                     csr.heavy_rows, T)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_heavy_units_and_spans_are_the_plain_version_and_jax(case, dtype):
    idx, n, h = _case(case)
    rng = np.random.default_rng(sorted(CASES).index(case))
    x = torch.as_tensor(rng.normal(size=(idx.shape[0], h)).astype(
        np.float32)).to(DTYPES[dtype])
    csr = ss.build_csr(torch.as_tensor(idx), n)
    counts = csr.indptr[1:] - csr.indptr[:-1]
    if case.startswith("zipf"):
        assert int(counts.max()) > ss.HUGE
        assert int(csr.n_huge) == int((counts > ss.HUGE).sum()) >= 1
    if case.startswith("fm_like"):
        assert int((counts > T).sum()) == 300 > 132
    got = _sched(x, csr)
    assert got.dtype == x.dtype and got.shape == (n, h)
    assert torch.equal(got, ref.segment_sum_ref(x, csr.perm, csr.indptr))
    j = jax.ops.segment_sum(
        jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if dtype == "bf16" else jnp.float32),
        jnp.asarray(idx), num_segments=n)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(j.astype(jnp.float32)))
    assert not got[counts == 0].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_csr_lists_every_heavy_unit_once_longest_first(case):
    idx, n, h = _case(case)
    csr = ss.build_csr(torch.as_tensor(idx), n)
    counts = (csr.indptr[1:] - csr.indptr[:-1]).long()
    slots = csr.heavy_rows.tolist()
    heavy = (counts > T).nonzero().flatten().tolist()
    assert len(slots) == csr.perm.numel() // (T + 1)
    used = slots[:len(heavy)]
    assert sorted(used) == heavy and slots[len(heavy):] == [n] * (
        len(slots) - len(heavy))
    assert [(-int(counts[r]), r) for r in used] == sorted(
        (-int(counts[r]), r) for r in used)
    if case.startswith("bounds"):
        sizes = _boundaries(3)[2]
        assert [int(counts[r]) for r in used] == sorted(
            (s for s in sizes.values() if s > T), reverse=True)
    n_huge = int(csr.n_huge)
    assert [int(counts[r]) > ss.HUGE for r in used] == (
        [True] * n_huge + [False] * (len(used) - n_huge))
    for dtype in DTYPES.values():
        size = torch.empty((), dtype=dtype).element_size()
        units = _heavy_units(csr, h, dtype)
        assert len(units) == len(set(units))
        # each segment's slices in turn, the huge ones' first and narrower
        at = 0
        for i, row in enumerate(used):
            width = (ref.SEG_SLOT_HUGE if i < n_huge
                     else ref.SEG_SLOT) // size
            mine = units[at:at + -(-h // width)]
            assert mine == [(row, c0, min(h, c0 + width))
                            for c0 in range(0, h, width)]
            at += len(mine)
        assert at == len(units)
        covered = {(row, c) for row, c0, c1 in units for c in range(c0, c1)}
        assert covered == {(row, c) for row in heavy for c in range(h)}


def test_chunk_size_grows_for_millions_of_rows_and_keeps_the_gnn_csrs():
    """FM's CSR by field id (41,689,088 rows, 2,555,904 ids) takes chunks of
    1024 rows + edges, BERT4Rec's (1,000,448 rows, 3,276,800 ids) 128; the
    GNN's CSRs keep theirs (minibatch_lg 32, molecule 8)."""
    assert ss.chunk_size(41_689_088, 2_555_904) == ss.CHUNK_MAX == 1024
    assert ss.chunk_size(1_000_448, 3_276_800) == 128
    assert ss.chunk_size(170_496, 54_413) == ss.CHUNK
    assert ss.chunk_size(3840, 8192) == ss.CHUNK_MIN
    assert ss.chunk_size(10 ** 9, 10 ** 9) == ss.CHUNK_MAX


def test_grown_chunks_partition_the_rows_and_sum_as_the_plain_version():
    """A CSR of 2.2 M mostly empty rows takes chunks past CHUNK (each warp
    a window of rows): they still partition the rows, hold at most their
    size in rows + light edges, and the schedule is bitwise the plain
    version, runs of 6-member rows among them."""
    idx, n = _fm_like(6, n=2_200_000, segments=40)
    idx = np.concatenate([idx, np.repeat(np.arange(2000, 2400), 6)])
    csr = ss.build_csr(torch.as_tensor(idx.astype(np.int32)), n)
    chunk = ss.chunk_size(n, csr.perm.numel())
    assert chunk > ss.CHUNK
    counts = (csr.indptr[1:] - csr.indptr[:-1]).long()
    light = torch.where(counts > T, 0, counts)
    bounds = csr.chunk_rows.tolist()
    assert bounds[0] == 0 and bounds[-1] == n
    for rs, re in zip(bounds[:-1], bounds[1:]):
        assert rs <= re and re - rs <= chunk
        assert int(light[rs:re].sum()) <= chunk + T
    x = torch.randn(idx.shape[0], 1, generator=torch.Generator().manual_seed(
        6))
    assert torch.equal(_sched(x, csr), ref.segment_sum_ref(x, csr.perm,
                                                           csr.indptr))


@pytest.mark.parametrize("h", [1, 10])
def test_a_dropped_unit_or_a_span_stored_twice_raises(h):
    idx, n = _fm_like(4, n=20_000, segments=20)
    csr = ss.build_csr(torch.as_tensor(idx), n)
    x = torch.randn(idx.shape[0], h, generator=torch.Generator().manual_seed(
        5))
    assert torch.equal(_sched(x, csr), ref.segment_sum_ref(x, csr.perm,
                                                           csr.indptr))
    last = csr.heavy_rows.clone()
    last[19] = n  # the shortest heavy segment's units never run
    with pytest.raises(AssertionError, match="stored 0 times"):
        _sched(x, dataclasses.replace(csr, heavy_rows=last))
    twice = torch.cat([csr.heavy_rows[:1], csr.heavy_rows])
    with pytest.raises(AssertionError, match="stored 2 times"):
        _sched(x, dataclasses.replace(csr, heavy_rows=twice))
    b = csr.chunk_rows
    # chunk 1 runs on to chunk 2's end, and chunk 2 is walked again
    overlap = dataclasses.replace(csr, chunk_rows=torch.cat([b[:2], b[3:4],
                                                             b[2:]]))
    with pytest.raises(AssertionError, match="stored 2 times"):
        _sched(x, overlap)
