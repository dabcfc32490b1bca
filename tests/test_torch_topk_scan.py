"""The top-k scan kernel's selection (``csrc/knn_topk.cu``), on the CPU.

The kernel cuts the candidates into splits of tiles, visits a split's
tiles in ascending id, lets a score into a query's list only if it beats
the list's bar (entry k−1's value) strictly, merges each tile's entrants
canonically and merges the splits at the end. ``ref.topk_bar_scan_ref``
does the same in plain torch; here it is held bitwise — values and ids —
to ``ref.topk_sim_ref`` / ``ref.foldin_topk_ref`` (themselves held to the
reference's Pallas kernels in ``tests/test_torch_graph.py``), on inputs
with many exact ties, at tile and split sizes down to one candidate.
Bitwise, because both compute the same scores with the same arithmetic
and the selection must not change which of two equal scores is kept.
``knn_topk.plan_scan``, which sizes the kernel's splits, is checked for
covering every tile once.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import numpy as np
import pytest
import torch

from repro_torch.core.graph import kernel_rows
from repro_torch.kernels import knn_topk, ref

MEASURES = ("cosine", "pearson", "euclidean")


def _rep(u, n, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((u, n)).astype(np.float32))


def _ints(u, n, seed, hi=3):
    """Rows of small integers, each three times: many exactly equal
    scores under every measure."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, hi, (u, n)).astype(np.float32)
    return torch.as_tensor(r).repeat_interleave(3, dim=0)


def _assert_bitwise(got, want):
    assert torch.equal(got[0], want[0]), "values differ"
    assert torch.equal(got[1], want[1]), "ids differ"


# (rows, k, n_valid, tile, split_tiles): the kernel's tile and split
CASES = {
    "duplicated rows": (lambda: _rep(40, 12, 1).repeat_interleave(3, 0), 13,
                        None, 8, 2),
    "integer rows": (lambda: _ints(50, 6, 2), 13, None, 16, 3),
    "ragged n_valid": (lambda: _rep(150, 20, 3), 13, 141, 32, 2),
    "fewer valid than k": (lambda: _rep(30, 8, 4), 13, 9, 4, 1),
    "tiles smaller than k": (lambda: _ints(30, 5, 5), 13, 85, 4, 5),
    "one candidate a split": (lambda: _ints(12, 4, 6), 7, 33, 1, 1),
    "k=32 n=64": (lambda: _rep(120, 64, 7), 32, 117, 64, 1),
    "one split": (lambda: _ints(40, 8, 8), 13, None, 16, None),
}


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_bar_scan_graph_build_is_topk_sim(case, measure):
    """Self excluded, candidates >= n_valid masked, as the graph build."""
    make, k, n_valid, tile, split_tiles = CASES[case]
    rows = kernel_rows(make(), measure)
    want = ref.topk_sim_ref(rows, rows, k, exclude_self=True,
                            n_valid=n_valid, measure=measure)
    got = ref.topk_bar_scan_ref(rows, rows, k, self_offset=0,
                                n_valid=n_valid, measure=measure, tile=tile,
                                split_tiles=split_tiles)
    _assert_bitwise(got, want)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("tile,split_tiles", [(64, 2), (4, 3), (1, 1)])
def test_bar_scan_fold_in_is_foldin_topk(measure, tile, split_tiles):
    """A fold-in batch: the last 19 rows against all, each masked against
    its own slot; and the same queries with no self among the candidates."""
    rows = kernel_rows(torch.cat([_ints(40, 6, 9), _rep(49, 6, 10)]),
                       measure)
    q = rows[-19:].contiguous()
    off = rows.shape[0] - 19
    for self_offset in (off, None):
        want = ref.foldin_topk_ref(q, rows, 13, self_offset=self_offset,
                                   measure=measure)
        got = ref.topk_bar_scan_ref(q, rows, 13, self_offset=self_offset,
                                    measure=measure, tile=tile,
                                    split_tiles=split_tiles)
        _assert_bitwise(got, want)


def test_bar_scan_empty_slots_are_neg_inf_zero():
    """No valid candidate at all: every slot (-inf, 0)."""
    rows = _rep(10, 4, 11)
    v, i = ref.topk_bar_scan_ref(rows, rows, 5, self_offset=0, n_valid=0,
                                 tile=2, split_tiles=2)
    assert torch.isinf(v).all() and (v < 0).all()
    assert (i == 0).all()


@pytest.mark.parametrize("rows,c", [(5976, 5976), (64, 6040), (1001, 1001),
                                    (3, 5), (1, 1), (700, 33)])
@pytest.mark.parametrize("variant", range(len(knn_topk.SCAN_VARIANTS)))
@pytest.mark.parametrize("sms,per_sm", [(132, 3), (132, 1), (8, 2)])
def test_plan_scan_covers_every_tile_once(rows, c, variant, sms, per_sm):
    """Splits of tps tiles cover the tiles exactly (the last one not
    empty); the grid stays resident where it can; a split is at least
    MIN_TILES tiles where there are that many; MAX_SPLITS at the most."""
    qt, ct = knn_topk.SCAN_VARIANTS[variant]
    n_tiles = -(-c // ct)
    splits, tps = knn_topk.plan_scan(rows, c, variant, sms, per_sm)
    assert 1 <= splits <= knn_topk.MAX_SPLITS and tps >= 1
    assert (splits - 1) * tps < n_tiles <= splits * tps
    assert splits == 1 or -(-rows // qt) * splits <= sms * per_sm
    assert tps >= min(knn_topk.MIN_TILES, n_tiles)


def test_plan_scan_fit_shape_takes_one_split():
    """The graph build's 374 query blocks of 16 on 132 SMs of 3 blocks: one
    split of all 47 tiles — a second would not stay resident, and every
    split's first tile enters its lists whole."""
    assert knn_topk.plan_scan(5976, 5976, 0, 132, 3) == (1, 47)


def test_plan_scan_balances_the_blocks_an_sm():
    """94 query blocks of 16 on 132 SMs of 3 blocks: 4 splits (376 blocks,
    at most 3 an SM) — 2 or 3 splits would leave some SMs 2 or 3 blocks
    beside others with 1 or 2, for no less time."""
    assert knn_topk.plan_scan(1504, 5976, 0, 132, 3) == (4, 12)


def test_plan_scan_fold_in_takes_the_most_splits_the_merge_allows():
    """64 fold-in queries (8 blocks of 8) against 6040 candidates: every
    split count up to MAX_SPLITS leaves an SM one block at the most, so the
    most splits win."""
    assert knn_topk.plan_scan(64, 6040, 1, 132, 8) == (16, 3)
