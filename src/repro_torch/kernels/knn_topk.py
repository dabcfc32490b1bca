"""Wrappers of the fused d2 similarity + top-k CUDA kernels
(``csrc/knn_topk.cu``).

- :func:`topk_sim` — the neighbor-graph build: every query row's top-k
  candidates, the (U, C) score matrix never written.
- :func:`foldin_topk` — the skinny fold-in search of a batch of new rows.

Both run the same launches: a prep pass lays the candidates out d-major
(centered and normed once), the scan scores candidate tiles in register
micro-tiles against a per-query bar, and, when the candidate tiles are
split across blocks to fill the card, a merge of the splits' lists. Past
``NARROW_WIDTH`` landmarks the wide route preps the queries too and
streams both in slices of the landmark axis (any n). Both return lists in
canonical order (value desc, id asc) with empty slots as (-inf, 0). Cosine
expects rows L2-normalized by the caller; pearson and euclidean take raw
representation rows.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import build, ref

# kernels 2-5 take any landmark count n >= 1: up to NARROW_WIDTH whole rows
# (the scan's ring, the IVF kernels' register rows), past it their wide
# routes, which stage rows in slices of the landmark axis
NARROW_WIDTH = 104
MAX_K = 32  # list length: lanes of the warp-wide list
# (queries, candidates) a block's tile in each scan variant, by the index
# that csrc/knn_topk.cu's with_tile takes
SCAN_VARIANTS = ((16, 128), (8, 128))
# the variant of a call with more than SMALL_ROWS query rows, and of one
# with at most SMALL_ROWS
LARGE_VARIANT, SMALL_VARIANT, SMALL_ROWS = 0, 1, 256
MIN_TILES = 2  # candidate tiles a split takes at the least
MAX_SPLITS = 16  # splits·k entries a row for the merge kernel at the most


def plan_scan(rows: int, c: int, variant: int, sms: int, per_sm: int,
              min_tiles: int = MIN_TILES, max_splits: int = MAX_SPLITS
              ) -> Tuple[int, int]:
    """(splits, tiles a split) of a scan of ``rows`` queries against ``c``
    candidates on ``sms`` SMs of ``per_sm`` resident blocks each.

    Blocks on one SM share it, so a call takes about as long as the SM
    with the most blocks: of the split counts whose grid stays resident
    (and whose splits hold ``min_tiles`` tiles, at most ``max_splits`` of
    them), the one with the least ⌈blocks / sms⌉ / splits, the fewest on a
    tie — each split costs the merge warps a first tile that every score
    enters. Every tile lies in exactly one split.
    """
    qt, ct = SCAN_VARIANTS[variant]
    q = -(-rows // qt)
    n_tiles = -(-c // ct)
    top = max(1, min(n_tiles // min_tiles, sms * per_sm // q, max_splits))
    splits = min(range(1, top + 1),
                 key=lambda s: (-(-q * s // sms) / s, s))
    tps = -(-n_tiles // splits)
    return -(-n_tiles // tps), tps


@functools.cache
def _occupancy(device: int, variant: int, n: int, measure: str
               ) -> Tuple[int, int]:
    """(SMs, resident scan blocks an SM) of the card at width n. The C
    call also lets the scan use the shared memory of the widest rows on
    this device, so it runs before the first launch there."""
    with torch.cuda.device(device):
        per_sm = build.library().topk_scan_blocks_per_sm(
            variant, n, build.MEASURE_CODES[measure])
    if per_sm <= 0:
        raise RuntimeError(f"topk scan variant {variant}: occupancy query "
                           f"failed ({per_sm})")
    return torch.cuda.get_device_properties(
        device).multi_processor_count, per_sm


def check_width(name: str, n: int) -> None:
    """Raise unless the landmark axis ``n`` is one the kernels take: any
    n >= 1 (kernels 2–5 switch to their wide routes past
    ``NARROW_WIDTH``; kernel 6 slices its rows at every n)."""
    if n < 1:
        raise ValueError(f"{name}: width {n} outside 1..")


def _check(name, rep, cand, k, n_valid, measure):
    build.check_cuda_f32(name, rep, cand)
    n = rep.shape[1]
    if cand.shape[1] != n:
        raise ValueError(f"{name}: widths differ: {rep.shape} vs {cand.shape}")
    check_width(name, n)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{name}: k={k} outside 1..{MAX_K}")
    if not 0 <= n_valid <= cand.shape[0]:
        raise ValueError(f"{name}: n_valid={n_valid} outside 0..{cand.shape[0]}")
    if measure not in build.MEASURE_CODES:
        raise ValueError(f"unknown measure {measure!r}")


def _scan(name, rep, cand, k, n_valid, self_offset, measure):
    """The kernels' call: prep, scan and merge on CUDA tensors."""
    n_valid = cand.shape[0] if n_valid is None else n_valid
    _check(name, rep, cand, k, n_valid, measure)
    rows, n = rep.shape
    c = cand.shape[0]
    dev = rep.device
    vals = torch.empty((rows, k), dtype=torch.float32, device=dev)
    ids = torch.empty((rows, k), dtype=torch.int32, device=dev)
    if not rows or not c:
        vals.fill_(float("-inf"))
        ids.zero_()
        return vals, ids, False
    variant = LARGE_VARIANT if rows > SMALL_ROWS else SMALL_VARIANT
    qt, ct = SCAN_VARIANTS[variant]
    splits, tps = plan_scan(rows, c, variant,
                            *_occupancy(dev.index, variant, n, measure),
                            MIN_TILES,
                            MAX_SPLITS)
    # the candidates' d-major layout, and past NARROW_WIDTH the queries'
    qpad = -(-rows // qt) * qt if n > NARROW_WIDTH else 0
    prep = torch.empty((n + 1, -(-c // ct) * ct + qpad), dtype=torch.float32,
                       device=dev)
    part_v, part_i = vals, ids
    if splits > 1:
        part_v = torch.empty((rows, splits, k), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((rows, splits, k), dtype=torch.int32,
                             device=dev)
    build.launch("topk_scan_f32", rep, cand, prep, part_v, part_i, vals, ids,
                 rows, c, n, k, n_valid,
                 -1 if self_offset is None else self_offset,
                 build.MEASURE_CODES[measure], variant, qt, ct, splits, tps)
    return vals, ids, True


def topk_sim(rep: torch.Tensor, cand: torch.Tensor, k: int = 14,
             exclude_self: bool = False, n_valid: Optional[int] = None,
             measure: str = "cosine", row_offset: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals, ids), each (U, k): every rep row's top-k candidate d2 weights.

    Candidates ``>= n_valid`` (default: all valid) are never selected;
    ``exclude_self`` assumes rep row i is candidate ``row_offset + i`` and
    masks it (a shard's rows of a sharded graph build start at its
    offset). CUDA tensors go through the kernels, CPU tensors take the
    plain version.
    """
    self_offset = row_offset if exclude_self else None
    if rep.device.type == "cpu" and cand.device.type == "cpu":
        return ref.foldin_topk_ref(rep, cand, k, self_offset, n_valid,
                                   measure)
    vals, ids, launched = _scan("topk_sim", rep, cand, k, n_valid,
                                self_offset, measure)
    build.count_launch(topk_sim, launched)
    return vals, ids


def foldin_topk(rep: torch.Tensor, cand: torch.Tensor, k: int = 14,
                self_offset: Optional[int] = None,
                n_valid: Optional[int] = None, measure: str = "cosine"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals, ids), each (b, k): top-k candidates of a skinny fold-in batch.

    Query i is candidate ``self_offset + i`` and never lists itself (None:
    the queries are not among the candidates). CUDA tensors go through the
    kernels, CPU tensors take the plain version.
    """
    if rep.device.type == "cpu" and cand.device.type == "cpu":
        return ref.foldin_topk_ref(rep, cand, k, self_offset, n_valid, measure)
    vals, ids, launched = _scan("foldin_topk", rep, cand, k, n_valid,
                                self_offset, measure)
    build.count_launch(foldin_topk, launched)
    return vals, ids


topk_sim.launches = 0
foldin_topk.launches = 0
