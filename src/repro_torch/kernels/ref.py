"""Plain PyTorch versions of the port's CUDA kernels.

Each function here computes what its kernel computes, with ordinary tensor
ops. The wrappers in this package take them for CPU tensors (the CPU tests
run them against the JAX reference), and ``chip_smoke.py`` holds every
kernel against its plain version on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.similarity import EPS, _finalize, _sqrt, corated_moments
from ..core.topk import canonical_topk


def masked_similarity_ref(r_a: torch.Tensor, r_b: torch.Tensor,
                          measure: str = "cosine") -> torch.Tensor:
    """Oracle for kernels.masked_similarity: co-rated similarity (A, B)."""
    return _finalize(measure, *corated_moments(r_a.float(), r_b.float()))


# d1's tensor-core route holds values that are multiples of ½ with
# |v| <= 8, over fewer than 2^16 items: then v, v² and the masks are exact
# in bf16, every product is a multiple of ¼, and every sum of them stays
# below 64·P < 2^22, exact in f32 in any order
D1_GUARD_MAX = 8.0
D1_MAX_ITEMS = 65535


def d1_guard_ref(r: torch.Tensor) -> bool:
    """The guard of d1's tensor-core route on one operand: True when every
    value is a multiple of ½ with |v| <= 8 (NaN and ±inf fail)."""
    r = r.float()
    t = r * 2.0
    return bool(((r.abs() <= D1_GUARD_MAX) & (t == torch.round(t))).all())


def masked_similarity_tc_ref(r_a: torch.Tensor, r_b: torch.Tensor,
                             measure: str = "cosine") -> torch.Tensor:
    """The tensor-core route's arithmetic in plain torch, on any values (no
    guard), to check its numerics on the CPU; never on a model path.

    The operands become bf16 (round to nearest): a, [a≠0] and a² (the f32
    square, rounded) of r_a, and the stacked planes [b ; [b≠0] ; b²] of
    r_b. Three products with f32 sums — a·planes (z, sx),
    [a≠0]·planes (sy, c, y), a²·planes (x) — give the six moments, then
    :func:`_finalize`. On values :func:`d1_guard_ref` admits this equals
    :func:`masked_similarity_ref` bit for bit.
    """
    a, b = r_a.float(), r_b.float()

    def planes(x):
        return (x.bfloat16().float(), (x != 0).float(),
                (x * x).bfloat16().float())

    a1, am, a2 = planes(a)
    stacked = torch.cat(planes(b)).T  # (P, 3B)
    n = b.shape[0]
    p1, p2, p3 = a1 @ stacked, am @ stacked, a2 @ stacked
    z, sx = p1[:, :n], p1[:, n:2 * n]
    sy, c, y = p2[:, :n], p2[:, n:2 * n], p2[:, 2 * n:]
    return _finalize(measure, z, p3[:, n:2 * n], y, c, sx, sy)


def _row_sums(x: torch.Tensor) -> torch.Tensor:
    """Σ_d x[..., d] over the last axis, added left to right, as the
    kernels add."""
    s = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for d in range(x.shape[-1]):
        s = s + x[..., d]
    return s


def _row_means(x: torch.Tensor) -> torch.Tensor:
    """The row sums over a tensor of n: a true IEEE division, as the
    kernel's. (Dividing by a Python number lets torch multiply by its
    reciprocal on the card, one rounding more.)"""
    s = _row_sums(x)
    return s / torch.full_like(s, x.shape[-1])


def tile_sims(rep: torch.Tensor, cand: torch.Tensor, measure: str
              ) -> torch.Tensor:
    """(rows, C) d2 scores with the measure epilogue of the top-k kernels.

    Cosine expects rows L2-normalized by the caller and is the raw dot
    product; pearson centers the rows, then takes the cosine; euclidean
    is 1/(1+√d²) with d² = |u|² − 2z + |v|². Every sum runs over the
    landmark axis left to right, with a rounding after each multiply and
    each add, and the epilogue uses the same IEEE operations in the same
    order as the kernel, so on the card the two agree bitwise — the
    euclidean epilogue cancels badly for near-duplicate rows, where two
    summation orders could differ by ~1e-3.
    """
    if measure == "pearson":
        rep = rep - _row_means(rep)[:, None]
        cand = cand - _row_means(cand)[:, None]
    z = torch.zeros((rep.shape[0], cand.shape[0]), dtype=rep.dtype,
                    device=rep.device)
    for d in range(rep.shape[1]):
        z = z + rep[:, d, None] * cand[None, :, d]
    if measure == "cosine":
        return z
    nu = _row_sums(rep * rep)[:, None]
    nv = _row_sums(cand * cand)[None, :]
    if measure == "pearson":
        return z / (_sqrt(nu) * _sqrt(nv)).clamp(min=EPS)
    if measure == "euclidean":
        d2 = (nu - 2.0 * z + nv).clamp(min=0.0)
        return 1.0 / (1.0 + _sqrt(d2))
    raise ValueError(f"unknown measure {measure!r}")


def _masked_topk(rep, cand, k, self_offset, n_valid, measure):
    rep, cand = rep.float(), cand.float()
    c = cand.shape[0]
    n_valid = c if n_valid is None else n_valid
    sims = tile_sims(rep, cand, measure)
    col = torch.arange(c, device=rep.device)[None, :]
    invalid = col >= n_valid
    if self_offset is not None:
        row = self_offset + torch.arange(rep.shape[0], device=rep.device)
        invalid = invalid | (col == row[:, None])
    sims = sims.masked_fill(invalid, float("-inf"))
    if c < k:  # fewer candidates than slots: the tail is empty
        sims = torch.cat([sims, sims.new_full((sims.shape[0], k - c),
                                              float("-inf"))], dim=1)
    vals, ids = canonical_topk(sims, k)
    ids = torch.where(torch.isfinite(vals), ids, torch.zeros_like(ids))
    return vals, ids.to(torch.int32)


def topk_sim_ref(rep: torch.Tensor, cand: torch.Tensor, k: int = 14,
                 exclude_self: bool = False, n_valid: Optional[int] = None,
                 measure: str = "cosine"):
    """Oracle for kernels.topk_sim: per rep row, the canonical top-k
    (value desc, id asc) of its d2 scores against ``cand``. Candidates
    ``>= n_valid`` and, with ``exclude_self``, the diagonal are masked;
    empty slots are (-inf, 0)."""
    return _masked_topk(rep, cand, k, 0 if exclude_self else None, n_valid,
                        measure)


def foldin_topk_ref(rep: torch.Tensor, cand: torch.Tensor, k: int = 14,
                    self_offset: Optional[int] = None,
                    n_valid: Optional[int] = None, measure: str = "cosine"):
    """Oracle for kernels.foldin_topk: :func:`topk_sim_ref` where query row
    i is candidate ``self_offset + i`` (None: the queries are not among the
    candidates)."""
    return _masked_topk(rep, cand, k, self_offset, n_valid, measure)


def topk_bar_scan_ref(rep: torch.Tensor, cand: torch.Tensor, k: int = 14,
                      self_offset: Optional[int] = None,
                      n_valid: Optional[int] = None, measure: str = "cosine",
                      tile: int = 64, split_tiles: Optional[int] = None):
    """The top-k scan kernel's selection in plain torch, to check on the
    CPU that it gives :func:`foldin_topk_ref`'s lists; never on a model
    path.

    The candidates are cut into splits of ``split_tiles`` tiles of ``tile``
    (None: one split). Within a split the tiles go in ascending id; a
    score enters the list only if it beats the bar, entry k−1's value
    (-inf while fewer than k are listed), strictly, and each tile's
    entrants are merged into the list canonically, which keeps k entries.
    The splits' lists are merged canonically at the end.
    """
    rep, cand = rep.float(), cand.float()
    rows, c = rep.shape[0], cand.shape[0]
    n_valid = c if n_valid is None else n_valid
    sims = tile_sims(rep, cand, measure)
    col = torch.arange(c, device=rep.device)
    invalid = (col >= n_valid)[None, :].expand(rows, c)
    if self_offset is not None:
        row = self_offset + torch.arange(rows, device=rep.device)
        invalid = invalid | (col[None, :] == row[:, None])
    sims = sims.masked_fill(invalid, float("-inf"))
    span = c if split_tiles is None else split_tiles * tile
    parts_v, parts_i = [], []
    for s0 in range(0, c, span):
        lv = sims.new_full((rows, k), float("-inf"))
        li = torch.zeros((rows, k), dtype=torch.long, device=rep.device)
        for t0 in range(s0, min(c, s0 + span), tile):
            t1 = min(t0 + tile, s0 + span, c)
            v = sims[:, t0:t1]
            enter = v > lv[:, k - 1:]
            lv, li = canonical_topk(
                torch.cat([lv, v.masked_fill(~enter, float("-inf"))], 1), k,
                ids=torch.cat([li, col[t0:t1].expand(rows, -1)], 1))
        parts_v.append(lv)
        parts_i.append(li)
    vals, ids = canonical_topk(torch.cat(parts_v, 1), k,
                               ids=torch.cat(parts_i, 1))
    ids = torch.where(torch.isfinite(vals), ids, torch.zeros_like(ids))
    return vals, ids.to(torch.int32)


def assign_clusters_ref(rep: torch.Tensor, cent: torch.Tensor,
                        measure: str = "cosine") -> torch.Tensor:
    """Oracle for kernels.assign_clusters: (U,) int32 arg-max over the
    :func:`tile_sims` scores of each row against the centroids, ties to the
    lowest centroid id. Cosine expects rows and centroids L2-normalized by
    the caller, as the kernel does."""
    sims = tile_sims(rep.float(), cent.float(), measure)
    return canonical_topk(sims, 1)[1][:, 0].to(torch.int32)


def l2_normalize_ref(x: torch.Tensor) -> torch.Tensor:
    """x / max(√Σx², eps) per row, the squares added left to right as the
    Lloyd kernel adds them (not ``torch.sum``'s order)."""
    return x / _sqrt(_row_sums(x * x))[:, None].clamp(min=EPS)


def cell_sums_ref(rows: torch.Tensor, seg: torch.Tensor, c: int):
    """``(sums (c, n) f32, counts (c,) int64)`` of the member ``rows`` of
    each cell (cell ``seg[i]`` of row i), the members added in ascending
    row order from +0.0 — ``jax.ops.segment_sum``'s order and CPU
    ``index_add_``'s.

    A stable sort lists each cell's members in row order; step j adds
    every cell's j-th member where it has one (a masked add, so a cell's
    sum sees its members' adds and no others). No atomics, so the card
    adds in this order too.
    """
    order = torch.sort(seg.long(), stable=True).indices
    counts = torch.bincount(seg.long(), minlength=c)
    starts = torch.cumsum(counts, 0) - counts
    sums = torch.zeros((c, rows.shape[1]), dtype=torch.float32,
                       device=rows.device)
    last = max(rows.shape[0] - 1, 0)
    for j in range(int(counts.max()) if rows.shape[0] else 0):
        member = rows[order[(starts + j).clamp(max=last)]]
        sums = torch.where((counts > j)[:, None], sums + member, sums)
    return sums, counts


# slots segment_sum_ref takes on the tensor's device; a float segment with
# more members finishes its chain on the host
SEG_REF_SLOTS = 64


def segment_sum_ref(x: torch.Tensor, perm: torch.Tensor,
                    indptr: torch.Tensor) -> torch.Tensor:
    """Oracle for kernels.segment_sum: ``(N, H)`` in ``x``'s dtype, row n
    the sum of ``x[perm[j]]`` for j in ``indptr[n] .. indptr[n + 1]``,
    added one after another from 0 in that order (in ``x``'s dtype, so a
    bf16 sum rounds after every add) — index order when ``perm`` is a
    stable argsort of the index: CPU ``index_add_``'s f32 sums and
    ``jax.ops.segment_sum``'s f32 and bf16 sums on the CPU, bit for bit.

    Slot t adds every segment's t-th member where it has one (a masked
    add), vectorised over segments: no atomics, the same order on any
    device. In f32 and f64 the slots stop at ``SEG_REF_SLOTS``, and each
    longer segment (a recsys batch's Zipf head holds half its ids) goes on
    adding its remaining members to its partial sum one after another on
    the host (``numpy.add.accumulate``, a left fold in the array's dtype),
    so the work is the members' rows, not max degree times N rows; other
    dtypes take every slot on the device.
    """
    counts = (indptr[1:] - indptr[:-1]).long()
    starts = indptr[:-1].long()
    out = torch.zeros((counts.shape[0], x.shape[1]), dtype=x.dtype,
                      device=x.device)
    if not perm.shape[0]:
        return out
    last = perm.shape[0] - 1
    on_host = x.dtype in (torch.float32, torch.float64)
    degree = int(counts.max())
    for t in range(min(degree, SEG_REF_SLOTS) if on_host else degree):
        member = x[perm[(starts + t).clamp(max=last)].long()]
        out = torch.where((counts > t)[:, None], out + member, out)
    if on_host and degree > SEG_REF_SLOTS:
        rows = torch.nonzero(counts > SEG_REF_SLOTS).flatten()
        lo = (starts[rows] + SEG_REF_SLOTS).cpu().numpy()
        hi = (starts[rows] + counts[rows]).cpu().numpy()
        at = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)])
        tail = x[perm[torch.as_tensor(at, device=perm.device)].long()]
        tail = tail.cpu().numpy()
        acc = out[rows].cpu().numpy()
        edges = np.concatenate([[0], np.cumsum(hi - lo)])
        for i in range(len(lo)):
            # channels as rows: each channel's chain is contiguous
            chain = np.concatenate([acc[i:i + 1],
                                    tail[edges[i]:edges[i + 1]]]).T.copy()
            acc[i] = np.add.accumulate(chain, axis=1)[:, -1]
        out[rows] = torch.from_numpy(acc).to(out.device)
    return out


# csrc/segment_sum.cu's schedule: rows whose bounds a warp loads at once,
# edges whose rows it loads before adding any, a heavy stage's buffer
# (floats) and most members
SEG_RUN, SEG_INFLIGHT = 32, 8
SEG_STAGE_ELEMS, SEG_STAGE_ROWS = 16 * 256, 64


def segment_sum_sched_ref(x: torch.Tensor, perm: torch.Tensor,
                          indptr: torch.Tensor, chunk_rows: torch.Tensor,
                          heavy_rows: torch.Tensor, heavy: int
                          ) -> torch.Tensor:
    """The segment-sum kernel's schedule step by step (a plain emulation
    of ``csrc/segment_sum.cu``): what :func:`segment_sum_ref` computes,
    through the kernel's chunks, runs, load groups, channel slices and
    heavy stages, bitwise equal to it when the schedule adds each
    segment's members in j order and stores every output element once.

    Warp c walks rows ``chunk_rows[c]:chunk_rows[c + 1]`` in runs of
    SEG_RUN rows, each channel slice of 32·M (M = min(4, ⌈H/32⌉)) in
    turn: between the run's heavy rows (more than ``heavy`` members, which
    it skips) a flat walk of the edges, SEG_INFLIGHT rows loaded, then
    added in j order, a row stored when the walk passes its end (an empty
    one as 0). Each heavy row (``heavy_rows`` up to its first entry ≥ N)
    goes by the same channel slices in stages of min(SEG_STAGE_ROWS,
    SEG_STAGE_ELEMS // slice width) members, staged, then added in order.
    Raises AssertionError if an element is stored twice or never.
    """
    n, h = indptr.numel() - 1, x.shape[1]
    ip, pm = indptr.tolist(), perm.tolist()
    out = torch.zeros((n, h), dtype=x.dtype)
    stores = torch.zeros((n, h), dtype=torch.int32)
    width = 32 * min(4, -(-h // 32))

    def store(row, c0, acc):
        out[row, c0:c0 + acc.numel()] = acc
        stores[row, c0:c0 + acc.numel()] += 1

    bounds = chunk_rows.tolist()
    for rs, re in zip(bounds[:-1], bounds[1:]):
        for c0 in range(0, h, width):
            cols = slice(c0, min(h, c0 + width))
            zero = torch.zeros(cols.stop - c0, dtype=x.dtype)
            for rb in range(rs, re, SEG_RUN):
                nr = min(SEG_RUN, re - rb)
                ends = ip[rb + 1:rb + nr + 1]
                heavy_at = [t for t in range(nr)
                            if ends[t] - ip[rb + t] > heavy]
                t, j, acc = 0, ip[rb], zero
                while t < nr:
                    stop = next((r for r in heavy_at if r >= t), nr)
                    b = ip[rb + stop]
                    for jb in range(j, b, 32):  # one coalesced perm load
                        cnt = min(32, b - jb)
                        for k in range(0, cnt, SEG_INFLIGHT):
                            group = range(jb + k,
                                          jb + min(cnt, k + SEG_INFLIGHT))
                            loaded = [x[pm[e], cols] for e in group]
                            for e, v in zip(group, loaded):
                                while e >= ends[t]:
                                    store(rb + t, c0, acc)
                                    acc, t = zero, t + 1
                                acc = acc + v
                    while t < stop:
                        store(rb + t, c0, acc)
                        acc, t = zero, t + 1
                    if stop < nr:  # skip the heavy row
                        j, t = ends[stop], stop + 1
    for row in heavy_rows.tolist():
        if row >= n:
            break
        lo, hi = ip[row], ip[row + 1]
        for c0 in range(0, h, width):
            cw = min(width, h - c0)
            rows = min(SEG_STAGE_ROWS, SEG_STAGE_ELEMS // cw)
            acc = torch.zeros(cw, dtype=x.dtype)
            for first in range(lo, hi, rows):
                stage = x[perm[first:min(hi, first + rows)].long(),
                          c0:c0 + cw]
                for v in stage:
                    acc = acc + v
            store(row, c0, acc)
    if not bool((stores == 1).all()):
        bad = (stores != 1).nonzero()[0].tolist()
        raise AssertionError(f"segment_sum schedule: element {bad} stored "
                             f"{int(stores[bad[0], bad[1]])} times")
    return out


def kmeans_lloyd_ref(rep: torch.Tensor, init: torch.Tensor, iters: int = 8,
                     n_valid: Optional[int] = None, measure: str = "cosine",
                     normalize: bool = True):
    """Oracle for kernels.kmeans_lloyd: ``iters`` Lloyd steps from
    ``init``, then the assignment of all U rows; ``(centroids (C, n) f32,
    assign (U,) int32)``.

    Each step assigns the rows below ``n_valid`` (:func:`assign_clusters_ref`
    on rows and centroids L2-normalized by :func:`l2_normalize_ref` for
    cosine when ``normalize``, as the kernel normalizes them), then divides
    :func:`cell_sums_ref` over their raw rows by the exact counts (an IEEE
    division); a cell without members keeps its centroid.
    """
    rows = rep.float()
    nv = rows.shape[0] if n_valid is None else n_valid
    prep = (l2_normalize_ref if measure == "cosine" and normalize
            else (lambda x: x))
    scored = prep(rows)
    cent = init.float().clone()
    for _ in range(iters):
        a = assign_clusters_ref(scored[:nv], prep(cent), measure)
        sums, counts = cell_sums_ref(rows[:nv], a, cent.shape[0])
        cnt = counts.to(torch.float32)[:, None]
        cent = torch.where(cnt > 0, sums / cnt.clamp(min=1.0), cent)
    return cent, assign_clusters_ref(scored, prep(cent), measure)


def gathered_sims(q: torch.Tensor, cand: torch.Tensor, measure: str
                  ) -> torch.Tensor:
    """d2 scores (b, m) of each query row ``q (b, n)`` against its own
    candidate rows ``cand (b, m, n)`` — or against one candidate block
    ``cand (m, n)`` shared by every query — with the ``dense_similarity``
    algebra on raw rows: pearson centers both rows; cosine and pearson are
    z / max(√|q|²·√|c|², eps); euclidean 1/(1+√max(|q|² − 2z + |c|², 0)).

    Each score depends only on its two rows, whatever m is. Every sum runs
    over the landmark axis left to right with a rounding after each
    multiply and add, as the scorer and probe kernels sum, so on the card
    they agree bitwise.
    """
    q, cand = q.float(), cand.float()
    if measure == "pearson":
        q = q - _row_means(q)[:, None]
        cand = cand - _row_means(cand)[..., None]
    z = torch.zeros((q.shape[0], cand.shape[-2]), dtype=q.dtype,
                    device=q.device)
    for d in range(q.shape[-1]):
        z = z + q[:, None, d] * cand[..., d]
    nu = _row_sums(q * q)[:, None]
    nv = _row_sums(cand * cand)
    if measure in ("cosine", "pearson"):
        return z / (_sqrt(nu) * _sqrt(nv)).clamp(min=EPS)
    if measure == "euclidean":
        d2 = (nu - 2.0 * z + nv).clamp(min=0.0)
        return 1.0 / (1.0 + _sqrt(d2))
    raise ValueError(f"unknown measure {measure!r}")


def score_candidates_ref(q: torch.Tensor, cand: torch.Tensor,
                         measure: str = "cosine") -> torch.Tensor:
    """Oracle for kernels.score_candidates: :func:`gathered_sims`."""
    return gathered_sims(q, cand, measure)


INT_MAX = 2 ** 31 - 1


def fused_probe_topk_ref(q, probe, lists, rows, scale, fill, *, k: int,
                         measure: str = "cosine", self_ids=None,
                         probe_ok=None, block: int = 256):
    """Oracle for kernels.ivf_probe.fused_probe_topk: per query, the
    canonical top-k (value desc, id asc) over the live slots of its probed
    posting lists, scored with :func:`gathered_sims` on the dequantized
    payload (int8 rows times their f32 scale). Slots at or past the cell's
    fill, the query's own id and masked (query, probe rank) pairs are never
    selected; empty slots are (-inf, 0). Queries go in blocks of ``block``
    so the gathered candidates stay bounded."""
    b, nprobe = probe.shape
    cap = lists.shape[1]
    dev = q.device
    vals = torch.full((b, k), float("-inf"), dtype=torch.float32, device=dev)
    ids = torch.zeros((b, k), dtype=torch.int32, device=dev)
    slot = torch.arange(cap, device=dev)
    for b0 in range(0, b, block):
        pr = probe[b0:b0 + block].long()  # (qb, nprobe)
        qb = pr.shape[0]
        cand = rows[pr].float()  # (qb, nprobe, cap, n)
        if scale is not None:
            cand = cand * scale[pr][..., None]
        sims = gathered_sims(q[b0:b0 + block], cand.reshape(qb, -1,
                                                            cand.shape[-1]),
                             measure)
        cid = lists[pr].to(torch.int32)  # (qb, nprobe, cap)
        keep = slot[None, None, :] < fill[pr][..., None]
        if self_ids is not None:
            keep = keep & (cid != self_ids[b0:b0 + block, None, None])
        if probe_ok is not None:
            keep = keep & probe_ok[b0:b0 + block, :, None].bool()
        keep = keep.reshape(qb, -1)
        sims = sims.masked_fill(~keep, float("-inf"))
        cid = cid.reshape(qb, -1).masked_fill(~keep, INT_MAX)
        if sims.shape[1] < k:  # fewer slots than the list: the tail is empty
            pad = k - sims.shape[1]
            sims = torch.cat([sims, sims.new_full((qb, pad), float("-inf"))], 1)
            cid = torch.cat([cid, cid.new_full((qb, pad), INT_MAX)], 1)
        v, i = canonical_topk(sims, k, ids=cid)
        vals[b0:b0 + qb] = v
        ids[b0:b0 + qb] = torch.where(torch.isfinite(v), i,
                                      torch.zeros_like(i))
    return vals, ids


def landmark_summary_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Oracle for kernels.landmark_summary: softmax(q kᵀ · scale) v.

    q: (..., n, D), k/v: (..., S, D) → (..., n, D). Computed densely in f32.
    """
    s = (q.float() @ k.float().transpose(-1, -2)) * scale  # (..., n, S)
    return torch.softmax(s, dim=-1) @ v.float()


def landmark_summary_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, scale: float):
    """Oracle for kernels.landmark_summary_bwd: the gradients (dq, dk, dv)
    of :func:`landmark_summary_ref` at ``out`` = softmax(q kᵀ · scale) v,
    given ``dout``. Same batching as the forward; float32 throughout:

        P  = softmax(q kᵀ · scale)       (recomputed)
        Δᵢ = Σ_d dOᵢ_d · Oᵢ_d
        dV = Pᵀ dO
        dS = P ∘ (dO Vᵀ − Δ)
        dQ = scale · dS K,   dK = scale · dSᵀ q
    """
    qf, kf, vf = q.float(), k.float(), v.float()
    do, o = dout.float(), out.float()
    p = torch.softmax((qf @ kf.transpose(-1, -2)) * scale, dim=-1)
    delta = (do * o).sum(-1, keepdim=True)
    dv = p.transpose(-1, -2) @ do
    ds = p * (do @ vf.transpose(-1, -2) - delta)
    return (ds @ kf) * scale, (ds.transpose(-1, -2) @ qf) * scale, dv


def landmark_summary_bwd_tiled_ref(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, out: torch.Tensor,
                                   dout: torch.Tensor, scale: float,
                                   block: int = 64):
    """The backward kernel's two passes in plain torch, to check its
    arithmetic on the CPU; never on a model path. Pass 1 sweeps the key
    tiles of ``block`` keys once with a running max m and denominator l
    (log2 units, scores times c = scale·log2(e)), rescaling the dQ
    accumulator by 2^(m_old − m_new), and keeps lse = m + log2 l; pass 2
    recomputes P = 2^(s·c − lse) tile by tile for dK and dV. Keys past S are
    never in a tile (the kernel masks them). Returns (dq, dk, dv) float32.
    """
    qf, kf, vf = q.float(), k.float(), v.float()
    do = dout.float()
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        math.log2(math.e), dtype=torch.float32)
    delta = (do * out.float()).sum(-1, keepdim=True)
    m = torch.full(qf.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    tiles = range(0, kf.shape[-2], block)
    for k0 in tiles:  # pass 1
        kt, vt = kf[..., k0:k0 + block, :], vf[..., k0:k0 + block, :]
        st = (qf @ kt.transpose(-1, -2)) * c
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.where(m == float("-inf"), torch.zeros_like(m),
                            torch.exp2(m - m_new))
        p = torch.exp2(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + (p * (do @ vt.transpose(-1, -2) - delta)) @ kt
        m = m_new
    dq = acc * (scale / l)
    lse = m + torch.log2(l)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0 in tiles:  # pass 2
        kt, vt = kf[..., k0:k0 + block, :], vf[..., k0:k0 + block, :]
        p = torch.exp2((qf @ kt.transpose(-1, -2)) * c - lse)
        ds = p * (do @ vt.transpose(-1, -2) - delta)
        dv[..., k0:k0 + block, :] = p.transpose(-1, -2) @ do
        dk[..., k0:k0 + block, :] = (ds.transpose(-1, -2) @ qf) * scale
    return dq, dk, dv


def _hi_lo(x: torch.Tensor, split: bool = True):
    """f32 ``x`` as two bf16 terms hi = bf16(x), lo = bf16(x − hi), each
    returned as the f32 value it holds (lo = 0 unless ``split``)."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float() if split else torch.zeros_like(x)


def landmark_summary_bwd_split_ref(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, out: torch.Tensor,
                                   dout: torch.Tensor, scale: float, *,
                                   split: bool = True, block_k: int = 64,
                                   block_q: int = 64):
    """The backward kernel's tensor-core route (bf16 q, k, v) in plain
    torch, to check its numerics on the CPU; never on a model path.

    q, k, v are taken as bfloat16 (rounded if they are not), one term
    each; dO as two bf16 terms, hi and lo (:func:`bf16_terms`); every
    product is of bf16 values summed in f32, as ``wgmma`` sums them.

    Pass 1 sweeps key tiles of ``block_k`` keys with the forward's online
    statistics in log2 units (scores times c = scale·log2(e), running max
    m, alpha = 2^(m_old − m_new), 0 while m_old is −inf, denominator l
    summed from the f32 p = 2^(s − m_new)): dP = dO_lo Vᵀ + dO_hi Vᵀ,
    dS = p·(dP − Δ) with Δ = Σ dO·O in f32, split into ds_hi and ds_lo,
    and dQ accumulates (rescaled by alpha) ds_hi K + ds_lo K; dQ = acc ·
    scale / l, lse = m + log2 l. Pass 2 sweeps query tiles of ``block_q``
    rows for each key: Pᵀ = 2^(s·c − lse) and dSᵀ, each split in two, dV
    += p_hiᵀ dO_hi + p_hiᵀ dO_lo + p_loᵀ dO_hi and dK += ds_hiᵀ q +
    ds_loᵀ q, then dK times scale. ``split=False`` keeps the hi term
    alone of P, dS and dO (one bf16 term each, which the 1e-4 bound does
    not hold). ``block_k`` and ``block_q`` are the kernel's tiles (64 at
    every head dim). Returns (dq, dk, dv) float32.
    """
    terms = [bf16_terms(t.to(torch.bfloat16), 1).float() for t in (q, k, v)]
    return _split_bwd(*terms, out, dout, scale, split, block_k, block_q, ())


# the second-term products of the f32_split backward that
# landmark_summary_bwd_f32_split_ref can leave out: K1 in dQ, q1 in dK, V1
# in dP and dPᵀ
F32_BWD_SECOND_TERMS = ("k1", "q1", "v1")


def landmark_summary_bwd_f32_split_ref(q: torch.Tensor, k: torch.Tensor,
                                       v: torch.Tensor, out: torch.Tensor,
                                       dout: torch.Tensor, scale: float, *,
                                       block_k: int = 64, block_q: int = 64,
                                       drop=()):
    """The backward kernel's ``f32_split`` route (float32 q, k, v) in plain
    torch, to check its numerics on the CPU; never on a model path.

    q and k become three bf16 terms each and v two (:func:`bf16_terms`),
    dO two (hi, lo); every product is of bf16 values summed in f32. The
    loop is that of :func:`landmark_summary_bwd_split_ref`, 27 products of
    2·n·S·D in all. Pass 1: S takes the six q_a k_bᵀ with a + b < 3, the
    small ones first and q0 k0 last (q2k0, q1k1, q0k2, q1k0, q0k1, q0k0),
    as the forward's f32 route issues them; dP = dO_lo V0ᵀ + dO_hi V1ᵀ +
    dO_hi V0ᵀ; dQ += ds_hi K0 + ds_lo K0 + ds_hi K1. Pass 2: Sᵀ the six
    k_a q_bᵀ (k2q0, k1q1, k0q2, k1q0, k0q1, k0q0), dPᵀ = V0 dO_loᵀ + V1
    dO_hiᵀ + V0 dO_hiᵀ, dV += p_hi dO_hi + p_hi dO_lo + p_lo dO_hi,
    dK += ds_hi q0 + ds_lo q0 + ds_hi q1. ``drop`` leaves out the named
    second-term products (:data:`F32_BWD_SECOND_TERMS`), each of which the
    1e-4 bound needs. ``block_k`` is pass 1's key tile (64 keys at D ≤ 64,
    32 at D = 128), ``block_q`` pass 2's query tile (64 rows at D ≤ 64, 32
    at D = 128). Returns (dq, dk, dv) float32.
    """
    unknown = set(drop) - set(F32_BWD_SECOND_TERMS)
    if unknown:
        raise ValueError(f"drop: unknown terms {sorted(unknown)}")
    terms = [bf16_terms(t, n).float()
             for t, n in ((q, 3), (k, 3), (v, 2))]
    return _split_bwd(*terms, out, dout, scale, True, block_k, block_q,
                      tuple(drop))


def _split_bwd(qt, kt, vt, out, dout, scale: float, split: bool,
               block_k: int, block_q: int, drop):
    """The tensor-core backward's two passes on bf16 terms: ``qt``, ``kt``
    (terms, ..., rows, D) and ``vt`` (v_terms, ..., S, D) as f32 values of
    bf16 numbers; one term each for bf16 inputs, 3/3/2 for f32 inputs.
    Products are issued in the kernel's order; with one term each it is
    the bf16 route's 13 products."""
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        math.log2(math.e), dtype=torch.float32)
    n_terms = qt.shape[0]
    pairs = [(a, s - a) for s in range(n_terms - 1, -1, -1)
             for a in range(s, -1, -1)]
    q0, k0_, v0 = qt[0], kt[0], vt[0]
    q1 = qt[1] if n_terms > 1 and "q1" not in drop else None
    k1 = kt[1] if n_terms > 1 and "k1" not in drop else None
    v1 = vt[1] if vt.shape[0] > 1 and "v1" not in drop else None
    do_hi, do_lo = _hi_lo(dout.float(), split)
    delta = (dout.float() * out.float()).sum(-1, keepdim=True)
    m = torch.full(q0.shape[:-1] + (1,), float("-inf"), device=q0.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q0)
    t = lambda x: x.transpose(-1, -2)  # noqa: E731
    for j in range(0, kt.shape[-2], block_k):  # pass 1
        keys = slice(j, j + block_k)
        s = torch.zeros((), device=q0.device)
        for a, b in pairs:
            s = s + qt[a] @ t(kt[b][..., keys, :])
        s = s * c
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.where(m == float("-inf"), torch.zeros_like(m),
                            torch.exp2(m - m_new))
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        vk = v0[..., keys, :]
        dp = do_lo @ t(vk)
        if v1 is not None:
            dp = dp + do_hi @ t(v1[..., keys, :])
        dp = dp + do_hi @ t(vk)
        ds_hi, ds_lo = _hi_lo(p * (dp - delta), split)
        kk = k0_[..., keys, :]
        tile = ds_hi @ kk + ds_lo @ kk
        if k1 is not None:
            tile = tile + ds_hi @ k1[..., keys, :]
        acc = acc * alpha + tile  # the f32 form's tile sum
        m = m_new
    dq = acc * scale / l
    lse = m + torch.log2(l)
    dk, dv = torch.zeros_like(k0_), torch.zeros_like(v0)
    for i in range(0, qt.shape[-2], block_q):  # pass 2
        rows = slice(i, i + block_q)
        hi, lo = do_hi[..., rows, :], do_lo[..., rows, :]
        st = torch.zeros((), device=q0.device)
        for a, b in pairs:  # k_a q_bᵀ: the kernel's A operand is K
            st = st + kt[a] @ t(qt[b][..., rows, :])  # (S, rows)
        pt = torch.exp2(st * c - lse[..., rows, 0][..., None, :])
        dpt = v0 @ t(lo)
        if v1 is not None:
            dpt = dpt + v1 @ t(hi)
        dpt = dpt + v0 @ t(hi)
        p_hi, p_lo = _hi_lo(pt, split)
        ds_hi, ds_lo = _hi_lo(pt * (dpt - delta[..., rows, 0][..., None, :]),
                              split)
        dv = dv + (p_hi @ hi + p_hi @ lo + p_lo @ hi)
        qr = q0[..., rows, :]
        tile = ds_hi @ qr + ds_lo @ qr
        if q1 is not None:
            tile = tile + ds_hi @ q1[..., rows, :]
        dk = dk + tile
    return dq, dk * scale, dv


def bf16_terms(x: torch.Tensor, terms: int) -> torch.Tensor:
    """Oracle for kernels.landmark_attention.bf16_terms: ``x`` as a sum of
    ``terms`` bfloat16 values, (terms, *x.shape). x0 = bf16(x),
    x1 = bf16(x − x0), x2 = bf16(x − x0 − x1), each rounded to nearest;
    every subtraction is exact in f32, and three terms hold a normal f32
    value exactly (8 + 8 + 8 significant bits)."""
    out, r = [], x.float()
    for _ in range(terms):
        t = r.bfloat16()
        out.append(t)
        r = r - t.float()
    return torch.stack(out)


def _split_flash(qt, kt, vt, scale: float, block: int, p_terms: int
                 ) -> torch.Tensor:
    """The tensor-core loop's arithmetic on bf16 terms: ``qt``/``kt``
    (terms, ..., rows, D) and ``vt`` (v_terms, ..., S, D), bf16 values.

    Keys go in tiles of ``block``. Scores are the products q_a k_bᵀ with
    a + b < terms, bf16 products summed in f32, the small ones first and
    q0 k0 last (the kernel's issue order), times c = scale·log2(e); a
    running max m, alpha = 2^(m_old − m_new) (0 while m_old is −inf),
    p = 2^(s − m_new), z summed from the f32 p; PV takes p as
    p_hi = bf16(p) and, with ``p_terms`` 2, p_lo = bf16(p − p_hi), each a
    bf16 product summed in f32: p_hi v0, p_lo v0, then p_hi v1 when v has
    two terms. Returns acc / max(z, 1e-30), float32.
    """
    qt, kt, vt = (t.float() for t in (qt, kt, vt))
    terms = qt.shape[0]
    pairs = [(a, s - a) for s in range(terms - 1, -1, -1)
             for a in range(s, -1, -1)]
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        math.log2(math.e), dtype=torch.float32)
    m = torch.full(qt.shape[1:-1], float("-inf"), dtype=torch.float32,
                   device=qt.device)
    z = torch.zeros_like(m)
    acc = torch.zeros_like(qt[0])
    for k0 in range(0, kt.shape[-2], block):
        ktile, vtile = kt[..., k0:k0 + block, :], vt[..., k0:k0 + block, :]
        s = torch.zeros(())
        for a, b in pairs:
            s = s + qt[a] @ ktile[b].transpose(-1, -2)
        s = s * c
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.where(m == float("-inf"), torch.zeros_like(m),
                            torch.exp2(m - m_new))
        p = torch.exp2(s - m_new[..., None])
        z = z * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        acc = acc * alpha[..., None] + hi @ vtile[0]
        if p_terms == 2:
            acc = acc + (p - hi).bfloat16().float() @ vtile[0]
        if vtile.shape[0] == 2:
            acc = acc + hi @ vtile[1]
        m = m_new
    return acc / z.clamp(min=1e-30)[..., None]


def landmark_summary_split_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, scale: float, *,
                               split: bool = True, block: int = 128
                               ) -> torch.Tensor:
    """The tensor-core kernel's arithmetic on bfloat16 inputs
    (``kernels.landmark_summary``'s ``tensor_core`` route) in plain torch,
    to check its numerics on the CPU; never on a model path.

    q, k, v are taken as bfloat16 (rounded if they are not), one term each;
    the loop is :func:`_split_flash` with P split into two bf16 terms
    (``split=False``: p_hi alone, which the 1e-4 bound does not hold).
    Returns (..., n, D) float32.
    """
    q, k, v = (bf16_terms(t.to(torch.bfloat16), 1) for t in (q, k, v))
    return _split_flash(q, k, v, scale, block, 2 if split else 1)


def landmark_summary_f32_split_ref(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, scale: float, *,
                                   qk_terms: int = 3, block: int = 128
                                   ) -> torch.Tensor:
    """The ``f32_split`` route's arithmetic on float32 inputs in plain
    torch, to check its numerics on the CPU; never on a model path.

    q and k become ``qk_terms`` bf16 terms each and v two
    (:func:`bf16_terms`); q̃Kᵀ takes the products q_a k_bᵀ with
    a + b < qk_terms (six for three terms: q2k0, q1k1, q0k2, q1k0, q0k1,
    q0k0, in that order), PV the three p_hi v0, p_lo v0, p_hi v1; the loop
    is :func:`_split_flash`. ``block`` is the kernel's key tile (128 keys at
    D ≤ 64, 32 above). Returns (..., n, D) float32.
    """
    return _split_flash(bf16_terms(q, qk_terms), bf16_terms(k, qk_terms),
                        bf16_terms(v, 2), scale, block, 2)
