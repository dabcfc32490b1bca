"""IVF (inverted-file) index over the landmark embedding — sublinear search.

A k-means coarse quantizer (``kmeans.py``) partitions the (U, n) rows into
``C`` cells; each cell keeps a fixed-capacity padded posting list of its
member ids and their vectors, and :func:`search` scores only the rows of
the ``nprobe`` cells nearest to each query — O((U/C)·nprobe·n) per query
instead of O(U·n).

Layout (every shape fixed, every fill a count):

    centroids  (C, n)       f32   the coarse quantizer
    lists      (C, cap)     i32   member row ids, padded; slot >= fill[c] inert
    rows       (C, cap, n)  f32|bf16|int8  member vectors, same slots
    fill       (C,)         i32   live entries per list
    scale      (C, cap)     f32   int8 dequantization scales (int8 only)

Invariant: every valid row id sits in exactly one posting list. A row whose
home cell is full goes to its next-nearest cell with room (one placement
round per preference rank), so overflow costs recall, never correctness;
:func:`ensure_index_capacity` regrows ``cap`` between appends.

Scorers of :func:`search`:

- ``plain`` — the reference's ``jnp`` path: at partial probe the gathered
  candidates are scored with ``kernels.ref.gathered_sims`` and ranked with a
  positional top-k over the (probe rank, slot) columns; at full probe one
  shared id-sorted candidate matrix is scored with the same
  ``gathered_sims`` sums. (The reference scores full probe with a GEMM,
  which XLA rounds as its multiply-reduce; ``torch.matmul`` does not, and
  where a query's top-k scores lie within a few ulps of each other — the
  drifting stream's — a GEMM-scored exact search would miss partial-probe
  neighbors by rounding alone, at every nprobe below C);
- ``kernel`` — the reference's ``pallas`` path: the partial probe scored by
  the gathered-candidate kernel (``kernels/score_candidates.py``), full
  probe by ``dense_similarity``, the streaming backend's algebra, as the
  reference does;
- ``fused`` — the one-pass probe kernel (``kernels/ivf_probe.py``): gather,
  score and a (value desc, id asc) top-k, for every nprobe;
- ``auto`` — ``fused`` for a CUDA tensor, ``plain`` for a CPU tensor.

Two tie rules, as in the reference: ``plain``/``kernel`` rank by position
(ties to the earlier probe rank and slot), ``fused`` by the lowest id. At
full probe both are exact; on the card the fused kernel sums in a fixed
order and the streaming backend through ``torch.matmul``, so they agree
under the tie rule of ``core.topk.list_mismatches``.

Payloads are stored as ``f32`` (exact), ``bf16``, or ``int8`` with one f32
scale per row (``scale = max|row|/127``); ids, fills and centroids stay
full precision, placement is computed from the unquantized rows, and
scoring dequantizes after the gather.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.similarity import EPS, dense_similarity
from ..core.topk import canonical_topk
from ..core.types import round_up
from ..kernels import ivf_probe, ref
from ..kernels.score_candidates import score_candidates
from .kmeans import kmeans

SCORERS = ("plain", "kernel", "fused", "auto")
PAYLOAD_DTYPES = ("f32", "bf16", "int8")
INT_MAX = ref.INT_MAX
INV_127 = float(np.float32(1.0 / 127.0))  # the f32 reciprocal of 127


@dataclasses.dataclass(frozen=True)
class IVFSpec:
    """Knobs of the IVF index.

    ``n_clusters``/``nprobe`` None derive from U at build time
    (:func:`resolve_ivf`: C ≈ √U, nprobe ≈ C/4). ``slack`` sizes the posting
    lists (cap = ⌈U·slack/C⌉ rounded up to 8); ``seed`` seeds the k-means
    initialization so rebuilds are reproducible; ``spill_choices`` is the
    overflow placement depth (0: all C cells in preference order).
    """

    n_clusters: Optional[int] = None
    nprobe: Optional[int] = None
    iters: int = 8
    slack: float = 1.25
    spill_choices: int = 0
    seed: int = 0
    assign_backend: str = "auto"  # kmeans assignment: plain|kernel|auto
    payload_dtype: str = "f32"  # stored payload rows: f32|bf16|int8


def resolve_ivf(spec: Optional[IVFSpec], u: int) -> IVFSpec:
    """Concrete (n_clusters, nprobe, spill depth) for a U-row index:
    C ≈ √U cells, a quarter of them probed, overflow placed down the full
    cell-preference order."""
    spec = spec or IVFSpec()
    c = spec.n_clusters or int(round(math.sqrt(max(u, 1))))
    c = max(1, min(c, max(u, 1)))
    nprobe = min(max(spec.nprobe or max(1, c // 4), 1), c)
    t = c if spec.spill_choices <= 0 else min(spec.spill_choices, c)
    return dataclasses.replace(spec, n_clusters=c, nprobe=nprobe,
                               spill_choices=t)


@dataclasses.dataclass(frozen=True)
class IVFIndex:
    """The servable index: posting lists that carry their members' vectors,
    so probing a cell reads one contiguous (cap, n) block."""

    centroids: torch.Tensor  # (C, n) f32 coarse quantizer
    lists: torch.Tensor  # (C, cap) int32 member ids (uint16 when compact)
    rows: torch.Tensor  # (C, cap, n) member vectors (f32|bf16|int8)
    fill: torch.Tensor  # (C,) int32 live entries per list
    scale: Optional[torch.Tensor] = None  # (C, cap) f32 int8 scales

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def payload_dtype(self) -> str:
        """Stored payload precision, read from the rows themselves."""
        if self.rows.dtype == torch.int8:
            return "int8"
        return "bf16" if self.rows.dtype == torch.bfloat16 else "f32"

    @property
    def capacity(self) -> int:
        return self.lists.shape[1]

    @property
    def is_compact(self) -> bool:
        return self.lists.dtype != torch.int32

    def to_compact(self) -> "IVFIndex":
        """uint16 posting lists (ids must fit 16 bits)."""
        slot = torch.arange(self.capacity, device=self.lists.device)
        live = slot[None, :] < self.fill[:, None]
        top = int(torch.where(live, self.lists, torch.zeros_like(self.lists)
                              ).max()) if self.lists.numel() else 0
        if top > 65535:
            raise ValueError(
                f"compact posting lists are uint16: max id {top} exceeds 65535")
        return dataclasses.replace(self, lists=self.lists.to(torch.uint16))

    def to_full(self) -> "IVFIndex":
        return dataclasses.replace(self, lists=self.lists.to(torch.int32))


# ------------------------------------------------------- payload quantization
def quantize_payload(payload: torch.Tensor, payload_dtype: str
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, n) f32 rows -> (stored rows, per-row scales or None).

    int8 scales each row symmetrically (``scale = max|row|/127``) and
    rounds half to even, as the reference's ``jnp.round``; a zero row
    stores zeros with scale 0. The scale is ``max|row|`` times the f32
    reciprocal of 127, as the compiled reference computes it (XLA turns
    the division by a constant into that multiply), so an index built by
    either package holds the same scales."""
    if payload_dtype == "f32":
        return payload, None
    if payload_dtype == "bf16":
        return payload.to(torch.bfloat16), None
    if payload_dtype == "int8":
        amax = payload.abs().amax(dim=-1)
        scale = amax * torch.full_like(amax, INV_127)
        q = torch.round(payload / scale.clamp(min=EPS)[..., None])
        return q.to(torch.int8), scale.to(torch.float32)
    raise ValueError(
        f"unknown payload_dtype {payload_dtype!r}; expected {PAYLOAD_DTYPES}")


def dequantize_payload(stored: torch.Tensor, scale: Optional[torch.Tensor]
                       ) -> torch.Tensor:
    """Inverse of :func:`quantize_payload` (the identity on f32 rows)."""
    if stored.dtype == torch.float32 and scale is None:
        return stored
    x = stored.to(torch.float32)
    return x * scale[..., None] if scale is not None else x


# ---------------------------------------------------------------- placement
def _segment_count(ok: torch.Tensor, seg: torch.Tensor, c: int
                   ) -> torch.Tensor:
    """(C,) count of ``ok`` rows per segment; rows not ok go to a dump
    segment ``c`` that is sliced off."""
    dest = torch.where(ok, seg, torch.full_like(seg, c))
    return torch.zeros(c + 1, dtype=torch.int32, device=seg.device
                       ).index_add_(0, dest, ok.to(torch.int32))[:-1]


def _place_round_plan(fill: torch.Tensor, clusters: torch.Tensor,
                      todo: torch.Tensor, c: int, cap: int):
    """One placement round, destinations only: each unplaced row lands at
    ``fill[cell] + rank`` of its target cell (rank = arrival order within the
    batch's same-cell group, by one stable sort); rows that would cross
    ``cap`` stay unplaced. Returns ``(fill, dest_c, dest_s, placed)`` in
    batch order."""
    b = clusters.shape[0]
    dev = clusters.device
    key = torch.where(todo, clusters.long(), torch.full((b,), c, device=dev))
    sc, order = torch.sort(key, stable=True)
    rank = torch.arange(b, device=dev) - torch.searchsorted(sc, sc)
    scl = sc.clamp(0, c - 1)
    desired = fill[scl].long() + rank
    fits = todo[order] & (sc < c) & (desired < cap)
    fill = fill + _segment_count(fits, scl, c)
    dest_c = torch.zeros(b, dtype=torch.long, device=dev)
    dest_s = torch.zeros(b, dtype=torch.long, device=dev)
    placed = torch.zeros(b, dtype=torch.bool, device=dev)
    dest_c[order] = scl
    dest_s[order] = desired
    placed[order] = fits
    return fill, dest_c, dest_s, placed


def _spill_plan(fill: torch.Tensor, todo: torch.Tensor, c: int, cap: int):
    """Last-resort destinations: the m-th leftover row takes the m-th free
    slot in (cell, slot) order. Rows beyond the free slots are dropped:
    callers reserve room first (:func:`ensure_index_capacity` or
    :func:`grow_capacity`)."""
    m_rank = torch.cumsum(todo.long(), 0) - 1
    free = cap - fill.long()
    fstart = torch.cat([torch.zeros(1, dtype=torch.long, device=fill.device),
                        torch.cumsum(free, 0)])
    dest_c = (torch.searchsorted(fstart, m_rank, right=True) - 1
              ).clamp(0, c - 1)
    dest_s = fill[dest_c].long() + (m_rank - fstart[dest_c])
    ok = todo & (m_rank < fstart[-1])
    return fill + _segment_count(ok, dest_c, c), dest_c, dest_s, ok


def place_plan(fill: torch.Tensor, choices: torch.Tensor,
               valid: torch.Tensor, cap: int):
    """Placement plan ``(dest_c, dest_s, ok, new_fill)`` per batch row.

    Round r places every still-unplaced row into its r-th preferred cell
    (``choices (B, T)``, best first) while that cell has room; leftovers
    spill to free slots in order. Destinations depend only on
    ``(fill, choices, valid)``, and every (cell, slot) is written at most
    once, so one scatter applies the whole plan. Rounds stop early once
    every row is placed (the later rounds would change nothing).
    """
    b = choices.shape[0]
    c = fill.shape[0]
    dev = choices.device
    placed = ~valid  # invalid rows: pretend placed (== dropped)
    dest_c = torch.zeros(b, dtype=torch.long, device=dev)
    dest_s = torch.zeros(b, dtype=torch.long, device=dev)
    ok_any = torch.zeros(b, dtype=torch.bool, device=dev)
    for r in range(choices.shape[1]):
        if bool(placed.all()):
            break
        fill, dc, ds, ok = _place_round_plan(fill, choices[:, r], ~placed,
                                             c, cap)
        dest_c = torch.where(ok, dc, dest_c)
        dest_s = torch.where(ok, ds, dest_s)
        placed = placed | ok
        ok_any = ok_any | ok
    fill, dc, ds, ok = _spill_plan(fill, ~placed, c, cap)
    dest_c = torch.where(ok, dc, dest_c)
    dest_s = torch.where(ok, ds, dest_s)
    return dest_c, dest_s, ok_any | ok, fill


def _place(lists, rows, scale, fill, ids, payload, pscale, choices, valid):
    """Plan + apply: scatter a batch into the posting lists. Rows that are
    not placed are written to a dump cell ``C`` that is sliced off."""
    c, cap = lists.shape
    dest_c, dest_s, ok, new_fill = place_plan(fill, choices, valid, cap)
    cc = torch.where(ok, dest_c, torch.full_like(dest_c, c))
    ss = torch.where(ok, dest_s, torch.zeros_like(dest_s))

    def scatter(table, values):
        ext = torch.cat([table, table.new_zeros((1,) + table.shape[1:])])
        ext[cc, ss] = values.to(table.dtype)
        return ext[:c]

    lists = scatter(lists, ids)
    rows = scatter(rows, payload)
    if scale is not None:
        scale = scatter(scale, pscale)
    return lists, rows, scale, new_fill


def _list_choices(rep: torch.Tensor, centroids: torch.Tensor, measure: str,
                  n_choices: int) -> torch.Tensor:
    """(B, T) nearest-cell preference per row, T clamped to C; ties to the
    lower cell id, as ``lax.top_k``."""
    sims = dense_similarity(rep.to(torch.float32), centroids, measure)
    return canonical_topk(sims, min(n_choices, centroids.shape[0]))[1]


def build_index(rep: torch.Tensor, spec: IVFSpec, measure: str = "cosine",
                n_valid: Optional[int] = None, *,
                generator: Optional[torch.Generator] = None,
                centroids: Optional[torch.Tensor] = None) -> IVFIndex:
    """k-means the rows and pack the posting lists — the full (re)build.

    ``spec`` must be resolved (:func:`resolve_ivf`). Rows ``>= n_valid`` are
    padding and stay out of the index. ``cap = round_up(⌈U·slack/C⌉, 8)``
    guarantees ``C·cap >= U``. ``generator`` seeds the k-means
    initialization (default: ``spec.seed``); ``centroids`` skips k-means
    altogether and packs around the given quantizer.
    """
    if spec.n_clusters is None:
        raise ValueError("build_index needs a resolved IVFSpec "
                         "(resolve_ivf(spec, u) fixes n_clusters/nprobe)")
    u = rep.shape[0]
    dev = rep.device
    c = spec.n_clusters
    cap = round_up(max(-(-int(u * spec.slack) // c), 1), 8)
    if centroids is None:
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(spec.seed)
        centroids, _ = kmeans(rep, c, measure, iters=spec.iters,
                              n_valid=n_valid, backend=spec.assign_backend,
                              generator=gen)
    cent = centroids.to(device=dev, dtype=torch.float32)
    valid = (torch.arange(u, device=dev) < n_valid) if n_valid is not None \
        else torch.ones(u, dtype=torch.bool, device=dev)
    choices = _list_choices(rep, cent, measure, spec.spill_choices or c)
    payload, pscale = quantize_payload(rep.to(torch.float32),
                                       spec.payload_dtype)
    lists = torch.zeros((c, cap), dtype=torch.int32, device=dev)
    rows = torch.zeros((c, cap, rep.shape[1]), dtype=payload.dtype,
                       device=dev)
    scale = None if pscale is None else torch.zeros((c, cap), device=dev)
    fill = torch.zeros(c, dtype=torch.int32, device=dev)
    lists, rows, scale, fill = _place(
        lists, rows, scale, fill, torch.arange(u, dtype=torch.int32,
                                               device=dev),
        payload, pscale, choices, valid)
    return IVFIndex(cent, lists, rows, fill, scale)


def append(index: IVFIndex, new_rep: torch.Tensor, new_ids: torch.Tensor,
           measure: str = "cosine", b_valid: Optional[int] = None,
           spill_choices: int = 0) -> IVFIndex:
    """Route each new row to its nearest centroid under the frozen quantizer
    (rows ``>= b_valid`` are filler and dropped). An index with fewer free
    slots than the batch drops the remainder: reserve room first with
    :func:`ensure_index_capacity` or :func:`grow_capacity`."""
    if index.is_compact:
        index = index.to_full()
    b = new_rep.shape[0]
    dev = new_rep.device
    valid = (torch.arange(b, device=dev) < b_valid) if b_valid is not None \
        else torch.ones(b, dtype=torch.bool, device=dev)
    t = index.n_clusters if spill_choices <= 0 else spill_choices
    choices = _list_choices(new_rep, index.centroids, measure, t)
    payload, pscale = quantize_payload(new_rep.to(torch.float32),
                                       index.payload_dtype)
    lists, rows, scale, fill = _place(
        index.lists, index.rows, index.scale, index.fill,
        new_ids.to(torch.int32), payload, pscale, choices, valid)
    return IVFIndex(index.centroids, lists, rows, fill, scale)


def grow_capacity(index: IVFIndex, new_cap: int) -> IVFIndex:
    """Per-list capacity regrow: pad every list to ``new_cap`` slots (fills
    untouched, padded slots inert)."""
    if new_cap <= index.capacity:
        return index
    pad = new_cap - index.capacity

    def widen(x):
        shape = (x.shape[0], pad) + tuple(x.shape[2:])
        return torch.cat([x, x.new_zeros(shape)], dim=1)

    return IVFIndex(index.centroids, widen(index.lists), widen(index.rows),
                    index.fill,
                    None if index.scale is None else widen(index.scale))


def ensure_index_capacity(index: IVFIndex, incoming: int,
                          slack: float = 1.25) -> Tuple[IVFIndex, bool]:
    """Regrow ``cap`` before an append of ``incoming`` rows when the fullest
    list could overflow (the whole batch landing in one cell). Returns
    ``(index, grew)``; reads one device scalar, ``max(fill)``."""
    idx = index.to_full() if index.is_compact else index
    top = int(idx.fill.max()) if idx.n_clusters else 0
    if top + incoming <= idx.capacity:
        return index, False
    new_cap = round_up(max(int((top + incoming) * slack), top + incoming), 8)
    return grow_capacity(idx, new_cap), True


# ------------------------------------------------------------------- search
def _padded_topk(vals: torch.Tensor, ids: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over (vals, ids) columns with ``lax.top_k``'s positional tie
    rule (equal values: the earlier column), padding the columns up to k
    with (-inf, 0)."""
    m = vals.shape[1]
    if m < k:
        vals = torch.cat([vals, vals.new_full((vals.shape[0], k - m),
                                              float("-inf"))], 1)
        ids = torch.cat([ids, ids.new_zeros((ids.shape[0], k - m))], 1)
    v, sel = canonical_topk(vals, k)
    return v, ids.gather(1, sel)


def resolve_scorer(scorer: str, device) -> str:
    """``auto`` → ``fused`` for a CUDA ``device``, ``plain`` for a CPU one."""
    if scorer == "auto":
        return "fused" if torch.device(device).type == "cuda" else "plain"
    if scorer not in SCORERS:
        raise ValueError(f"unknown scorer {scorer!r}; expected {SCORERS}")
    return scorer


def probe_cells(index: IVFIndex, queries: torch.Tensor, nprobe: int,
                measure: str) -> torch.Tensor:
    """(b, nprobe) int32: each query's nprobe nearest cells, nearest first
    (ties to the lower cell id) — distinct per query."""
    csims = dense_similarity(queries.to(torch.float32), index.centroids,
                             measure)
    return canonical_topk(csims, nprobe)[1].to(torch.int32)


def search(index: IVFIndex, queries: torch.Tensor, k: int, nprobe: int,
           measure: str = "cosine", *, self_ids: Optional[torch.Tensor] = None,
           qb: int = 256, scorer: str = "auto",
           tomb: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (vals, ids) per query over its ``nprobe`` nearest cells.

    ``self_ids`` (b,) names an id each query never lists; ``tomb`` (U,) bool
    masks tombstoned ids (the fused kernel takes no tombstones, so with
    ``tomb`` the ``fused`` scorer gives way to ``kernel``: the gathered
    scorer at partial probe). Queries go in
    ``qb``-row blocks so the gathered (qb, nprobe·cap, n) candidates stay
    bounded. At ``nprobe == n_clusters`` the ``plain``/``kernel`` scorers
    score one id-sorted candidate matrix (``plain`` with its partial-probe
    sums, ``kernel`` with ``dense_similarity``). Empty slots hold -inf (and
    id 0 from the fused scorer); feed through ``graph.finalize_topk`` for a
    graph.
    """
    if index.is_compact:
        index = index.to_full()
    c, cap = index.n_clusters, index.capacity
    n = index.rows.shape[2]
    nprobe = min(nprobe, c)
    b = queries.shape[0]
    dev = queries.device
    q = queries.to(torch.float32).contiguous()
    sids = torch.full((b,), -1, dtype=torch.int32, device=dev)
    if self_ids is not None:
        sids = self_ids.to(device=dev, dtype=torch.int32)
    slot = torch.arange(cap, device=dev)
    mode = resolve_scorer(scorer, dev)

    if mode == "fused":
        if tomb is not None:  # the fused kernel takes no tombstones
            mode = "kernel"
        else:
            probe = probe_cells(index, q, nprobe, measure)
            return ivf_probe.fused_probe_topk(
                q, probe, index.lists, index.rows, index.scale, index.fill,
                k=k, measure=measure, self_ids=sids)

    out_v, out_i = [], []
    if nprobe >= c:
        # every cell probed: one shared candidate matrix sorted by id, so
        # the positional tie rule is the id-ascending one
        flat = index.lists.reshape(-1)
        fvalid = (slot[None, :] < index.fill[:, None]).reshape(-1)
        order = torch.sort(torch.where(fvalid, flat, torch.full_like(
            flat, INT_MAX)), stable=True).indices
        flat, fvalid = flat[order], fvalid[order]
        cmat = dequantize_payload(
            index.rows.reshape(c * cap, n)[order],
            None if index.scale is None else index.scale.reshape(-1)[order])
        invalid_col = ~fvalid
        if tomb is not None:
            invalid_col = invalid_col | (fvalid & tomb[flat.long()])
        for b0 in range(0, b, qb):
            qq, ss = q[b0:b0 + qb], sids[b0:b0 + qb]
            sims = (ref.gathered_sims(qq, cmat, measure) if mode == "plain"
                    else dense_similarity(qq, cmat, measure))
            invalid = invalid_col[None, :] | (flat[None, :] == ss[:, None])
            v, i = _padded_topk(sims.masked_fill(invalid, float("-inf")),
                                flat.expand(qq.shape[0], -1), k)
            out_v.append(v)
            out_i.append(i)
    else:
        probe = probe_cells(index, q, nprobe, measure).long()
        m = nprobe * cap
        for b0 in range(0, b, qb):
            qq, pr, ss = q[b0:b0 + qb], probe[b0:b0 + qb], sids[b0:b0 + qb]
            nq = qq.shape[0]
            rows = dequantize_payload(
                index.rows[pr].reshape(nq, m, n),
                None if index.scale is None
                else index.scale[pr].reshape(nq, m)).contiguous()
            cc = index.lists[pr].reshape(nq, m)
            live = (slot[None, None, :] < index.fill[pr][..., None]
                    ).reshape(nq, m)
            sims = (score_candidates(qq, rows, measure) if mode == "kernel"
                    else ref.gathered_sims(qq, rows, measure))
            invalid = ~live | (cc == ss[:, None])
            if tomb is not None:
                invalid = invalid | tomb[cc.long()]
            v, i = _padded_topk(sims.masked_fill(invalid, float("-inf")), cc,
                                k)
            out_v.append(v)
            out_i.append(i)
    if not out_v:
        return (torch.full((0, k), float("-inf"), device=dev),
                torch.zeros((0, k), dtype=torch.int32, device=dev))
    return torch.cat(out_v), torch.cat(out_i)


def purge(index: IVFIndex, tomb: torch.Tensor) -> IVFIndex:
    """Drop tombstoned ids ((U,) bool ``tomb``) from every posting list.

    Each cell's survivors slide down in slot order (a stable partition, so
    arrival order and the positional tie rule are kept), fills shrink by
    the cell's dead count, and freed slots reset to (id 0, zero payload).
    Ids are kept as they are: after a compaction of the row space, rebuild
    or remap the index instead. Between purges, ``search(..., tomb=)``
    keeps deleted rows out of results."""
    full = index.to_full() if index.is_compact else index
    cap = full.capacity
    slot = torch.arange(cap, device=full.lists.device)
    valid = slot[None, :] < full.fill[:, None]  # (C, cap)
    keep = valid & ~tomb[full.lists.long()]
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    lists = full.lists.gather(1, order)
    rows = full.rows.gather(1, order[..., None].expand_as(full.rows))
    scale = None if full.scale is None else full.scale.gather(1, order)
    fill = keep.sum(dim=1).to(full.fill.dtype)
    live = slot[None, :] < fill[:, None]
    return IVFIndex(
        full.centroids,
        torch.where(live, lists, torch.zeros_like(lists)).to(
            index.lists.dtype),
        torch.where(live[..., None], rows, torch.zeros_like(rows)),
        fill,
        None if scale is None else torch.where(live, scale,
                                               torch.zeros_like(scale)))


def search_early_exit(index: IVFIndex, queries: torch.Tensor, k: int,
                      nprobe: int, measure: str = "cosine", *,
                      self_ids: Optional[torch.Tensor] = None,
                      patience: int = 2, tomb: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-query early-terminated probe.

    Cells are visited nearest first; a query stops scoring once its running
    top-k has been unchanged by ``patience`` consecutive cells, and
    ``nprobe`` stays the budget. Returns ``(vals, ids, probed)`` with
    ``probed`` (b,) int32 the cells each query scored. Each probe rank
    scores the (b, cap) gathered rows with the gathered-candidate scorer
    (the kernel on a CUDA tensor, its plain version on a CPU tensor: the
    same function bitwise) and merges positionally, best list first, so
    the result equals :func:`search` with the ``plain`` scorer whenever no
    query exits early.
    """
    if index.is_compact:
        index = index.to_full()
    c, cap = index.n_clusters, index.capacity
    nprobe = min(max(nprobe, 1), c)
    patience = max(int(patience), 1)
    b = queries.shape[0]
    dev = queries.device
    q = queries.to(torch.float32).contiguous()
    sids = (self_ids.to(device=dev, dtype=torch.int32) if self_ids is not None
            else torch.full((b,), -1, dtype=torch.int32, device=dev))
    probe = probe_cells(index, q, nprobe, measure).long()
    slot = torch.arange(cap, device=dev)
    vals = torch.full((b, k), float("-inf"), device=dev)
    ids = torch.zeros((b, k), dtype=torch.int32, device=dev)
    stable = torch.zeros(b, dtype=torch.int32, device=dev)
    probed = torch.zeros(b, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    for j in range(nprobe):
        pr = probe[:, j]
        rows = dequantize_payload(
            index.rows[pr], None if index.scale is None else index.scale[pr]
        ).contiguous()
        cc = index.lists[pr]
        live = slot[None, :] < index.fill[pr][:, None]
        sims = score_candidates(q, rows, measure)
        dead = live & tomb[cc.long()] if tomb is not None \
            else torch.zeros_like(live)
        sims = sims.masked_fill(~live | dead | (cc == sids[:, None])
                                | ~active[:, None], float("-inf"))
        mv, mi = _padded_topk(torch.cat([vals, sims], 1),
                              torch.cat([ids, cc], 1), k)
        changed = ((mv != vals) | (mi != ids)).any(dim=1)
        stable = torch.where(changed, torch.zeros_like(stable), stable + 1)
        probed = probed + active.to(torch.int32)
        active = active & (stable < patience)
        vals, ids = mv, mi
    return vals, ids, probed


def recall_at_k(got_ids: torch.Tensor, want_ids: torch.Tensor,
                got_vals: Optional[torch.Tensor] = None,
                want_vals: Optional[torch.Tensor] = None) -> float:
    """Mean fraction of the exact top-k retrieved, per query. The values,
    when given, mask empty (-inf) slots on both sides and shrink the
    denominator for rows with fewer than k true neighbors."""
    hit = got_ids[:, :, None] == want_ids[:, None, :]  # (b, k, k)
    if got_vals is not None:
        hit = hit & torch.isfinite(got_vals)[:, :, None]
    if want_vals is not None:
        ok = torch.isfinite(want_vals)
        hit = hit & ok[:, None, :]
        denom = ok.sum(dim=1).clamp(min=1).to(torch.float32)
    else:
        denom = float(want_ids.shape[1])
    return float((hit.any(dim=2).sum(dim=1) / denom).mean())


def score_recall_at_k(got_vals: torch.Tensor, want_vals: torch.Tensor
                      ) -> float:
    """Mean fraction of the exact top-k matched by score: a retrieved slot
    counts when its score reaches the exact list's k-th score, so a
    neighbor swapped for another of exactly the same score is no miss (the
    id-based :func:`recall_at_k` counts it as one)."""
    ok = torch.isfinite(want_vals)
    cut = torch.where(ok, want_vals, torch.full_like(want_vals, float("inf"))
                      ).amin(dim=1, keepdim=True)
    hit = (torch.isfinite(got_vals) & (got_vals >= cut)).sum(dim=1)
    n_want = ok.sum(dim=1)
    return float((torch.minimum(hit, n_want) / n_want.clamp(min=1)
                  ).to(torch.float32).mean())
