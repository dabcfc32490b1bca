"""Neighbor-graph construction — the d2/kNN step without the (U, U) matrix.

The fitted artifact of landmark CF is a :class:`~repro_torch.core.types.NeighborGraph`
— per-user top-k neighbor ids + similarity weights, O(U·k) memory. This
module turns a (U, n) landmark representation into that graph:

==========  ==============  ================================================
backend     peak memory     when to pick it
==========  ==============  ================================================
dense       O(U²)           small U / paper-table parity: the full d2
                            matrix, then its top-k.
streaming   O(U·chunk)      plain torch anywhere: candidate chunks folded
                            into a running (U, k) best list.
kernel      O(U·k)          the fused d2 + top-k CUDA kernels
                            (``kernels/knn_topk.py``); score tiles never
                            leave the chip's shared memory. On a CPU tensor
                            the wrapper runs its plain version.
ivf         O(U·(n+1)·      sublinear candidate generation: an IVF index
            slack)          over the landmark embedding (``retrieval``)
                            prunes each row's scan to the nprobe nearest
                            cells. Exact at nprobe == n_clusters (under the
                            tie rule on the card); approximate at the
                            default nprobe.
==========  ==============  ================================================

``auto`` resolves by the tensor's device: ``kernel`` for a CUDA tensor,
``streaming`` for a CPU tensor (``ivf`` is opt-in: recall below 1 is a
policy decision). All backends exclude self, store weight 0 for empty
slots, and emit lists in canonical order (weight desc, id asc), so Eq. (1)
prediction (core.knn) is backend-agnostic.

:func:`extend_neighbor_graph` appends b new rows without refitting: a
new-vs-all candidate scan, then a back-patch of the existing rows whose
top-k should now include a new row (one (U, b) block, b ≪ U).
:func:`extend_neighbor_graph_bucketed` is its shape-stable form behind
``lifecycle.buckets``: arrays stay padded to a bucket capacity and the
valid-row counts are plain integers, so every fold-in at one
(capacity, batch) geometry runs the same shapes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..kernels import knn_topk
from ..kernels.score_candidates import score_candidates
from .similarity import EPS, dense_similarity, streaming_knn_graph
from .topk import canonical_topk
from .types import NeighborGraph, round_up

BACKENDS = ("dense", "streaming", "kernel", "ivf", "auto")


def resolve_backend(backend: str, device) -> str:
    """``auto`` → ``kernel`` for a CUDA ``device``, ``streaming`` for a CPU one."""
    if backend == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "streaming"
    if backend not in BACKENDS:
        raise ValueError(f"unknown graph backend {backend!r}; expected {BACKENDS}")
    return backend


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return (x / norm.clamp(min=EPS)).to(torch.float32).contiguous()


def kernel_rows(x: torch.Tensor, measure: str) -> torch.Tensor:
    """Rows as the top-k kernels take them: L2-normalized for cosine (one
    pass here, amortized over every candidate), raw otherwise."""
    if measure == "cosine":
        return _l2_normalize(x)
    return x.to(torch.float32).contiguous()


def finalize_topk(vals: torch.Tensor, idx: torch.Tensor) -> NeighborGraph:
    """Top-k output -> graph: empty (-inf) slots become (0, 0.0)."""
    ok = torch.isfinite(vals)
    return NeighborGraph(
        torch.where(ok, idx, torch.zeros_like(idx)).to(torch.int32),
        torch.where(ok, vals, torch.zeros_like(vals)).to(torch.float32),
    )


def merge_canonical_topk(av: torch.Tensor, ai: torch.Tensor,
                         bv: torch.Tensor, bi: torch.Tensor, k: int,
                         a_rank: Optional[torch.Tensor] = None,
                         b_rank: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The canonical top-k of two lists that are each canonical already
    ((rows, ka) and (rows, kb), value desc then id asc), without a sort:
    each element's merged position is its own index plus the count of the
    other list's elements that precede it. ``a_rank``/``b_rank`` (the
    lists' shapes) order ties in place of the ids: the logical ranks of
    sharded ids on a mesh.

    Exact when no element of one list ties an element of the other in both
    value and id (the callers' lists are id-disjoint); -inf pads that cannot
    reach the top k may tie harmlessly."""
    ka, kb = av.shape[1], bv.shape[1]
    if ka + kb < k:
        raise ValueError(f"merging {ka} + {kb} candidates cannot fill k={k}")
    ar = ai if a_rank is None else a_rank
    br = bi if b_rank is None else b_rank
    eq = bv[:, :, None] == av[:, None, :]  # (rows, kb, ka)
    b_before_a = (bv[:, :, None] > av[:, None, :]) | (
        eq & (br[:, :, None] < ar[:, None, :]))
    a_before_b = (av[:, None, :] > bv[:, :, None]) | (
        eq & (ar[:, None, :] < br[:, :, None]))
    dev = av.device
    pos = torch.cat([torch.arange(ka, device=dev) + b_before_a.sum(1),
                     torch.arange(kb, device=dev) + a_before_b.sum(2)], 1)
    # slot s takes the element whose merged position is s (the first such,
    # as the reference's argmax does)
    slot = (pos[:, None, :] == torch.arange(k, device=dev)[None, :, None]
            ).to(torch.int8).argmax(dim=2)
    return (torch.cat([av, bv], 1).gather(1, slot),
            torch.cat([ai, bi], 1).gather(1, slot))


def evict_neighbors(graph: NeighborGraph, dead: torch.Tensor,
                    row_rank: Optional[torch.Tensor] = None
                    ) -> Tuple[NeighborGraph, torch.Tensor]:
    """Drop every citation of a ``dead`` row id ((capacity,) bool) from all
    neighbor lists. Returns ``(graph, hit)``: the surviving entries keep
    their canonical order and emptied slots become (0, 0.0); ``hit`` marks
    the rows that lost an entry (their k-th neighbor is now unknown, so the
    caller owes them a rescan). Fresh tensors; ``graph`` is not written.
    ``row_rank`` (indexed like ``dead``) orders ties by logical rank in
    place of the id: a shard's graph block on a mesh.

    The inert (0, 0.0) slot cites id 0, so a dead row 0 hits every row
    holding one — spurious but safe (the rescan restores the slot)."""
    idx = graph.indices.long()
    cited_dead = dead[idx]
    hit = cited_dead.any(dim=1)
    v, i = canonical_topk(graph.weights.masked_fill(cited_dead,
                                                    float("-inf")),
                          graph.k, ids=graph.indices,
                          rank=None if row_rank is None else row_rank[idx])
    g = finalize_topk(v, i)
    return NeighborGraph(torch.where(hit[:, None], g.indices, graph.indices),
                         torch.where(hit[:, None], g.weights,
                                     graph.weights)), hit


def filter_self_from_topk(vals: torch.Tensor, idx: torch.Tensor,
                          row_ids: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Drop each row's own id from a canonical (rows, k+1) top-k list and
    keep the best ``k`` (the order among the rest is kept)."""
    vals = vals.masked_fill(idx == row_ids[:, None].to(idx.dtype),
                            float("-inf"))
    v, sel = canonical_topk(vals, k)
    return v, idx.gather(1, sel)


def backpatch_sims(rep: torch.Tensor, new_rep: torch.Tensor,
                   measure: str) -> torch.Tensor:
    """(C, bq) d2 scores of every row of ``rep`` against the batch, for the
    back-patch of the bucketed and sharded fold-ins: the gathered-candidate
    scorer's shared form (kernel 6, ``kernels.score_candidates``; its plain
    version ``kernels.ref.gathered_sims`` on a CPU tensor), the
    ``dense_similarity`` algebra with every sum over the landmark axis left
    to right, so a score depends on its two rows alone. A library product
    picks its kernel, and so its order of additions, by the shape: on the
    card a shard's (C_s, bq) block and the one-device (C, bq) block round
    some scores differently."""
    return score_candidates(rep.float().contiguous(),
                            new_rep.float().contiguous(), measure)


def build_neighbor_graph(rep: torch.Tensor, measure: str = "cosine",
                         k: int = 13, backend: str = "auto", *,
                         chunk: int = 4096, ivf=None) -> NeighborGraph:
    """Top-k neighbor graph over ``rep`` rows under d2 ``measure``.

    Self is always excluded. ``k`` is clamped to U-1 (a row cannot have
    more distinct neighbors than other rows). ``backend="ivf"`` builds a
    fresh IVF index over ``rep`` (``ivf`` a ``retrieval.IVFSpec``, None for
    the defaults) and searches it at its nprobe; callers that keep the
    index for serving build it through ``retrieval`` themselves.
    """
    u = rep.shape[0]
    k = max(1, min(k, u - 1)) if u > 1 else 1
    backend = resolve_backend(backend, rep.device)
    if backend == "dense":
        return NeighborGraph.from_dense_sims(
            dense_similarity(rep, rep, measure), k, exclude_self=True)
    if backend == "streaming":
        vals, idx = streaming_knn_graph(rep, measure, k=k, chunk=chunk,
                                        exclude_self=True)
        return finalize_topk(vals, idx)
    if backend == "ivf":
        from ..retrieval import build_index, resolve_ivf, search

        cfg = resolve_ivf(ivf, u)
        index = build_index(rep, cfg, measure)
        vals, idx = search(index, rep, k, cfg.nprobe, measure,
                           self_ids=torch.arange(u, device=rep.device))
        return finalize_topk(vals, idx)
    repq = kernel_rows(rep, measure)
    vals, idx = knn_topk.topk_sim(repq, repq, k=k, exclude_self=True,
                                  n_valid=u, measure=measure)
    return finalize_topk(vals, idx)


def _streaming_query_topk(queries: torch.Tensor, cand_src: torch.Tensor,
                          measure: str, k: int, chunk: int, self_offset: int,
                          n_valid: Optional[int] = None, *,
                          self_ids: Optional[torch.Tensor] = None,
                          dead: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k candidates per query row (query i is candidate
    ``self_offset + i``, or ``self_ids[i]`` when given), scanning (b, chunk)
    score tiles only. Candidates at or past ``n_valid`` (default: none) and
    those marked in ``dead`` ((C,) bool) are never picked."""
    b = queries.shape[0]
    c = cand_src.shape[0]
    dev = queries.device
    chunk = max(min(chunk, c), min(k, c))
    row_gid = (self_offset + torch.arange(b, device=dev) if self_ids is None
               else self_ids.to(device=dev, dtype=torch.int64))
    best_v = torch.full((b, k), float("-inf"), dtype=torch.float32, device=dev)
    best_i = torch.zeros((b, k), dtype=torch.int32, device=dev)
    for c0 in range(0, c, chunk):
        cand = cand_src[c0:c0 + chunk]
        sims = dense_similarity(queries, cand, measure)
        cand_ids = c0 + torch.arange(cand.shape[0], device=dev)
        invalid = cand_ids[None, :] == row_gid[:, None]
        if n_valid is not None:
            invalid = invalid | (cand_ids >= n_valid)[None, :]
        if dead is not None:
            invalid = invalid | dead[c0:c0 + chunk][None, :]
        v, i = canonical_topk(sims.masked_fill(invalid, float("-inf")),
                              min(k, cand.shape[0]))
        mv = torch.cat([best_v, v], dim=1)
        mi = torch.cat([best_i, (i + c0).to(torch.int32)], dim=1)
        best_v, sel = canonical_topk(mv, k)
        best_i = mi.gather(1, sel)
    return best_v, best_i


def _ivf_query_topk(rep, new_rep, measure, k, ivf, ivf_index):
    """New-vs-all half of the ``ivf`` backend: append the batch (ids
    U..U+b-1) to the index, then search it — the batch rows are candidates
    for each other too."""
    from ..retrieval import (IVFSpec, append, build_index, grow_capacity,
                             resolve_ivf, search)

    u, b = rep.shape[0], new_rep.shape[0]
    if ivf_index is None:
        cfg = resolve_ivf(ivf, u)
        ivf_index = build_index(rep, cfg, measure)
    else:
        cfg = resolve_ivf(dataclasses.replace(
            ivf or IVFSpec(), n_clusters=ivf_index.n_clusters), u)
    c, cap = ivf_index.n_clusters, ivf_index.capacity
    if u + b > c * cap:  # append drops what does not fit: reserve room
        ivf_index = grow_capacity(ivf_index, round_up(max(
            -(-int((u + b) * cfg.slack) // c), -(-(u + b) // c)), 8))
    ids = u + torch.arange(b, dtype=torch.int32, device=rep.device)
    with_batch = append(ivf_index, new_rep, ids, measure,
                        spill_choices=cfg.spill_choices)
    return search(with_batch, new_rep, k, cfg.nprobe, measure, self_ids=ids)


def extend_neighbor_graph(graph: NeighborGraph, rep: torch.Tensor,
                          new_rep: torch.Tensor, measure: str = "cosine",
                          backend: str = "auto", *, chunk: int = 4096,
                          ivf=None, ivf_index=None) -> NeighborGraph:
    """Append b rows (ids U..U+b-1) to a fitted graph without refitting.

    1. **new-vs-all**: each new row scans all U+b candidates for its own
       top-k (the ``kernel`` backend runs the skinny fold-in kernels; the
       ``ivf`` backend appends the batch to an IVF index over the existing
       rows — ``ivf_index``, or one built here from ``ivf`` — and probes its
       nearest cells, growing the lists first when the batch could
       overflow them; the caller's index is not modified).
    2. **back-patch**: the (U, b) existing-vs-new block is merged into the
       existing rows' lists, so an old row whose true top-k now contains a
       new row is updated too. This half stays plain torch, as in the
       reference.

    Exact against a from-scratch build on the concatenated rows when the
    fitted graph has k ≤ U-1. ``k`` stays ``graph.k``; compact graphs are
    widened first.
    """
    if graph.is_compact:
        graph = graph.to_full()
    u = rep.shape[0]
    b = new_rep.shape[0]
    k = graph.k
    backend = resolve_backend(backend, rep.device)

    # -- 1. new-vs-all: top-k rows for the b appended users -------------------
    if backend == "kernel":
        queries = kernel_rows(new_rep, measure)
        cand = torch.cat([kernel_rows(rep, measure), queries])
        vals, idx = knn_topk.foldin_topk(queries, cand, k=k, self_offset=u,
                                         measure=measure)
    elif backend == "ivf":
        vals, idx = _ivf_query_topk(rep, new_rep, measure, k, ivf, ivf_index)
    elif backend == "dense":
        cand = torch.cat([rep, new_rep])
        sims = dense_similarity(new_rep, cand, measure)
        gid = torch.arange(u + b, device=rep.device)
        sims = sims.masked_fill(
            gid[None, :] == (u + torch.arange(b, device=rep.device))[:, None],
            float("-inf"))
        vals, idx = canonical_topk(sims, k)
    else:
        cand = torch.cat([rep, new_rep])
        vals, idx = _streaming_query_topk(new_rep, cand, measure, k, chunk,
                                          self_offset=u)
    new_rows = finalize_topk(vals, idx)

    # -- 2. back-patch: merge the (U, b) existing-vs-new block ----------------
    # the incumbent lists are canonical and every new id exceeds every old
    # one, so the positional order of [incumbents, new] breaks ties by id
    back = dense_similarity(rep, new_rep, measure)  # (U, b)
    new_ids = (u + torch.arange(b, dtype=torch.int32, device=rep.device)
               ).expand(u, b)
    mv = torch.cat([graph.weights, back], dim=1)  # (U, k+b)
    mi = torch.cat([graph.indices, new_ids], dim=1)
    pv, sel = canonical_topk(mv, k)
    pi = mi.gather(1, sel)
    return NeighborGraph(torch.cat([pi, new_rows.indices]),
                         torch.cat([pv, new_rows.weights]))


def extend_neighbor_graph_bucketed(graph: NeighborGraph, rep: torch.Tensor,
                                   new_rep: torch.Tensor, n_valid: int,
                                   b_valid: int, measure: str = "cosine",
                                   backend: str = "auto", *,
                                   chunk: int = 4096) -> NeighborGraph:
    """Shape-stable :func:`extend_neighbor_graph`: a (C, k) graph in, the
    same (C, k) graph out.

    ``rep`` (C, n) holds the new batch already written at rows
    ``[n_valid, n_valid + bq)``; ``new_rep`` (bq, n) is the batch, rows
    ``>= b_valid`` filler.

    1. **new-vs-all** — each batch row's top-k over the valid prefix (ids
       ``< n_valid + b_valid``), stored at slots ``[n_valid, n_valid+bq)``;
       filler rows store (0, 0.0). The ``kernel`` backend (``auto`` on a
       CUDA tensor) runs the fold-in kernels, whose ``n_valid`` and
       ``self_offset`` are exactly these masks; ``streaming`` (``auto`` on
       a CPU tensor) scans (bq, chunk) tiles with ``dense_similarity``.
       The two round cosine differently and agree under the tie rule.
    2. **back-patch** — the (C, bq) existing-vs-new block
       (:func:`backpatch_sims`) is merged into rows ``< n_valid`` only;
       filler columns are -inf.
    """
    if graph.is_compact:
        graph = graph.to_full()
    bq = new_rep.shape[0]
    c = rep.shape[0]
    k = graph.k
    dev = rep.device
    backend = resolve_backend(backend, dev)
    if backend == "kernel":
        vals, idx = knn_topk.foldin_topk(
            kernel_rows(new_rep, measure), kernel_rows(rep, measure), k=k,
            self_offset=n_valid, n_valid=n_valid + b_valid, measure=measure)
    elif backend == "streaming":
        vals, idx = _streaming_query_topk(new_rep, rep, measure, k, chunk,
                                          self_offset=n_valid,
                                          n_valid=n_valid + b_valid)
    else:
        raise ValueError(f"bucketed extend runs the kernel or streaming "
                         f"backend, not {backend!r}")
    new_rows = finalize_topk(vals, idx)
    q_valid = (torch.arange(bq, device=dev) < b_valid)[:, None]
    new_idx = torch.where(q_valid, new_rows.indices,
                          torch.zeros_like(new_rows.indices))
    new_w = torch.where(q_valid, new_rows.weights,
                        torch.zeros_like(new_rows.weights))

    back = backpatch_sims(rep, new_rep, measure)  # (C, bq)
    back = back.masked_fill(~q_valid.T, float("-inf"))
    batch_ids = (n_valid + torch.arange(bq, dtype=torch.int32, device=dev)
                 ).expand(c, bq)
    mv = torch.cat([graph.weights, back], dim=1)  # (C, k + bq)
    mi = torch.cat([graph.indices, batch_ids], dim=1)
    pv, sel = canonical_topk(mv, k)
    pi = mi.gather(1, sel)
    r_valid = (torch.arange(c, device=dev) < n_valid)[:, None]
    indices = torch.where(r_valid, pi, graph.indices)
    weights = torch.where(r_valid, pv, graph.weights)
    indices[n_valid:n_valid + bq] = new_idx
    weights[n_valid:n_valid + bq] = new_w
    return NeighborGraph(indices, weights)


def extend_neighbor_graph_sharded(graphs, reps, new_rep: torch.Tensor,
                                  n_valid, b_valid: int, target: int, mesh,
                                  row_rank, measure: str = "cosine", *,
                                  row_axes=("pod", "data"),
                                  backend: str = "auto", chunk: int = 4096):
    """:func:`extend_neighbor_graph_bucketed` on a mesh: the sharded
    fold-in's graph update. Returns the per-shard graphs (the blocks are
    updated in place).

    Row ids are block-partitioned: shard s owns ids ``[s*C, (s+1)*C)``;
    ``graphs``/``reps``/``row_rank`` are the shards' (C, ·) blocks, the
    batch already written on shard ``target`` at its fill ``n_valid``
    (the per-shard fills before this extend). ``new_rep`` (bq, n) is the
    batch, rows ``>= b_valid`` filler. Three shard-local phases, one
    gather:

    1. **new-vs-all** — each shard scores the batch against its own block
       (masked by its fill, plus ``b_valid`` on the target, and the target
       rows' own slots) and keeps a local top-k: the ``kernel`` backend
       (``auto`` on a CUDA tensor) on the fused top-k scan (kernel 3's
       work), ``streaming`` on (bq, chunk) tiles. The (bq, k) lists, ids
       and logical ranks travel to the target shard in linear shard order
       (O(bq·k·S), never a row of the representation) and merge
       canonically: weight descending, then logical rank ascending — the
       order the single-device scan's slot order implies, so duplicate
       weights cannot make the lists diverge from the single-device ones.
    2. **back-patch** — each shard merges its (C, bq) existing-vs-new block
       into rows below its own fill, shard-locally.
    3. **append** — the target writes the merged rows at its fill; filler
       rows store (0, 0.0).
    """
    from ..distributed.sharding import shard_devices

    axes = tuple(a for a in row_axes if a in mesh.axis_names)
    devs = shard_devices(mesh, axes)
    graphs = [g.to_full() if g.is_compact else g for g in graphs]
    c = reps[0].shape[0]
    bq = new_rep.shape[0]
    k = graphs[0].k
    kk = min(k, c)
    at = int(n_valid[target])
    home = devs[target]
    new_gid = target * c + at + torch.arange(bq, dtype=torch.int32)

    # -- 1. new-vs-all: local candidates, local top-k, gathered merge -------
    vs, gs, rs = [], [], []
    for s, dev in enumerate(devs):
        q = new_rep.to(dev)
        limit = int(n_valid[s]) + (b_valid if s == target else 0)
        self_off = at if s == target else None
        if resolve_backend(backend, dev) == "kernel":
            v, i = knn_topk.foldin_topk(
                kernel_rows(q, measure), kernel_rows(reps[s], measure),
                k=kk, self_offset=self_off, n_valid=limit, measure=measure)
        else:
            self_ids = (at + torch.arange(bq, device=dev) if s == target
                        else torch.full((bq,), -1, device=dev))
            v, i = _streaming_query_topk(q, reps[s], measure, kk, chunk, 0,
                                         limit, self_ids=self_ids)
        vs.append(v.to(home))
        gs.append((s * c + i.long()).to(torch.int32).to(home))
        rs.append(row_rank[s][i.long()].to(home))
    # canonical merge: two stable sorts, by logical rank, then by weight
    by_rank = torch.sort(torch.cat(rs, 1), dim=1, stable=True).indices
    v1 = torch.cat(vs, 1).gather(1, by_rank)
    g1 = torch.cat(gs, 1).gather(1, by_rank)
    top = torch.sort(v1, dim=1, descending=True, stable=True).indices[:, :k]
    nv, ni = v1.gather(1, top), g1.gather(1, top)
    ok = (torch.isfinite(nv)
          & (torch.arange(bq, device=home) < b_valid)[:, None])
    new_idx = torch.where(ok, ni, torch.zeros_like(ni))
    new_w = torch.where(ok, nv, torch.zeros_like(nv))

    # -- 2. back-patch local valid rows with the valid batch columns -------
    out = []
    for s, dev in enumerate(devs):
        g = graphs[s]
        q = new_rep.to(dev)
        back = backpatch_sims(reps[s], q, measure)  # (C, bq)
        back = back.masked_fill(
            (torch.arange(bq, device=dev) >= b_valid)[None, :], float("-inf"))
        mv = torch.cat([g.weights, back], dim=1)  # (C, k + bq)
        mi = torch.cat([g.indices, new_gid.to(dev).expand(c, bq)], dim=1)
        pv, psel = canonical_topk(mv, k)
        pi = mi.gather(1, psel)
        r_valid = (torch.arange(c, device=dev) < int(n_valid[s]))[:, None]
        gi = torch.where(r_valid, pi, g.indices)
        gw = torch.where(r_valid, pv, g.weights)
        # -- 3. append the new rows on the target shard ----------------------
        if s == target:
            gi[at:at + bq] = new_idx.to(dev)
            gw[at:at + bq] = new_w.to(dev)
        out.append(NeighborGraph(gi, gw))
    return out
