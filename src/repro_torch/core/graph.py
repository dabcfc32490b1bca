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
==========  ==============  ================================================

``auto`` resolves by the tensor's device: ``kernel`` for a CUDA tensor,
``streaming`` for a CPU tensor. All backends exclude self, store weight 0
for empty slots, and emit lists in canonical order (weight desc, id asc),
so Eq. (1) prediction (core.knn) is backend-agnostic.

:func:`extend_neighbor_graph` appends b new rows without refitting: a
new-vs-all candidate scan, then a back-patch of the existing rows whose
top-k should now include a new row (one (U, b) block, b ≪ U).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import knn_topk
from .similarity import EPS, dense_similarity, streaming_knn_graph
from .topk import canonical_topk
from .types import NeighborGraph

BACKENDS = ("dense", "streaming", "kernel", "auto")


def resolve_backend(backend: str, device) -> str:
    """``auto`` → ``kernel`` for a CUDA ``device``, ``streaming`` for a CPU one."""
    if backend == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "streaming"
    if backend == "ivf":
        raise NotImplementedError(
            "the ivf graph backend is ported with the retrieval slice")
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


def build_neighbor_graph(rep: torch.Tensor, measure: str = "cosine",
                         k: int = 13, backend: str = "auto", *,
                         chunk: int = 4096) -> NeighborGraph:
    """Top-k neighbor graph over ``rep`` rows under d2 ``measure``.

    Self is always excluded. ``k`` is clamped to U-1 (a row cannot have
    more distinct neighbors than other rows).
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
    repq = kernel_rows(rep, measure)
    vals, idx = knn_topk.topk_sim(repq, repq, k=k, exclude_self=True,
                                  n_valid=u, measure=measure)
    return finalize_topk(vals, idx)


def _streaming_query_topk(queries: torch.Tensor, cand_src: torch.Tensor,
                          measure: str, k: int, chunk: int, self_offset: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k candidates per query row (query i is candidate
    ``self_offset + i``), scanning (b, chunk) score tiles only."""
    b = queries.shape[0]
    c = cand_src.shape[0]
    dev = queries.device
    chunk = max(min(chunk, c), min(k, c))
    row_gid = self_offset + torch.arange(b, device=dev)
    best_v = torch.full((b, k), float("-inf"), dtype=torch.float32, device=dev)
    best_i = torch.zeros((b, k), dtype=torch.int32, device=dev)
    for c0 in range(0, c, chunk):
        cand = cand_src[c0:c0 + chunk]
        sims = dense_similarity(queries, cand, measure)
        cand_ids = c0 + torch.arange(cand.shape[0], device=dev)
        sims = sims.masked_fill(cand_ids[None, :] == row_gid[:, None],
                                float("-inf"))
        v, i = canonical_topk(sims, min(k, cand.shape[0]))
        mv = torch.cat([best_v, v], dim=1)
        mi = torch.cat([best_i, (i + c0).to(torch.int32)], dim=1)
        best_v, sel = canonical_topk(mv, k)
        best_i = mi.gather(1, sel)
    return best_v, best_i


def extend_neighbor_graph(graph: NeighborGraph, rep: torch.Tensor,
                          new_rep: torch.Tensor, measure: str = "cosine",
                          backend: str = "auto", *, chunk: int = 4096
                          ) -> NeighborGraph:
    """Append b rows (ids U..U+b-1) to a fitted graph without refitting.

    1. **new-vs-all**: each new row scans all U+b candidates for its own
       top-k (the ``kernel`` backend runs the skinny fold-in kernels).
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
