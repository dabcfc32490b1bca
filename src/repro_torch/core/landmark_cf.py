"""LandmarkCF — the paper's Algorithm 3 in PyTorch.

Pipeline (user-based; item-based transposes the rating matrix first):

  1. ``select_landmarks``            — popularity, random, dist. of
                                       ratings, coresets (§3.3)
  2. ``d1``                          — (U, n) user-landmark representation,
                                       by default the CUDA kernel behind
                                       ``kernels.ops.masked_similarity``
  3. ``graph.build_neighbor_graph``  — (U, k) top-k NeighborGraph in
                                       landmark space (d2); the (U, U)
                                       matrix never exists
  4. ``knn.predict_*_graph``         — Eq. (1) rating prediction

``fold_in`` projects new rows through the frozen landmarks and extends the
graph without a refit. ``fit_baseline`` is the full-matrix kNN of the paper
(Algorithm 1), kept dense by construction.

``fit_distributed`` and :class:`ShardedLandmarkState` are the mesh forms:
users block-partitioned over a ``launch.mesh.Mesh``'s row axes, landmarks
replicated; ``fold_in_sharded`` appends a batch to one shard and patches
the graph on every shard. The only cross-shard payload of the fit is the
(U, n) landmark representation, of a fold-in the (bq, k) candidate lists.

Unlike the reference, where the fused d1 kernel is opt-in, ``sim_fn``
defaults to ``kernels.ops.masked_similarity``: the kernel for CUDA tensors,
its plain version for CPU tensors. Pass ``core.similarity.masked_similarity``
to force the plain version everywhere.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ..kernels import ops
from . import knn
from .graph import build_neighbor_graph, extend_neighbor_graph, finalize_topk
from .selection import select_landmarks
from .similarity import (dense_similarity, full_similarity_matrix,
                         streaming_knn_graph_sharded)
from .types import LandmarkSpec, NeighborGraph, RatingMatrix


@dataclasses.dataclass(frozen=True)
class LandmarkState:
    """Fitted state: landmark ids, reduced representation, neighbor graph.

    Exactly one of ``graph`` (the O(U·k) artifact) and ``sims`` (the dense
    (U, U) escape hatch of ``fit(..., dense_sims=True)`` / ``fit_baseline``)
    is set; prediction dispatches on which one is present.
    """

    landmark_idx: torch.Tensor  # (n,)
    representation: torch.Tensor  # (U, n) users in landmark space
    ratings: torch.Tensor  # (U, P) the (possibly transposed) training block
    graph: Optional[NeighborGraph] = None  # (U, k) neighbor ids + weights
    sims: Optional[torch.Tensor] = None  # (U, U) dense escape hatch


def _oriented(ratings: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "user":
        return ratings
    if mode == "item":
        return ratings.T.contiguous()
    raise ValueError(f"mode must be user|item, got {mode!r}")


def build_representation(ratings: torch.Tensor, landmark_idx: torch.Tensor,
                         d1: str, sim_fn=None) -> torch.Tensor:
    """d1 step: (U, n) similarities/distances of every row to the landmarks."""
    fn = sim_fn if sim_fn is not None else ops.masked_similarity
    return fn(ratings, ratings[landmark_idx], d1)


def fit(matrix: RatingMatrix, spec: LandmarkSpec, sim_fn=None, *,
        dense_sims: bool = False, backend: Optional[str] = None,
        generator: Optional[torch.Generator] = None, ivf=None
        ) -> LandmarkState:
    """Fit landmark CF on one device, the device of ``matrix``.

    The fitted artifact is a (U, k) NeighborGraph built by ``core.graph``
    (backend from ``spec.graph_backend`` unless overridden; ``ivf`` is the
    ``retrieval.IVFSpec`` of ``backend="ivf"``). ``generator`` drives the
    random selection strategies (popularity ignores it), so a fit is
    reproducible from its seed. ``dense_sims=True`` keeps the dense (U, U)
    d2 matrix instead.
    """
    r = _oriented(matrix.ratings, spec.mode)
    idx = select_landmarks(r, spec.n_landmarks, spec.selection, generator,
                           sim_fn)
    rep = build_representation(r, idx, spec.d1, sim_fn)
    if dense_sims:
        return LandmarkState(idx, rep, r, sims=dense_similarity(rep, rep, spec.d2))
    graph = build_neighbor_graph(rep, spec.d2, spec.k_neighbors,
                                 backend=backend or spec.graph_backend,
                                 ivf=ivf)
    return LandmarkState(idx, rep, r, graph=graph)


def fold_in(state: LandmarkState, new_ratings: torch.Tensor,
            spec: LandmarkSpec, sim_fn=None, *, backend: Optional[str] = None,
            chunk: int = 4096, ivf=None, ivf_index=None) -> LandmarkState:
    """Project b new rows into the fitted state without a refit.

    d1 is O(b·n·P) against the frozen landmark rows; the graph grows via
    :func:`~repro_torch.core.graph.extend_neighbor_graph`, so no (U, U) or
    (U+b, U+b) array ever exists. Matches a from-scratch ``fit`` on the
    concatenated matrix with the *same* landmarks, up to top-k ties.
    ``new_ratings`` rows follow the state's orientation (new users in user
    mode, new items in item mode).

    ``backend="ivf"`` searches the new rows' neighbors through an IVF index
    (``ivf`` a ``retrieval.IVFSpec``); pass the serve loop's live
    ``ivf_index`` over the existing rows to skip building one. The returned
    state does not carry the index: append the batch to it separately.
    """
    if state.graph is None:
        raise ValueError(
            "fold_in needs a graph-backed state; dense-sims states "
            "(fit(..., dense_sims=True) / fit_baseline) must refit")
    landmarks = state.ratings[state.landmark_idx]  # (n, P) frozen at fit
    fn = sim_fn if sim_fn is not None else ops.masked_similarity
    new_rep = fn(new_ratings, landmarks, spec.d1)  # (b, n)
    graph = extend_neighbor_graph(
        state.graph, state.representation, new_rep, spec.d2,
        backend=backend or spec.graph_backend, chunk=chunk, ivf=ivf,
        ivf_index=ivf_index)
    return LandmarkState(
        state.landmark_idx,
        torch.cat([state.representation, new_rep]),
        torch.cat([state.ratings, new_ratings]),
        graph=graph,
    )


def predict(state: LandmarkState, users: torch.Tensor, items: torch.Tensor,
            spec: LandmarkSpec, *, n_valid: Optional[int] = None
            ) -> torch.Tensor:
    """Predict the requested (row, col) cells of the oriented matrix."""
    if spec.mode == "item":
        users, items = items, users
    if state.graph is not None:
        return knn.predict_pairs_graph(state.graph, state.ratings, users,
                                       items, n_valid=n_valid)
    return knn.predict_pairs(state.sims, state.ratings, users, items,
                             k=spec.k_neighbors)


def predict_dense(state: LandmarkState, spec: LandmarkSpec) -> torch.Tensor:
    if state.graph is not None:
        preds = knn.predict_all_graph(state.graph, state.ratings)
    else:
        preds = knn.predict_all(state.sims, state.ratings, k=spec.k_neighbors)
    return preds.T if spec.mode == "item" else preds


def fit_baseline(matrix: RatingMatrix, measure: str, mode: str = "user"
                 ) -> LandmarkState:
    """Full-matrix kNN (paper Algorithm 1): the O(|U|²·|P|) cost the
    landmark method removes. Keeps the dense sims matrix by construction."""
    r = _oriented(matrix.ratings, mode)
    sims = full_similarity_matrix(r, measure)
    return LandmarkState(
        torch.zeros((0,), dtype=torch.int64, device=r.device),
        torch.zeros((r.shape[0], 0), dtype=r.dtype, device=r.device),
        r, sims=sims)


# ---------------------------------------------------------------------------
# On a mesh: users sharded over the row axes, landmarks replicated.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedLandmarkState:
    """A serving state block-partitioned over the mesh's row ``axes``.

    Every row-indexed array is a list of S blocks of C rows (C the
    per-shard bucket capacity, ``lifecycle.buckets``), block s on
    ``distributed.sharding.shard_devices(mesh, axes)[s]``. Graph neighbor
    ids and ``landmark_idx`` live in the *sharded* id space ``s*C + slot``;
    ``n_valid[s]`` counts the live rows of shard s, the rest is zero
    filler.

    ``row_rank[s][slot]`` is the row's *logical* id, its position in the
    single-device arrival order (fit rows 0..U-1, then fold-in batches in
    stream order). Within a shard, slots are appended in logical order, so
    a shard's local top-k breaks ties canonically; the cross-shard merge
    of fold-in candidates breaks exact-weight ties by this rank, which
    makes every neighbor list, and so every prediction, the single-device
    run's, duplicate weights included.
    """

    landmark_idx: torch.Tensor  # (n,) int64 sharded ids, on shard 0
    representation: List[torch.Tensor]  # S x (C, n)
    ratings: List[torch.Tensor]  # S x (C, P)
    graph: List[NeighborGraph]  # S x (C, k) ids in the sharded space
    n_valid: Tuple[int, ...]  # (S,) live rows per block
    row_rank: List[torch.Tensor]  # S x (C,) int32 logical id per slot
    mesh: object
    axes: Tuple[str, ...]

    @property
    def shard_count(self) -> int:
        return len(self.ratings)

    @property
    def capacity(self) -> int:
        """Per-shard row capacity C."""
        return self.ratings[0].shape[0]

    @property
    def total_valid(self) -> int:
        return int(sum(self.n_valid))

    @property
    def devices(self):
        return tuple(r.device for r in self.ratings)

    @property
    def k(self) -> int:
        return self.graph[0].k

    def clone(self) -> "ShardedLandmarkState":
        """A copy whose blocks share no storage with this state's (a
        sharded fold-in writes its blocks in place)."""
        def copy(blocks):
            return [b.clone() for b in blocks]

        return dataclasses.replace(
            self, landmark_idx=self.landmark_idx.clone(),
            representation=copy(self.representation),
            ratings=copy(self.ratings),
            graph=[NeighborGraph(g.indices.clone(), g.weights.clone())
                   for g in self.graph],
            row_rank=copy(self.row_rank))

    def landmarks(self) -> torch.Tensor:
        """(n, P) landmark rating rows gathered from their owner shards,
        on shard 0."""
        from ..distributed.sharding import gather_rows

        return gather_rows(self.ratings, self.landmark_idx, self.capacity,
                           self.devices[0])


def fit_distributed(ratings: torch.Tensor, spec: LandmarkSpec, mesh,
                    user_axes=("pod", "data"), *, dense_sims: bool = False,
                    generator: Optional[torch.Generator] = None,
                    sim_fn=None) -> LandmarkState:
    """Landmark CF with users sharded over ``mesh``'s ``user_axes``.

    Landmarks are selected on the whole (unpadded) matrix exactly as
    :func:`fit` selects them, so a refresh through here is a from-scratch
    ``fit``. Shard s takes rows ``[s*u_per, (s+1)*u_per)`` (u_per =
    ceil(U/S), zero rows padding the tail) and computes their d1 against
    the replicated landmarks (the d1 kernel on the card, per shard); the
    (U, n) representation is the one payload that crosses shards: the
    graph is ``streaming_knn_graph_sharded`` (each shard's rows scanned
    against the gathered candidates, kernel 2's work on the card), or the
    dense (U, U) d2 rows with ``dense_sims``. Returns an ordinary
    ``LandmarkState`` on ``ratings``' device (what ``from_state_sharded``
    or a row-sharded checkpoint take).
    """
    from ..distributed.sharding import (all_gather_rows, cf_row_axes,
                                        cf_shard_count, shard_devices)

    axes = cf_row_axes(mesh, user_axes)
    n_shards = cf_shard_count(mesh, axes)
    devs = shard_devices(mesh, axes)
    home = ratings.device
    u = ratings.shape[0]
    k = max(1, min(spec.k_neighbors, u - 1)) if u > 1 else 1
    u_per = -(-u // n_shards)
    idx = select_landmarks(ratings, spec.n_landmarks, spec.selection,
                           generator, sim_fn)
    landmarks = ratings[idx]  # replicated (n, P)
    fn = sim_fn if sim_fn is not None else ops.masked_similarity
    reps = []
    for s, dev in enumerate(devs):
        rows = ratings.new_zeros((u_per, ratings.shape[1]), device=dev)
        lo, hi = min(s * u_per, u), min((s + 1) * u_per, u)
        rows[:hi - lo] = ratings[lo:hi].to(dev)
        reps.append(fn(rows, landmarks.to(dev), spec.d1))
    rep = all_gather_rows(reps, home)[:u]
    if dense_sims:
        sims = all_gather_rows(
            [dense_similarity(r, rep.to(dev), spec.d2)
             for r, dev in zip(reps, devs)], home)[:u]
        return LandmarkState(idx, rep, ratings, sims=sims)
    vals, ids = streaming_knn_graph_sharded(
        reps, mesh, spec.d2, k=k, row_axes=axes, exclude_self=True,
        n_valid=u, backend=spec.graph_backend)
    graph = finalize_topk(all_gather_rows(vals, home)[:u],
                          all_gather_rows(ids, home)[:u])
    return LandmarkState(idx, rep, ratings, graph=graph)


def fold_in_sharded(sstate: ShardedLandmarkState, new_ratings: torch.Tensor,
                    b_valid: int, target: int, spec: LandmarkSpec,
                    landmarks: Optional[torch.Tensor] = None,
                    backend: str = "auto") -> ShardedLandmarkState:
    """Mesh-wide ``fold_in_bucketed``: the whole batch lands on shard
    ``target``.

    d1 of the (bq, P) batch (rows ``>= b_valid`` filler) through the frozen
    landmarks runs on the target shard (the d1 kernel on the card); the
    batch's ratings, representation and logical ranks are appended there
    (``distributed.sharding.shard_local_append``), and
    :func:`~repro_torch.core.graph.extend_neighbor_graph_sharded` runs the
    new-vs-all scan and the back-patch on every shard, with one gather of
    the (bq, k) candidate lists. The caller picks the target (the serve
    driver: least loaded) and guarantees ``n_valid[target] + bq <= C``
    (``lifecycle.buckets.ensure_capacity_sharded``). ``landmarks``
    overrides the projection basis. The blocks of ``sstate`` are updated
    in place: treat it as consumed.
    """
    from ..distributed.sharding import shard_local_append
    from .graph import extend_neighbor_graph_sharded

    home = sstate.devices[target]
    bq = new_ratings.shape[0]
    new_ratings = new_ratings.to(home)
    q_valid = (torch.arange(bq, device=home) < b_valid)[:, None]
    new_ratings = torch.where(q_valid, new_ratings,
                              torch.zeros_like(new_ratings))
    if landmarks is None:
        landmarks = sstate.landmarks()
    new_rep = ops.masked_similarity(new_ratings, landmarks.to(home), spec.d1)
    new_rep = torch.where(q_valid, new_rep, torch.zeros_like(new_rep))
    n_valid = sstate.n_valid
    shard_local_append(sstate.ratings, new_ratings, n_valid, target)
    shard_local_append(sstate.representation, new_rep, n_valid, target)
    ranks = sstate.total_valid + torch.arange(bq, dtype=torch.int32)
    shard_local_append(sstate.row_rank, ranks, n_valid, target)
    graph = extend_neighbor_graph_sharded(
        sstate.graph, sstate.representation, new_rep, n_valid, int(b_valid),
        target, sstate.mesh, sstate.row_rank, spec.d2, row_axes=sstate.axes,
        backend=backend)
    fills = list(n_valid)
    fills[target] += int(b_valid)
    return dataclasses.replace(sstate, graph=graph, n_valid=tuple(fills))
