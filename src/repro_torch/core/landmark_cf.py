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

Unlike the reference, where the fused d1 kernel is opt-in, ``sim_fn``
defaults to ``kernels.ops.masked_similarity``: the kernel for CUDA tensors,
its plain version for CPU tensors. Pass ``core.similarity.masked_similarity``
to force the plain version everywhere.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels import ops
from . import knn
from .graph import build_neighbor_graph, extend_neighbor_graph
from .selection import select_landmarks
from .similarity import dense_similarity, full_similarity_matrix
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
