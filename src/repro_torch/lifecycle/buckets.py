"""Bucket-padded serving state — fixed shapes per bucket, not per fold-in.

``fold_in`` grows U by b every call, so every array changes shape after it.
Here arrays are padded to a capacity drawn from a geometric schedule, the
live-row count ``n_valid`` is a plain integer, and a fold-in fills padded
slots in place (``graph.extend_neighbor_graph_bucketed``). The pair,
top-N, fold-in and holdout steps therefore run at one geometry per bucket
— the shapes a later PR captures once per geometry as CUDA graphs. The
steps record each (capacity, batch) geometry they run at
(:func:`record_geometry`), so a replay can assert that the geometries stay
within the buckets it used.

Correctness of the padding rests on two invariants:

- rows ``< n_valid`` of the padded graph reference only rows ``< n_valid``;
- rows ``>= n_valid`` hold (index 0, weight 0.0) — inert under Eq. (1);

and every consumer re-zeroes weights of out-of-range neighbor ids through
``n_valid``, so padded rows cannot leak into predictions.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

import torch

from ..core import knn
from ..core.graph import extend_neighbor_graph_bucketed
from ..core.landmark_cf import LandmarkState
from ..core.types import LandmarkSpec, NeighborGraph
from ..kernels import ops

DEFAULT_MIN_BUCKET = 256
DEFAULT_GROWTH = 2.0

# (family -> distinct (capacity, batch) geometries) since the last reset
GEOMETRIES: Dict[str, Set[Tuple[int, int]]] = defaultdict(set)


def record_geometry(family: str, capacity: int, batch: int) -> None:
    GEOMETRIES[family].add((int(capacity), int(batch)))


def reset_geometries() -> None:
    GEOMETRIES.clear()


def geometry_counts() -> Dict[str, int]:
    """Distinct geometries per step family since the last reset."""
    return {family: len(g) for family, g in GEOMETRIES.items()}


def bucket_schedule(max_size: int, min_bucket: int = DEFAULT_MIN_BUCKET,
                    growth: float = DEFAULT_GROWTH) -> List[int]:
    """Geometric capacities ``min_bucket * growth^i`` (rounded up to 8) that
    cover populations up to ``max_size``."""
    assert growth > 1.0, growth
    caps, cap = [], float(min_bucket)
    while True:
        c = -(-int(cap) // 8) * 8
        if not caps or c > caps[-1]:
            caps.append(c)
        if c >= max_size:
            return caps
        cap *= growth


def bucket_capacity(n: int, min_bucket: int = DEFAULT_MIN_BUCKET,
                    growth: float = DEFAULT_GROWTH) -> int:
    """Smallest capacity on the schedule that holds ``n`` rows."""
    return bucket_schedule(n, min_bucket, growth)[-1]


@dataclasses.dataclass(frozen=True)
class BucketedState:
    """A ``LandmarkState`` padded to a bucket capacity + its live-row count.

    ``state`` arrays have leading dimension ``capacity``; rows ``< n_valid``
    are real users, the rest zero filler.
    """

    state: LandmarkState
    n_valid: int

    @property
    def capacity(self) -> int:
        return self.state.ratings.shape[0]


def _pad_rows(x: torch.Tensor, capacity: int) -> torch.Tensor:
    """A fresh copy of ``x`` zero-padded to ``capacity`` rows (never an
    alias: fold-ins write into the padded state in place)."""
    pad = capacity - x.shape[0]
    assert pad >= 0, (tuple(x.shape), capacity)
    out = x.new_zeros((capacity,) + tuple(x.shape[1:]))
    out[:x.shape[0]] = x
    return out


def _pad_state(state: LandmarkState, capacity: int) -> LandmarkState:
    """Zero-pad every user-indexed array to ``capacity`` rows. Zero filler
    is inert: zero rating rows have mask 0 and mean 0, zero graph rows
    weight 0."""
    if state.graph is None:
        raise ValueError("bucketed serving needs a graph-backed state; "
                         "dense-sims states must refit")
    graph = state.graph.to_full() if state.graph.is_compact else state.graph
    return LandmarkState(
        state.landmark_idx.clone(),
        _pad_rows(state.representation, capacity),
        _pad_rows(state.ratings, capacity),
        graph=NeighborGraph(_pad_rows(graph.indices, capacity),
                            _pad_rows(graph.weights, capacity)))


def from_state(state: LandmarkState, min_bucket: int = DEFAULT_MIN_BUCKET,
               growth: float = DEFAULT_GROWTH) -> BucketedState:
    """Wrap a fitted state into the smallest bucket that holds it; the
    wrapped state shares no storage with ``state``."""
    u = state.ratings.shape[0]
    return BucketedState(_pad_state(state, bucket_capacity(u, min_bucket,
                                                           growth)), u)


def ensure_capacity(bstate: BucketedState, incoming: int,
                    min_bucket: int = DEFAULT_MIN_BUCKET,
                    growth: float = DEFAULT_GROWTH
                    ) -> Tuple[BucketedState, bool]:
    """Growth check before a fold-in of ``incoming`` rows: returns
    ``(state, grew)``, re-padded to the next capacity on the schedule when
    the bucket would overflow (the one deliberate change of geometry)."""
    need = bstate.n_valid + incoming
    if need <= bstate.capacity:
        return bstate, False
    cap = bucket_capacity(need, min_bucket, growth)
    return BucketedState(_pad_state(bstate.state, cap), bstate.n_valid), True


def fold_in_bucketed(bstate: BucketedState, new_ratings: torch.Tensor,
                     b_valid: int, spec: LandmarkSpec,
                     backend: str = "auto",
                     landmarks: Optional[torch.Tensor] = None
                     ) -> BucketedState:
    """Shape-stable ``fold_in``: fill padded slots instead of growing arrays.

    The same math as ``core.landmark_cf.fold_in`` (d1 through the frozen
    landmarks — the d1 kernel on the card — then the bucketed new-vs-all
    scan and back-patch), restricted to the valid prefix. ``new_ratings``
    is a (bq, P) batch bucket whose rows ``>= b_valid`` are filler. The
    caller guarantees ``n_valid + bq <= capacity`` (:func:`ensure_capacity`).
    ``landmarks`` (n, P) overrides the projection basis, which is otherwise
    ``ratings[landmark_idx]`` (``mutation`` passes its frozen snapshot: an
    update may have rewritten a landmark user's row).

    The ratings and representation of ``bstate`` are updated in place (the
    reference donates them): treat the passed-in state as consumed.
    """
    st = bstate.state
    n_valid = bstate.n_valid
    bq = new_ratings.shape[0]
    record_geometry("fold", bstate.capacity, bq)
    q_valid = (torch.arange(bq, device=new_ratings.device) < b_valid)[:, None]
    new_ratings = torch.where(q_valid, new_ratings,
                              torch.zeros_like(new_ratings))
    if landmarks is None:
        landmarks = st.ratings[st.landmark_idx]  # (n, P) frozen at fit
    new_rep = ops.masked_similarity(new_ratings, landmarks, spec.d1)
    new_rep = torch.where(q_valid, new_rep, torch.zeros_like(new_rep))
    st.ratings[n_valid:n_valid + bq] = new_ratings
    st.representation[n_valid:n_valid + bq] = new_rep
    graph = extend_neighbor_graph_bucketed(st.graph, st.representation,
                                           new_rep, n_valid, int(b_valid),
                                           spec.d2, backend)
    return BucketedState(
        LandmarkState(st.landmark_idx, st.representation, st.ratings,
                      graph=graph),
        n_valid + int(b_valid))


def fold_in_rows(bstate: BucketedState, rows, bq: int, spec: LandmarkSpec,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 growth: float = DEFAULT_GROWTH) -> BucketedState:
    """Fold ``rows`` (numpy or tensor, (N, P)) in ``bq``-row padded batches.

    Capacity is reserved for the padded batches (``ceil(N/bq)·bq`` rows): a
    ragged last batch still writes ``bq`` rows, which must never run past
    the capacity edge.
    """
    n = len(rows)
    bstate, _ = ensure_capacity(bstate, -(-n // bq) * bq if n else 0,
                                min_bucket, growth)
    dev = bstate.state.ratings.device
    p = bstate.state.ratings.shape[1]
    rows = torch.as_tensor(rows, dtype=torch.float32, device=dev)
    for lo in range(0, n, bq):
        chunk = rows[lo:lo + bq]
        m = chunk.shape[0]
        padded = torch.zeros((bq, p), dtype=torch.float32, device=dev)
        padded[:m] = chunk
        bstate = fold_in_bucketed(bstate, padded, m, spec)
    return bstate


def predict_pairs(bstate: BucketedState, users: torch.Tensor,
                  items: torch.Tensor) -> torch.Tensor:
    """Serve-path pair predictions with the padded-row mask threaded
    through."""
    record_geometry("pair", bstate.capacity, users.shape[0])
    return knn.predict_pairs_graph(bstate.state.graph, bstate.state.ratings,
                                   users, items, n_valid=bstate.n_valid)


def recommend_topn(bstate: BucketedState, users: torch.Tensor, n: int = 10):
    """Serve-path top-N with the padded-row mask threaded through."""
    record_geometry("topn", bstate.capacity, users.shape[0])
    return knn.recommend_topn_graph(bstate.state.graph, bstate.state.ratings,
                                    users, n=n, n_valid=bstate.n_valid)


def compact_state(bstate: BucketedState) -> BucketedState:
    """Swap the serving graph to the compact (uint16/bf16) artifact.

    Gated by ``lifecycle.policy.should_compact`` (capacity < 65536): reads
    widen the gathered rows on the fly (``core.knn._gathered``), and the
    next capacity growth or bucketed fold-in widens the whole graph back
    (``_pad_state`` / ``extend_neighbor_graph_bucketed``). A state that is
    already compact comes back as the same object.
    """
    st = bstate.state
    if st.graph is None or st.graph.is_compact:
        return bstate
    return BucketedState(
        LandmarkState(st.landmark_idx, st.representation, st.ratings,
                      graph=st.graph.to_compact()),
        bstate.n_valid)
