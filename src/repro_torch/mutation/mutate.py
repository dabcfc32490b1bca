"""Write-path mutations on a served landmark-CF state — updates, GDPR
deletion, decremental neighbor-graph repair and compaction, on one device.

- :class:`MutableState` wraps a ``BucketedState`` with two (capacity,) bool
  bitmaps — ``tomb`` (deleted rows) and ``dirty`` (rows whose neighbor list
  needs a rescan) — and a frozen (n, P) snapshot of the landmark rating
  rows: the projection basis. Updating or deleting a landmark user must not
  move every other user's representation, so the basis stays frozen until
  the next refresh re-selects landmarks.
- :func:`update_ratings` re-projects the changed rows through the frozen
  landmarks (d1: the kernel on the card), writes ratings and representation,
  marks the changed rows and every row citing one dirty, and merges the
  changed users into every other live row's list: a (capacity, b) block of
  fresh similarities (``core.graph.backpatch_sims``: kernel 6's shared
  form on the card, so a score depends on its two rows alone, whatever the
  block's row count), its columns in ascending id order so a positional
  canonical top-k breaks ties by id, then a rank-count merge
  (``core.graph.merge_canonical_topk``).
- :func:`remove_users` sets tomb bits, zeroes the removed rows' ratings and
  representation (erased, not hidden), evicts every citation of a removed id
  (``core.graph.evict_neighbors``) and marks the rows that lost one dirty.
  Reads mask tombstoned rows (``core.knn``'s ``tomb``), so a removal is
  invisible the moment it publishes, before any repair.
- :func:`repair` rescans up to ``bq`` dirty rows over the live rows. The
  ``kernel`` backend (``auto`` on a CUDA tensor) gathers the live rows in
  ascending id order and runs the fold-in top-k scan kernel
  (``kernels.knn_topk.foldin_topk``) for k+1 neighbors, maps the ids back
  (a monotone map: the kernel's id-ascending tie order stays canonical) and
  drops each row's own id; ``streaming`` (``auto`` on a CPU tensor) scans
  (bq, chunk) tiles with the tombstones masked; with an IVF index the
  rescan is ``retrieval.search(..., tomb=)``.
- :func:`compact_tombstones` removes the tombstoned rows at a refresh
  boundary: live rows slide down in id order and neighbor ids remap through
  the monotone old→new table (``NeighborGraph.remap``).

Every function returns a new state and writes no tensor of the state it is
given, which a published generation may still be serving reads from. Ids
that do not take effect (batch filler, out of range, already tombstoned)
are routed to a drop row past the capacity and sliced off: no
out-of-range index reaches a device scatter. After the repairs drain, the
state agrees with a from-scratch build on the mutated matrix with the same
frozen basis: ratings and representation bitwise, the graph under the tie
rule (``core.topk.list_mismatches``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import obs as obslib
from ..core import knn
from ..core.graph import (_streaming_query_topk, backpatch_sims,
                          evict_neighbors, filter_self_from_topk,
                          finalize_topk, kernel_rows, merge_canonical_topk,
                          resolve_backend)
from ..core.landmark_cf import LandmarkState
from ..core.topk import canonical_topk
from ..core.types import LandmarkSpec, NeighborGraph
from ..kernels import knn_topk, ops
from ..lifecycle import buckets


@dataclasses.dataclass(frozen=True)
class MutableState:
    """A served ``BucketedState`` opened for mutation.

    ``tomb[i]``: row i is deleted — masked out of every read, physically
    removed at the next :func:`compact_tombstones`. ``dirty[i]``: row i's
    neighbor list lost an entry or belongs to a changed user, and needs a
    :func:`repair` rescan. ``landmarks`` is the frozen (n, P) basis.
    """

    bstate: buckets.BucketedState
    landmarks: torch.Tensor  # (n, P) frozen landmark rating rows
    tomb: torch.Tensor  # (capacity,) bool
    dirty: torch.Tensor  # (capacity,) bool

    @property
    def capacity(self) -> int:
        return self.bstate.capacity

    @property
    def n_valid(self) -> int:
        """Append high-water mark: tombstoned rows count until compaction."""
        return self.bstate.n_valid

    def n_live(self) -> int:
        return self.n_valid - int(self.tomb.sum())

    def tombstone_frac(self) -> float:
        """Tombstoned share of the valid prefix — the compaction signal
        (``lifecycle.policy.should_compact_tombstones``)."""
        n = self.n_valid
        return int(self.tomb.sum()) / n if n else 0.0

    def dirty_count(self) -> int:
        need = self.dirty & ~self.tomb
        return int(need[:self.n_valid].sum())


def from_bucketed(bstate: buckets.BucketedState) -> MutableState:
    """Open a bucketed state for mutation, freezing the landmark basis."""
    st = bstate.state
    z = torch.zeros(bstate.capacity, dtype=torch.bool,
                    device=st.ratings.device)
    return MutableState(bstate, st.ratings[st.landmark_idx], z, z.clone())


def from_fitted(state: LandmarkState,
                min_bucket: int = buckets.DEFAULT_MIN_BUCKET,
                growth: float = buckets.DEFAULT_GROWTH) -> MutableState:
    """Wrap a freshly fitted state."""
    return from_bucketed(buckets.from_state(state, min_bucket, growth))


def _grow_masks(mst: MutableState, bstate: buckets.BucketedState
                ) -> MutableState:
    """Re-wrap after a capacity regrow: the bitmaps padded with False."""
    pad = bstate.capacity - mst.tomb.shape[0]
    if pad <= 0:
        return MutableState(bstate, mst.landmarks, mst.tomb, mst.dirty)
    z = mst.tomb.new_zeros(pad)
    return MutableState(bstate, mst.landmarks, torch.cat([mst.tomb, z]),
                        torch.cat([mst.dirty, z]))


def _with(mst: MutableState, n_valid: Optional[int] = None, *,
          tomb=None, dirty=None, **state) -> MutableState:
    """A new MutableState: ``state`` replaces fields of the LandmarkState."""
    bst = mst.bstate
    return MutableState(
        buckets.BucketedState(dataclasses.replace(bst.state, **state),
                              bst.n_valid if n_valid is None else n_valid),
        mst.landmarks, mst.tomb if tomb is None else tomb,
        mst.dirty if dirty is None else dirty)


def _full_graph(mst: MutableState) -> NeighborGraph:
    g = mst.bstate.state.graph
    return g.to_full() if g.is_compact else g


def _set_rows(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """A fresh copy of ``x`` with rows ``idx`` set to ``val``; index
    ``len(x)`` is the drop row, written into a spare row and sliced off."""
    out = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    out[idx] = val
    return out[:x.shape[0]]


def _effective(mst: MutableState, ids, b_valid: int):
    """(ids, eff, safe): a batch's ids as int64 on the state's device,
    which of them take effect (within ``b_valid``, in ``[0, n_valid)``, not
    tombstoned), and the ids with every other entry sent to the drop row."""
    cap = mst.capacity
    dev = mst.tomb.device
    ids = torch.as_tensor(ids, device=dev).to(torch.int64)
    eff = ((torch.arange(ids.shape[0], device=dev) < b_valid) & (ids >= 0)
           & (ids < mst.n_valid) & ~mst.tomb[ids.clamp(0, cap - 1)])
    return ids, eff, torch.where(eff, ids, torch.full_like(ids, cap))


# --------------------------------------------------------------------- update
def update_ratings(mst: MutableState, ids, rows, b_valid: int,
                   spec: LandmarkSpec) -> MutableState:
    """Replace ``b_valid`` users' rating rows (re-rate and un-rate).

    ``ids`` (b,) and ``rows`` (b, P) form a padded batch: entries
    ``>= b_valid`` are filler. A row is the user's complete new rating
    vector (0 un-rates). Ids must be unique within a batch; updates of
    tombstoned or out-of-range ids are dropped.

    Graph: the changed rows and every row citing one go dirty (rescan in
    :func:`repair`); every other live row gets the changed users merged
    into its list — exact because such a row holds the true top-k of the
    other candidates. Rows holding an inert (0, 0.0) slot go dirty instead
    of merging: the stored zero would shadow a negative new similarity.
    """
    st = mst.bstate.state
    cap = mst.capacity
    dev = st.ratings.device
    graph = _full_graph(mst)
    k = graph.k
    ids, eff, safe = _effective(mst, ids, b_valid)
    b = ids.shape[0]
    rows = torch.as_tensor(rows, dtype=torch.float32, device=dev)
    rows = torch.where(eff[:, None], rows, torch.zeros_like(rows))
    new_rep = ops.masked_similarity(rows, mst.landmarks, spec.d1)  # (b, n)
    new_rep = torch.where(eff[:, None], new_rep, torch.zeros_like(new_rep))
    ratings = _set_rows(st.ratings, safe, rows)
    rep = _set_rows(st.representation, safe, new_rep)

    row = torch.arange(cap, device=dev)
    changed = _set_rows(torch.zeros(cap, dtype=torch.bool, device=dev), safe,
                        eff)
    row_valid = (row < mst.n_valid) & ~mst.tomb
    victim = changed[graph.indices.long()].any(dim=1)
    inert_row = ((graph.indices == 0) & (graph.weights == 0)).any(dim=1)
    dirty = mst.dirty | (row_valid & (changed | victim | inert_row))

    # back-patch every clean live row with the changed users' fresh
    # similarities — the (capacity, b) block, columns in ascending id order
    back = backpatch_sims(rep, new_rep, spec.d2)
    col_ok = eff[None, :] & (row[:, None] != safe[None, :])
    back = back.masked_fill(~col_ok, float("-inf"))
    order = torch.sort(safe, stable=True).indices  # effective ids first
    cand = torch.where(eff, ids, torch.zeros_like(ids)).to(torch.int32)[order]
    bv, bsel = canonical_topk(back[:, order], min(k, b))
    pv, pi = merge_canonical_topk(graph.weights, graph.indices, bv,
                                  cand[bsel], k)
    patched = finalize_topk(pv, pi)
    patch = (row_valid & ~dirty)[:, None]
    graph = NeighborGraph(torch.where(patch, patched.indices, graph.indices),
                          torch.where(patch, patched.weights, graph.weights))
    return _with(mst, dirty=dirty, ratings=ratings, representation=rep,
                 graph=graph)


# --------------------------------------------------------------------- remove
def remove_users(mst: MutableState, ids, b_valid: int) -> MutableState:
    """Tombstone ``b_valid`` users (GDPR deletion): tomb bits set, their
    ratings and representation zeroed, every citation of them evicted (the
    rows that lost one go dirty), and their own lists made inert with no
    repair owed. ``n_valid`` (the append mark) is unchanged."""
    st = mst.bstate.state
    cap = mst.capacity
    dev = st.ratings.device
    _, eff, safe = _effective(mst, ids, b_valid)
    tomb = _set_rows(mst.tomb, safe, True)
    ratings = _set_rows(st.ratings, safe, 0.0)
    rep = _set_rows(st.representation, safe, 0.0)
    graph, hit = evict_neighbors(_full_graph(mst), tomb)
    row_valid = (torch.arange(cap, device=dev) < mst.n_valid) & ~tomb
    dirty = _set_rows(mst.dirty | (hit & row_valid), safe, False)
    graph = NeighborGraph(_set_rows(graph.indices, safe, 0),
                          _set_rows(graph.weights, safe, 0.0))
    return _with(mst, tomb=tomb, dirty=dirty, ratings=ratings,
                 representation=rep, graph=graph)


# --------------------------------------------------------------------- repair
def _rescan_kernel(queries: torch.Tensor, rep: torch.Tensor, measure: str,
                   k: int, n_valid: int, tomb: torch.Tensor,
                   self_ids: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's top-k over the live rows through the fold-in scan
    kernel: the live rows gathered in ascending id order, k+1 neighbors
    (self may be among them), ids mapped back, self dropped."""
    if k + 1 > knn_topk.MAX_K:
        raise ValueError(f"the kernel rescan takes k+1 <= {knn_topk.MAX_K} "
                         f"neighbors; k={k}")
    live = torch.nonzero(~tomb[:n_valid]).flatten()  # ascending
    vals, idx = knn_topk.foldin_topk(
        kernel_rows(queries, measure), kernel_rows(rep[live], measure),
        k=k + 1, n_valid=live.numel(), measure=measure)
    ids = live[idx.long()] if live.numel() else idx.long()
    ids = torch.where(torch.isfinite(vals), ids, torch.zeros_like(ids))
    return filter_self_from_topk(vals, ids.to(torch.int32), self_ids, k)


def _rescan(queries: torch.Tensor, rep: torch.Tensor, measure: str, k: int,
            n_valid: int, tomb: torch.Tensor, self_ids: torch.Tensor,
            mode: str, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's top-k over the live rows of ``rep`` (below ``n_valid``,
    not in ``tomb``), its own id (``self_ids``; -1 names none) left out:
    through the scan kernel (``kernel``) or in (b, chunk) tiles
    (``streaming``)."""
    if mode == "kernel":
        return _rescan_kernel(queries, rep, measure, k, n_valid, tomb,
                              self_ids)
    if mode == "streaming":
        return _streaming_query_topk(queries, rep, measure, k, chunk, 0,
                                     n_valid, self_ids=self_ids, dead=tomb)
    raise ValueError(f"repair rescans with the kernel or streaming "
                     f"backend, not {mode!r}")


def repair(mst: MutableState, bq: int, spec: LandmarkSpec, *,
           chunk: int = 4096, ivf_index=None, nprobe: Optional[int] = None,
           backend: str = "auto") -> Tuple[MutableState, int]:
    """Rebuild the lowest-id ``bq`` dirty rows' neighbor lists; returns
    ``(state, n_repaired)``.

    ``backend``: ``kernel`` (``auto`` on a CUDA tensor) rescans through the
    fold-in scan kernel, ``streaming`` (``auto`` on a CPU tensor) in plain
    torch; with an ``ivf_index`` over the rows the rescan probes its
    ``nprobe`` nearest cells (default all: exact) instead. Tombstoned
    candidates are masked either way.
    """
    st = mst.bstate.state
    cap = mst.capacity
    dev = st.ratings.device
    n_valid = mst.n_valid
    graph = _full_graph(mst)
    k = graph.k
    need = (mst.dirty & ~mst.tomb
            & (torch.arange(cap, device=dev) < n_valid))
    sel = torch.nonzero(need).flatten()[:bq]  # ascending dirty ids
    if not sel.numel():
        return mst, 0
    queries = st.representation[sel]
    if ivf_index is not None:
        from ..retrieval import search

        np_ = ivf_index.n_clusters if nprobe is None else nprobe
        vals, idx = search(ivf_index, queries, k, np_, spec.d2,
                           self_ids=sel, tomb=mst.tomb)
        # drop candidates above the live prefix (the index may hold stale
        # slots)
        vals, si = canonical_topk(vals.masked_fill(idx >= n_valid,
                                                   float("-inf")), k)
        idx = idx.gather(1, si)
    else:
        vals, idx = _rescan(queries, st.representation, spec.d2, k, n_valid,
                            mst.tomb, sel, resolve_backend(backend, dev),
                            chunk)
    fixed = finalize_topk(vals, idx)
    gi, gw, dirty = graph.indices.clone(), graph.weights.clone(), \
        mst.dirty.clone()
    gi[sel] = fixed.indices
    gw[sel] = fixed.weights
    dirty[sel] = False
    return _with(mst, dirty=dirty, graph=NeighborGraph(gi, gw)), sel.numel()


def drain_repairs(mst: MutableState, spec: LandmarkSpec, bq: int = 64, *,
                  chunk: int = 4096, ivf_index=None,
                  nprobe: Optional[int] = None,
                  backend: str = "auto") -> MutableState:
    """Run :func:`repair` until no dirty row is left. With an obs instance
    installed, the drain is one ``repair.drain`` span and its rows land on
    the ``mutation.repair_drains`` / ``mutation.repaired_rows`` counters."""
    n0 = mst.dirty_count()
    with obslib.span("repair.drain", cat="mutation", args={"rows": n0}):
        left = n0  # a repair clears the bits of the rows it rescans
        while left > 0:
            mst, done = repair(mst, bq, spec, chunk=chunk,
                               ivf_index=ivf_index, nprobe=nprobe,
                               backend=backend)
            left -= done
    o = obslib.current()
    if o is not None and o.enabled and n0:
        o.registry.counter("mutation.repair_drains").inc()
        o.registry.counter("mutation.repaired_rows").inc(n0)
    return mst


# ------------------------------------------------------------------ lifecycle
def compact_tombstones(mst: MutableState) -> MutableState:
    """Physically remove the tombstoned rows (the refresh-boundary
    compaction): live rows slide down in id order, neighbor ids remap
    through the monotone old→new table (which keeps the canonical tie
    order), the bitmaps reset, the capacity stays. Needs a drained dirty
    bitmap: compacting unrepaired rows would freeze their staleness in."""
    if mst.dirty_count():
        raise ValueError("drain repairs before compacting")
    cap, n_valid = mst.capacity, mst.n_valid
    dev = mst.tomb.device
    tomb = mst.tomb.cpu().numpy()
    with obslib.span("compact", cat="mutation",
                     args={"dropped": int(tomb[:n_valid].sum())}):
        live = ~tomb & (np.arange(cap) < n_valid)
        src = torch.as_tensor(np.nonzero(live)[0], device=dev)
        n_live = int(src.numel())
        table = np.zeros(cap, np.int32)
        table[live] = np.arange(n_live, dtype=np.int32)

        def gather(x):
            out = torch.zeros_like(x)
            out[:n_live] = x[src]
            return out

        st = mst.bstate.state
        graph = _full_graph(mst).remap(torch.as_tensor(table, device=dev))
        z = torch.zeros(cap, dtype=torch.bool, device=dev)
        return _with(mst, n_live, tomb=z, dirty=z.clone(),
                     representation=gather(st.representation),
                     ratings=gather(st.ratings),
                     graph=NeighborGraph(gather(graph.indices),
                                         gather(graph.weights)))


def fold_in_rows(mst: MutableState, rows, bq: int, spec: LandmarkSpec,
                 min_bucket: int = buckets.DEFAULT_MIN_BUCKET,
                 growth: float = buckets.DEFAULT_GROWTH) -> MutableState:
    """Append new users (the fold lane, mutation-aware) in ``bq``-row
    padded batches of :func:`fold_in_mutable`; capacity is reserved for the
    padded batches first."""
    n = len(rows)
    bst, _ = buckets.ensure_capacity(mst.bstate, -(-n // bq) * bq if n else 0,
                                     min_bucket, growth)
    mst = _grow_masks(mst, bst)
    dev = mst.tomb.device
    p = bst.state.ratings.shape[1]
    rows = torch.as_tensor(rows, dtype=torch.float32, device=dev)
    for lo in range(0, n, bq):
        chunk = rows[lo:lo + bq]
        m = chunk.shape[0]
        padded = torch.zeros((bq, p), dtype=torch.float32, device=dev)
        padded[:m] = chunk
        mst = fold_in_mutable(mst, padded, m, spec)
    return mst


def fold_in_mutable(mst: MutableState, new_ratings: torch.Tensor,
                    b_valid: int, spec: LandmarkSpec) -> MutableState:
    """One bucketed fold-in step through the frozen basis, on copies of the
    ratings and representation (``buckets.fold_in_bucketed`` writes them in
    place). Its new-vs-all scan masks candidates by prefix only, so a
    tombstoned row can be picked as a new row's neighbor (a zeroed
    representation still scores: euclidean gives it a positive similarity);
    one eviction pass removes those citations and marks the rows dirty."""
    st = mst.bstate.state
    work = buckets.BucketedState(
        dataclasses.replace(st, ratings=st.ratings.clone(),
                            representation=st.representation.clone()),
        mst.n_valid)
    bst = buckets.fold_in_bucketed(work, new_ratings, b_valid, spec,
                                   landmarks=mst.landmarks)
    graph, hit = evict_neighbors(bst.state.graph, mst.tomb)
    row_valid = ((torch.arange(bst.capacity, device=mst.tomb.device)
                  < bst.n_valid) & ~mst.tomb)
    return MutableState(
        buckets.BucketedState(dataclasses.replace(bst.state, graph=graph),
                              bst.n_valid),
        mst.landmarks, mst.tomb, mst.dirty | (hit & row_valid))


# ------------------------------------------------------------------- serving
def predict_pairs(mst: MutableState, users: torch.Tensor,
                  items: torch.Tensor) -> torch.Tensor:
    """Pair predictions with the padding and tombstone masks threaded
    through (geometry recorded as the bucketed pair step's)."""
    bst = mst.bstate
    buckets.record_geometry("pair", bst.capacity, users.shape[0])
    return knn.predict_pairs_graph(bst.state.graph, bst.state.ratings,
                                   users, items, n_valid=bst.n_valid,
                                   tomb=mst.tomb)


def recommend_topn(mst: MutableState, users: torch.Tensor, n: int = 10):
    """Top-N with the padding and tombstone masks threaded through."""
    bst = mst.bstate
    buckets.record_geometry("topn", bst.capacity, users.shape[0])
    return knn.recommend_topn_graph(bst.state.graph, bst.state.ratings,
                                    users, n=n, n_valid=bst.n_valid,
                                    tomb=mst.tomb)
