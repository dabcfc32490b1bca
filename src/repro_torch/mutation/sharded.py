"""The write path on a mesh: updates, GDPR deletion, repair and compaction
of a ``ShardedLandmarkState`` (``core.landmark_cf``), held bitwise to the
one-device write path (:mod:`.mutate`) through the sharded-id bijection.

All ids here are *sharded* row ids (``shard * C + slot``). The row payload
(ratings, representation, graph) stays in its shard's blocks; what every
shard must read at any row id is replicated:

- ``tomb`` and ``dirty``, the (S·C,) bitmaps, and ``rank``, the (S·C,)
  logical rank of every sharded id (``ShardedLandmarkState.row_rank``
  gathered), are each one tensor on shard 0's device, the device the
  routed reads gather on; a shard reads them at its own ids (a slice, or
  the ids its graph block cites), moved to its device. They are the only
  tensors of S·C entries the write path builds: one bool or int per row,
  as the reference replicates them.
- ties break by logical rank wherever one device breaks them by id (the
  update's back-patch columns and merge, an eviction's re-sort, the repair
  merge), so every list is the one-device list with its ids mapped.

- :func:`update_ratings_sharded` — the owner shard writes the rows; d1
  (kernel 1) re-projects them through the frozen basis; each shard
  back-patches its clean rows from its own (C, b) block scored by
  ``core.graph.backpatch_sims`` (kernel 6's shared form on the card), so a
  score depends on its two rows alone, and merges the changed users in by
  rank.
- :func:`remove_users_sharded` — tomb bits set, the removed rows zeroed on
  their own shard, every citation evicted on every shard.
- :func:`repair_sharded` — the dirty queries' representations gathered
  (a (bq, n) payload), a masked top-(k+1) over each shard's live rows
  (kernel 3 on the card, as ``mutate._rescan_kernel``; ``streaming`` on
  the CPU), self dropped, then the (bq, k) candidate lists gathered and
  merged by weight descending, logical rank ascending.
- :func:`compact_tombstones_sharded` — live slots slide down within each
  shard (rows never change owner), neighbor ids remap old → new sharded
  id, and the rank table is renumbered densely in logical order, so the
  ranks are again the one-device ids after its compaction (and the next
  fold-in's ranks follow on without a gap).
- :func:`fold_in_rows_sharded` — the bucketed sharded fold-in through the
  frozen basis on a copy of the state, then the eviction pass the
  one-device ``fold_in_mutable`` runs.

Every function returns a new state and writes no tensor of the state it is
given: a shard's block is copied before a write lands in it, and a block
no write touches is shared with the new state.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import obs as obslib
from ..core import knn
from ..core.graph import (backpatch_sims, evict_neighbors, finalize_topk,
                          merge_canonical_topk, resolve_backend)
from ..core.landmark_cf import ShardedLandmarkState, fold_in_sharded
from ..core.topk import canonical_topk
from ..core.types import LandmarkSpec, NeighborGraph
from ..distributed.sharding import all_gather_rows, gather_rows
from ..kernels import ops
from ..lifecycle import buckets
from .mutate import _rescan

INT64_MAX = torch.iinfo(torch.int64).max


@dataclasses.dataclass(frozen=True)
class MutableStateSharded:
    """A served ``ShardedLandmarkState`` opened for mutation: the frozen
    (n, P) landmark basis and the replicated (S·C,) ``tomb``/``dirty``
    bitmaps and ``rank`` table, each on shard 0's device."""

    sstate: ShardedLandmarkState
    landmarks: torch.Tensor  # (n, P) frozen landmark rating rows
    tomb: torch.Tensor  # (S*C,) bool
    dirty: torch.Tensor  # (S*C,) bool
    rank: torch.Tensor  # (S*C,) int64 logical rank of each sharded id

    @property
    def capacity(self) -> int:
        return self.sstate.capacity

    @property
    def shard_count(self) -> int:
        return self.sstate.shard_count

    @property
    def home(self) -> torch.device:
        return self.sstate.devices[0]

    def fill_mask(self) -> np.ndarray:
        """(S·C,) host bool: the slot lies below its shard's fill."""
        c = self.capacity
        gid = np.arange(self.shard_count * c)
        return gid % c < np.asarray(self.sstate.n_valid)[gid // c]

    def n_live(self) -> int:
        return self.sstate.total_valid - int(self.tomb.sum())

    def tombstone_frac(self) -> float:
        n = self.sstate.total_valid
        return int(self.tomb.sum()) / n if n else 0.0

    def dirty_count(self) -> int:
        need = self.dirty.cpu().numpy() & ~self.tomb.cpu().numpy()
        return int((need & self.fill_mask()).sum())


def _rank_table(sstate: ShardedLandmarkState) -> torch.Tensor:
    return all_gather_rows(sstate.row_rank, sstate.devices[0]).to(
        torch.int64)


def from_sharded(sstate: ShardedLandmarkState) -> MutableStateSharded:
    """Open a sharded state for mutation: the landmark basis frozen (its
    rows gathered from their owner shards), the rank table replicated."""
    home = sstate.devices[0]
    z = torch.zeros(sstate.shard_count * sstate.capacity, dtype=torch.bool,
                    device=home)
    return MutableStateSharded(sstate, sstate.landmarks(), z, z.clone(),
                               _rank_table(sstate))


def _blocks(slices, home) -> torch.Tensor:
    return torch.cat([x.to(home) for x in slices])


def _effective(msst: MutableStateSharded, ids, b_valid: int):
    """(ids, eff, safe) on shard 0: a batch's sharded ids as int64, which
    of them take effect (within ``b_valid``, a filled slot, not
    tombstoned), and the ids with every other entry sent to the drop row
    S·C."""
    home, c = msst.home, msst.capacity
    rows = msst.shard_count * c
    ids = torch.as_tensor(ids, device=home).to(torch.int64)
    ids_h = ids.cpu().numpy()
    owner = np.clip(ids_h // c, 0, msst.shard_count - 1)
    filled = ((ids_h >= 0) & (ids_h < rows)
              & (ids_h % c < np.asarray(msst.sstate.n_valid)[owner]))
    eff = ((torch.arange(ids.shape[0], device=home) < b_valid)
           & torch.as_tensor(filled, device=home)
           & ~msst.tomb[ids.clamp(0, rows - 1)])
    return ids, eff, torch.where(eff, ids, torch.full_like(ids, rows))


def _owned(safe: torch.Tensor, s: int, c: int):
    """(positions in the batch, on ``safe``'s device; local slots, a host
    array) of the effective ids shard s owns."""
    sh = safe.cpu().numpy()
    pos = np.nonzero(sh // c == s)[0]
    return torch.as_tensor(pos, device=safe.device), sh[pos] % c


def _set_bits(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """A fresh copy of the (S·C,) table ``x`` with ``idx`` set to ``val``;
    index S·C is the drop row."""
    out = torch.cat([x, x.new_zeros(1)])
    out[idx] = val
    return out[:x.shape[0]]


def _write_rows(block: torch.Tensor, slots, val) -> torch.Tensor:
    """``block`` itself when no slot is written, else a copy with rows
    ``slots`` set to ``val``."""
    if not len(slots):
        return block
    out = block.clone()
    out[torch.as_tensor(slots, device=block.device)] = (
        val.to(block.device) if isinstance(val, torch.Tensor) else val)
    return out


def _full(g: NeighborGraph) -> NeighborGraph:
    return g.to_full() if g.is_compact else g


# --------------------------------------------------------------------- update
def update_ratings_sharded(msst: MutableStateSharded, ids, rows,
                           b_valid: int, spec: LandmarkSpec
                           ) -> MutableStateSharded:
    """``mutate.update_ratings`` on the mesh: ``ids`` (b,) sharded row ids
    and ``rows`` (b, P) a padded batch (entries ``>= b_valid`` filler). See
    that function for the dirty / back-patch split; here each shard
    back-patches its own rows, with the batch's columns in logical-rank
    order and the merge breaking ties by rank."""
    sst = msst.sstate
    c, home = msst.capacity, msst.home
    ids, eff, safe = _effective(msst, ids, b_valid)
    b = ids.shape[0]
    k = sst.k
    rows = torch.as_tensor(rows, dtype=torch.float32, device=home)
    rows = torch.where(eff[:, None], rows, torch.zeros_like(rows))
    new_rep = ops.masked_similarity(rows, msst.landmarks, spec.d1)  # (b, n)
    new_rep = torch.where(eff[:, None], new_rep, torch.zeros_like(new_rep))
    changed = _set_bits(torch.zeros_like(msst.tomb), safe, eff)
    # the batch's columns in logical-rank order (effective ids first), the
    # order one device's ascending ids give
    clamped = ids.clamp(0, msst.rank.shape[0] - 1)
    order = torch.sort(torch.where(eff, msst.rank[clamped],
                                   torch.full_like(ids, INT64_MAX)),
                       stable=True).indices
    cand = torch.where(eff, ids, torch.zeros_like(ids)).to(torch.int32)
    cand_rank = msst.rank[cand.long()]
    cand, cand_rank = cand[order], cand_rank[order]

    reps, ratings, graphs, dirty = [], [], [], []
    for s, dev in enumerate(sst.devices):
        pos, slots = _owned(safe, s, c)
        rep_s = _write_rows(sst.representation[s], slots, new_rep[pos])
        ratings.append(_write_rows(sst.ratings[s], slots, rows[pos]))
        reps.append(rep_s)
        g = _full(sst.graph[s])
        lo, hi = s * c, (s + 1) * c
        slot = torch.arange(c, device=dev)
        row_valid = (slot < sst.n_valid[s]) & ~msst.tomb[lo:hi].to(dev)
        victim = changed.to(dev)[g.indices.long()].any(dim=1)
        inert = ((g.indices == 0) & (g.weights == 0)).any(dim=1)
        dirty_s = msst.dirty[lo:hi].to(dev) | (
            row_valid & (changed[lo:hi].to(dev) | victim | inert))
        back = backpatch_sims(rep_s, new_rep.to(dev), spec.d2)  # (C, b)
        col_ok = eff.to(dev)[None, :] & ((lo + slot)[:, None]
                                         != safe.to(dev)[None, :])
        back = back.masked_fill(~col_ok, float("-inf"))
        bv, bsel = canonical_topk(back[:, order.to(dev)], min(k, b))
        pv, pi = merge_canonical_topk(
            g.weights, g.indices, bv, cand.to(dev)[bsel], k,
            a_rank=msst.rank.to(dev)[g.indices.long()],
            b_rank=cand_rank.to(dev)[bsel])
        patched = finalize_topk(pv, pi)
        patch = (row_valid & ~dirty_s)[:, None]
        graphs.append(NeighborGraph(
            torch.where(patch, patched.indices, g.indices),
            torch.where(patch, patched.weights, g.weights)))
        dirty.append(dirty_s)
    return dataclasses.replace(
        msst, sstate=dataclasses.replace(sst, representation=reps,
                                         ratings=ratings, graph=graphs),
        dirty=_blocks(dirty, home))


# --------------------------------------------------------------------- remove
def remove_users_sharded(msst: MutableStateSharded, ids, b_valid: int
                         ) -> MutableStateSharded:
    """``mutate.remove_users`` on the mesh: the tomb bits set, the removed
    rows' ratings and representation zeroed on their own shard, every
    citation of them evicted on every shard (the rows that lost one go
    dirty), and their own lists made inert with no repair owed. The fills
    (the append marks) are unchanged."""
    sst = msst.sstate
    c, home = msst.capacity, msst.home
    _, _, safe = _effective(msst, ids, b_valid)
    tomb = _set_bits(msst.tomb, safe, True)
    reps, ratings, graphs, dirty = [], [], [], []
    for s, dev in enumerate(sst.devices):
        _, slots = _owned(safe, s, c)
        reps.append(_write_rows(sst.representation[s], slots, 0.0))
        ratings.append(_write_rows(sst.ratings[s], slots, 0.0))
        lo, hi = s * c, (s + 1) * c
        tomb_d = tomb.to(dev)
        g, hit = evict_neighbors(_full(sst.graph[s]), tomb_d,
                                 row_rank=msst.rank.to(dev))
        row_valid = ((torch.arange(c, device=dev) < sst.n_valid[s])
                     & ~tomb_d[lo:hi])
        dirty_s = msst.dirty[lo:hi].to(dev) | (hit & row_valid)
        if len(slots):
            sl = torch.as_tensor(slots, device=dev)
            dirty_s[sl] = False
            g = NeighborGraph(_write_rows(g.indices, slots, 0),
                              _write_rows(g.weights, slots, 0.0))
        graphs.append(g)
        dirty.append(dirty_s)
    return dataclasses.replace(
        msst, sstate=dataclasses.replace(sst, representation=reps,
                                         ratings=ratings, graph=graphs),
        tomb=tomb, dirty=_blocks(dirty, home))


# --------------------------------------------------------------------- repair
def repair_sharded(msst: MutableStateSharded, bq: int, spec: LandmarkSpec,
                   *, chunk: int = 4096, backend: str = "auto"
                   ) -> Tuple[MutableStateSharded, int]:
    """Rebuild the lowest-rank ``bq`` dirty rows' neighbor lists; returns
    ``(state, n_repaired)``. ``backend`` as in ``mutate.repair``, resolved
    per shard device: ``kernel`` (``auto`` on a CUDA shard) gathers the
    shard's live rows in slot order (which is rank order within a shard)
    and runs the fold-in scan kernel for k+1 neighbors; ``streaming``
    (``auto`` on a CPU shard) scans tiles with the tombstones masked. The
    shards' (bq, k) lists merge on shard 0 by weight descending, then
    logical rank ascending: the one-device rescan's list over all live
    rows."""
    sst = msst.sstate
    c, home = msst.capacity, msst.home
    k = sst.k
    need = msst.dirty & ~msst.tomb & torch.as_tensor(msst.fill_mask(),
                                                     device=home)
    cand = torch.nonzero(need).flatten()
    if not cand.numel():
        return msst, 0
    sel = cand[torch.sort(msst.rank[cand], stable=True).indices][:bq]
    queries = gather_rows(sst.representation, sel, c, home)
    owner = sel // c
    vs, gs, rs = [], [], []
    for s, dev in enumerate(sst.devices):
        lo, hi = s * c, (s + 1) * c
        fill = sst.n_valid[s]
        tomb_s = msst.tomb[lo:hi].to(dev)
        self_slots = torch.where(owner == s, sel % c,
                                 torch.full_like(sel, -1)).to(dev)
        v, i = _rescan(queries.to(dev), sst.representation[s], spec.d2, k,
                       fill, tomb_s, self_slots,
                       resolve_backend(backend, dev), chunk)
        g = lo + i.to(torch.int64)
        vs.append(v.to(home))
        gs.append(g.to(home))
        rs.append(msst.rank[g.to(home)])
    # canonical merge: two stable sorts, by logical rank, then by weight
    by_rank = torch.sort(torch.cat(rs, 1), dim=1, stable=True).indices
    v1 = torch.cat(vs, 1).gather(1, by_rank)
    g1 = torch.cat(gs, 1).gather(1, by_rank)
    top = torch.sort(v1, dim=1, descending=True, stable=True).indices[:, :k]
    fixed = finalize_topk(v1.gather(1, top), g1.gather(1, top))
    graphs = []
    for s, dev in enumerate(sst.devices):
        pos, slots = _owned(sel, s, c)
        g = _full(sst.graph[s])
        graphs.append(NeighborGraph(
            _write_rows(g.indices, slots, fixed.indices[pos]),
            _write_rows(g.weights, slots, fixed.weights[pos])))
    return dataclasses.replace(
        msst, sstate=dataclasses.replace(sst, graph=graphs),
        dirty=_set_bits(msst.dirty, sel, False)), int(sel.numel())


def drain_repairs_sharded(msst: MutableStateSharded, spec: LandmarkSpec,
                          bq: int = 64, *, chunk: int = 4096,
                          backend: str = "auto") -> MutableStateSharded:
    """Run :func:`repair_sharded` until no dirty row is left; the same
    ``repair.drain`` span and ``mutation.*`` counters as the one-device
    drain."""
    n0 = msst.dirty_count()
    with obslib.span("repair.drain", cat="mutation", args={"rows": n0}):
        left = n0
        while left > 0:
            msst, done = repair_sharded(msst, bq, spec, chunk=chunk,
                                        backend=backend)
            left -= done
    o = obslib.current()
    if o is not None and o.enabled and n0:
        o.registry.counter("mutation.repair_drains").inc()
        o.registry.counter("mutation.repaired_rows").inc(n0)
    return msst


# ------------------------------------------------------------------ lifecycle
def compact_tables(msst: MutableStateSharded):
    """``(table, new_fills, new_rank)`` of a compaction, on the host:
    ``table[old sharded id]`` is the row's new sharded id (0 for a dropped
    row), live slots sliding down within their shard; ``new_rank`` the
    dense logical rank of each new sharded id."""
    s_cnt, c = msst.shard_count, msst.capacity
    live = msst.fill_mask() & ~msst.tomb.cpu().numpy()
    rank = msst.rank.cpu().numpy()
    table = np.zeros(s_cnt * c, np.int64)
    fills = []
    for s in range(s_cnt):
        alive = np.nonzero(live[s * c:(s + 1) * c])[0] + s * c
        table[alive] = s * c + np.arange(len(alive))
        fills.append(len(alive))
    old = np.nonzero(live)[0]
    new_rank = np.zeros(s_cnt * c, np.int64)
    new_rank[table[old[np.argsort(rank[old], kind="stable")]]] = \
        np.arange(len(old))
    return table, tuple(fills), new_rank


def compact_tombstones_sharded(msst: MutableStateSharded
                               ) -> MutableStateSharded:
    """Physically remove the tombstoned rows, shard by shard (the
    refresh-boundary compaction): live slots slide down in slot order,
    neighbor ids remap through the old → new sharded-id table, the fills
    shrink, the rank table is renumbered densely, the bitmaps reset, the
    capacity stays. Needs a drained dirty bitmap."""
    if msst.dirty_count():
        raise ValueError("drain repairs before compacting")
    sst = msst.sstate
    c, home = msst.capacity, msst.home
    table, fills, new_rank = compact_tables(msst)
    with obslib.span("compact", cat="mutation",
                     args={"dropped": sst.total_valid - sum(fills)}):
        live = msst.fill_mask() & ~msst.tomb.cpu().numpy()
        reps, ratings, graphs, ranks = [], [], [], []
        for s, dev in enumerate(sst.devices):
            lo, hi = s * c, (s + 1) * c
            src = torch.as_tensor(np.nonzero(live[lo:hi])[0], device=dev)
            n = fills[s]

            def gather(x):
                out = torch.zeros_like(x)
                out[:n] = x[src]
                return out

            g = _full(sst.graph[s]).remap(torch.as_tensor(table,
                                                          device=dev))
            reps.append(gather(sst.representation[s]))
            ratings.append(gather(sst.ratings[s]))
            graphs.append(NeighborGraph(gather(g.indices),
                                        gather(g.weights)))
            ranks.append(torch.as_tensor(new_rank[lo:hi], device=dev).to(
                sst.row_rank[s].dtype))
        z = torch.zeros_like(msst.tomb)
        return MutableStateSharded(
            dataclasses.replace(sst, representation=reps, ratings=ratings,
                                graph=graphs, n_valid=fills, row_rank=ranks),
            msst.landmarks, z, z.clone(),
            torch.as_tensor(new_rank, device=home))


# -------------------------------------------------------------------- fold-in
def _regrow(msst: MutableStateSharded, sstate: ShardedLandmarkState
            ) -> MutableStateSharded:
    """Re-express the replicated tables after a per-shard regrow (each
    shard's slice padded with False / 0)."""
    s_cnt, old = msst.shard_count, msst.capacity
    new = sstate.capacity

    def grow(x):
        out = x.new_zeros((s_cnt, new))
        out[:, :old] = x.reshape(s_cnt, old)
        return out.reshape(-1)

    return MutableStateSharded(sstate, msst.landmarks, grow(msst.tomb),
                               grow(msst.dirty), grow(msst.rank))


def fold_in_rows_sharded(msst: MutableStateSharded, rows, bq: int,
                         spec: LandmarkSpec, min_bucket: int = 32,
                         growth: float = buckets.DEFAULT_GROWTH):
    """Append new users in ``bq``-row padded batches, each onto the
    least-loaded shard (``buckets.fold_in_rows_sharded``), through the
    frozen basis and on a copy of the state. The extend's masks are
    fill-based, so a tombstoned row can be picked as a new row's neighbor:
    after each batch one eviction pass on every shard removes those
    citations and marks the rows dirty, as ``mutate.fold_in_mutable`` does.
    Returns ``(msst, shards, slots)`` like the bucketed driver."""
    n = len(rows)
    sstate = msst.sstate.clone()
    msst = dataclasses.replace(msst, sstate=sstate)
    p = sstate.ratings[0].shape[1]
    rows = torch.as_tensor(rows, dtype=torch.float32)
    shards = np.zeros(n, np.int32)
    slots = np.zeros(n, np.int32)
    for lo in range(0, n, bq):
        chunk = rows[lo:lo + bq]
        m = chunk.shape[0]
        fills = sstate.n_valid
        target = int(np.argmin(fills))
        sstate, grew = buckets.ensure_capacity_sharded(
            sstate, target, bq, min_bucket, growth)
        if grew:
            msst = _regrow(msst, sstate)
        shards[lo:lo + m] = target
        slots[lo:lo + m] = fills[target] + np.arange(m)
        dev = sstate.devices[target]
        padded = torch.zeros((bq, p), dtype=torch.float32, device=dev)
        padded[:m] = chunk.to(dev)
        buckets.record_geometry("fold", sstate.capacity, bq)
        sstate = fold_in_sharded(sstate, padded, m, target, spec,
                                 landmarks=msst.landmarks)
        msst = _evict_tombstoned(dataclasses.replace(
            msst, sstate=sstate, rank=_rank_table(sstate)))
        sstate = msst.sstate
    return msst, shards, slots


def _evict_tombstoned(msst: MutableStateSharded) -> MutableStateSharded:
    sst = msst.sstate
    c = msst.capacity
    graphs, dirty = [], []
    for s, dev in enumerate(sst.devices):
        lo, hi = s * c, (s + 1) * c
        tomb_d = msst.tomb.to(dev)
        g, hit = evict_neighbors(_full(sst.graph[s]), tomb_d,
                                 row_rank=msst.rank.to(dev))
        row_valid = ((torch.arange(c, device=dev) < sst.n_valid[s])
                     & ~tomb_d[lo:hi])
        graphs.append(g)
        dirty.append(msst.dirty[lo:hi].to(dev) | (hit & row_valid))
    return dataclasses.replace(
        msst, sstate=dataclasses.replace(sst, graph=graphs),
        dirty=_blocks(dirty, msst.home))


# ------------------------------------------------------------------- serving
def predict_pairs(msst: MutableStateSharded, users: torch.Tensor,
                  items: torch.Tensor) -> torch.Tensor:
    """Pair predictions at sharded user ids, tombstoned neighbors masked."""
    sst = msst.sstate
    buckets.record_geometry("pair", sst.capacity, users.shape[0])
    return knn.predict_pairs_graph_sharded(
        sst.graph, sst.ratings, users, items, n_valid=sst.n_valid,
        shard_cap=sst.capacity, tomb=msst.tomb)


def recommend_topn(msst: MutableStateSharded, users: torch.Tensor,
                   n: int = 10):
    """Top-N at sharded user ids, tombstoned neighbors masked."""
    sst = msst.sstate
    buckets.record_geometry("topn", sst.capacity, users.shape[0])
    return knn.recommend_topn_graph_sharded(
        sst.graph, sst.ratings, users, n, n_valid=sst.n_valid,
        shard_cap=sst.capacity, tomb=msst.tomb)

