"""Continuous micro-batching request engine over the warm bucketed state.

The wave loops in ``launch/serve.py`` replay synchronous traffic: one batch
at a time, reads and fold-ins strictly interleaved. A server faces
concurrent pair/top-N/fold-in requests with tail-latency SLOs. This module
is that server core, host-side and testable without threads:

  queue      ``submit()`` admits a request into a bounded deadline heap;
             admission is by *rows* (a top-N request for 32 users costs 32
             rows of queue budget). Overflow sheds — the caller gets
             ``None`` back and the shed counter feeds ``shed_frac``.
  former     ``pump_reads()`` pops requests in deadline order, packs
             same-kind runs up to ``max_batch`` rows, pads to the next
             power-of-two batch shape, and runs ONE read call per batch.
             Shapes are drawn from ``EngineConfig.batch_shapes()``, so the
             geometries stay bounded at |shapes| x |buckets| per request
             kind — the geometries the lifecycle records.
  write lane writes — fold-ins and, on a mutable backend, in-place
             mutations (``"update"`` rating replacement, ``"remove"`` GDPR
             deletion, ``mutation``) — go to a separate queue drained by
             ``pump_folds()`` on its own cadence (its own thread in
             threaded mode). A write never runs on the read path; it
             builds the next-generation state off to the side (a mutation
             also drains its repairs first) and swaps it in with one atomic
             publish, so an in-flight read batch keeps the generation it
             started with.
  bit-identity
             per-row kNN math is row-independent: Eq. (1) sums over the
             fixed k axis in a fixed order (``core.knn``), never over the
             batch axis, so any packing/padding of admitted requests gives
             bitwise the same per-row results as running each request
             alone — ``verify_sample()`` re-checks exactly that against
             the live generation.

On the card the two lanes run on two CUDA streams of their own
(:class:`LocalBackend`): read batches on ``read_stream``, writes (the d1
and top-k scan kernels among them: fold-in scans and repair rescans) on
``fold_stream``, so a read batch never queues on the device behind a
write. A write is published only after its stream has finished.

Backends: :class:`LocalBackend` and :class:`MutableLocalBackend` on one
device; :class:`ShardedBackend` and :class:`MutableShardedBackend` on a
mesh (``launch.mesh``), whose reads go through the query router
(``serving.router``) and whose lanes have a stream pair on every shard
device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import obs as obslib
from ..core.types import NeighborGraph
from ..lifecycle import buckets
from ..obs.registry import Histogram
from .stats import histogram_latency

READ_KINDS = ("pair", "topn")
WRITE_KINDS = ("fold", "update", "remove")
MUTATION_KINDS = ("update", "remove")  # need a mutable backend


@dataclasses.dataclass
class Request:
    """One admitted request. ``done`` fires after its batch executes."""

    kind: str                       # "pair" | "topn" | "fold" | "update"
    #                                 | "remove"
    users: Optional[np.ndarray]     # logical user ids (reads + mutations)
    items: Optional[np.ndarray]     # item ids (pair reads only)
    rows: Optional[np.ndarray]      # dense rating rows (fold/update)
    deadline: float                 # absolute monotonic seconds
    t_submit: float
    seq: int
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    result: object = None           # (b,) preds | (items, scores) | gen
    generation: int = -1            # generation the request executed against
    t_done: float = 0.0
    t_pickup: float = 0.0           # batch-former pickup / write-lane drain
    sampled: bool = False           # selected by the trace sampler
    trace_id: int = 0               # root span id when sampled

    @property
    def n_rows(self) -> int:
        src = self.rows if self.kind == "fold" else self.users
        return int(len(src))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Queueing-model knobs. ``batch_shapes()`` is the geometry budget."""

    max_batch: int = 128            # rows per executed read batch
    min_shape: int = 8              # smallest padded batch shape
    queue_cap: int = 1024           # admission bound, in rows
    max_wait_ms: float = 2.0        # batch-fill wait (threaded mode)
    slo_ms: float = 50.0            # default per-request deadline
    fold_queue_cap: int = 64        # fold lane bound, in requests
    fold_bq: int = 32               # fold-in micro-batch quantum
    topn: int = 10

    def batch_shapes(self) -> Tuple[int, ...]:
        shapes = []
        s = max(1, self.min_shape)
        while s < self.max_batch:
            shapes.append(s)
            s *= 2
        shapes.append(self.max_batch)
        return tuple(shapes)

    def pad_shape(self, rows: int) -> int:
        for s in self.batch_shapes():
            if rows <= s:
                return s
        return self.max_batch


def _tensors(bst: buckets.BucketedState) -> Tuple[torch.Tensor, ...]:
    """Every tensor of a bucketed state (a fold writes ratings and
    representation in place and rebuilds the graph)."""
    st = bst.state
    return (st.landmark_idx, st.representation, st.ratings,
            st.graph.indices, st.graph.weights)


def _clone(bst: buckets.BucketedState) -> buckets.BucketedState:
    """A copy of every tensor of ``bst``: the fold lane folds into it, so
    the published generation is never written."""
    idx, rep, ratings, gi, gw = (t.clone() for t in _tensors(bst))
    st = dataclasses.replace(bst.state, landmark_idx=idx, representation=rep,
                             ratings=ratings, graph=NeighborGraph(gi, gw))
    return buckets.BucketedState(st, bst.n_valid)


def _on(stream: Optional[torch.cuda.Stream]):
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


class LocalBackend:
    """Single-device executor: logical user id == dense row index.

    Reads return host arrays: each output is one device-to-host copy, which
    ends when the read's device work has. On a CUDA state, reads run on
    ``read_stream`` and folds on ``fold_stream`` (CPU states: None, and
    everything runs in the calling thread's order). A fold clones the whole
    published state on the fold stream (after the read stream's queued work)
    and folds into the clone; the new generation is published only after
    ``fold_stream.synchronize()``, its tensors marked in use on the read
    stream (``record_stream``), so the allocator never hands their memory
    to the fold lane while a read may still use it.
    """

    serialize_folds = False  # one device, no collectives: true overlap

    def __init__(self, bst: buckets.BucketedState, spec, *,
                 min_bucket: int = 256, growth: float = 2.0,
                 warm_shapes: Tuple[int, ...] = (), warm_topn: int = 10):
        self.spec = spec
        self.min_bucket = min_bucket
        self.growth = growth
        self.warm_shapes = warm_shapes
        self.warm_topn = warm_topn
        self._pub = (bst, 0)        # (state, generation) — one atomic cell
        self.caps_used = {bst.capacity}  # the geometry budget's bucket axis
        self.device = bst.state.ratings.device
        self.read_stream = self.fold_stream = None
        if self.device.type == "cuda":
            here = torch.cuda.current_stream(self.device)
            self.read_stream = torch.cuda.Stream(self.device)
            self.fold_stream = torch.cuda.Stream(self.device)
            # both lanes start after the work that made the state
            self.read_stream.wait_stream(here)
            self.fold_stream.wait_stream(here)

    def _warm(self, pub) -> None:
        """Run the reads of a new bucket capacity BEFORE the publish, on the
        read stream: its geometries are recorded and the read stream's
        allocator pool grows here, on the fold lane, so the first live read
        at the new capacity does not pay for it."""
        for s in self.warm_shapes:
            z = np.zeros(s, np.int64)
            self.predict_pairs(pub, z, z)
            self.recommend_topn(pub, z, self.warm_topn)

    @property
    def generation(self) -> int:
        return self._pub[1]

    @property
    def n_users(self) -> int:
        return int(self._pub[0].n_valid)

    def snapshot(self):
        return self._pub

    def predict_pairs(self, pub, users: np.ndarray,
                      items: np.ndarray) -> np.ndarray:
        bst, _ = pub
        with _on(self.read_stream):
            out = buckets.predict_pairs(
                bst, torch.as_tensor(users, device=self.device),
                torch.as_tensor(items, device=self.device))
            return out.cpu().numpy()

    def recommend_topn(self, pub, users: np.ndarray, n: int):
        bst, _ = pub
        with _on(self.read_stream):
            ti, ts = buckets.recommend_topn(
                bst, torch.as_tensor(users, device=self.device), n=n)
            return ti.cpu().numpy(), ts.cpu().numpy()

    _state_tensors = staticmethod(_tensors)

    def _write(self, step: Callable) -> int:
        """Run ``step(published state) -> new state`` on the fold stream
        (after the read stream's queued work) and publish the result once
        the stream has finished; returns the new generation."""
        old, gen = self._pub
        with _on(self.fold_stream):
            if self.fold_stream is not None:
                self.fold_stream.wait_stream(self.read_stream)
                for t in self._state_tensors(old):
                    t.record_stream(self.fold_stream)
            new = step(old)
        if self.fold_stream is not None:
            self.fold_stream.synchronize()
            for t in self._state_tensors(new):
                t.record_stream(self.read_stream)
        if new.capacity not in self.caps_used:
            self._warm((new, gen + 1))
            self.caps_used.add(new.capacity)
        self._pub = (new, gen + 1)
        return gen + 1

    def fold_in(self, rows: np.ndarray, bq: int) -> int:
        return self._write(lambda bst: buckets.fold_in_rows(
            _clone(bst), rows, bq, self.spec, min_bucket=self.min_bucket,
            growth=self.growth))


def _mutation_shape(m: int, lo: int = 8) -> int:
    """Power-of-two mutation batch shapes (floor ``lo``): the write lane's
    geometries per capacity stay logarithmic in the largest batch."""
    s = max(1, lo)
    while s < m:
        s *= 2
    return s


class MutableLocalBackend(LocalBackend):
    """:class:`LocalBackend` with the write path open.

    The published cell holds a ``mutation.MutableState`` (frozen landmark
    basis + tombstone/dirty bitmaps). Reads thread the tombstone mask, so a
    deleted user is invisible the moment the removal publishes;
    ``"update"``/``"remove"`` requests ride the write lane, drain their
    repairs (the rescan: the fold-in scan kernel on the card) and publish
    the next generation exactly as a fold does — on the fold stream, into
    fresh tensors. ``refresh()`` is the swap boundary: it compacts the
    tombstones out and returns the old→new row-id table.
    """

    def __init__(self, bst: buckets.BucketedState, spec, *,
                 repair_bq: int = 64, **kw):
        from .. import mutation

        mst = mutation.from_bucketed(bst)  # before the lanes fork
        super().__init__(bst, spec, **kw)
        self._mut = mutation
        self.repair_bq = repair_bq
        self.repaired_rows = 0
        self._pub = (mst, 0)

    @staticmethod
    def _state_tensors(mst) -> Tuple[torch.Tensor, ...]:
        return _tensors(mst.bstate) + (mst.landmarks, mst.tomb, mst.dirty)

    @property
    def tombstone_frac(self) -> float:
        return self._pub[0].tombstone_frac()

    def tomb(self) -> np.ndarray:
        """Host view of the live generation's tombstone bitmap."""
        return self._pub[0].tomb.cpu().numpy()

    def predict_pairs(self, pub, users: np.ndarray,
                      items: np.ndarray) -> np.ndarray:
        mst, _ = pub
        with _on(self.read_stream):
            out = self._mut.predict_pairs(
                mst, torch.as_tensor(users, device=self.device),
                torch.as_tensor(items, device=self.device))
            return out.cpu().numpy()

    def recommend_topn(self, pub, users: np.ndarray, n: int):
        mst, _ = pub
        with _on(self.read_stream):
            ti, ts = self._mut.recommend_topn(
                mst, torch.as_tensor(users, device=self.device), n=n)
            return ti.cpu().numpy(), ts.cpu().numpy()

    def fold_in(self, rows: np.ndarray, bq: int) -> int:
        return self._write(lambda mst: self._mut.fold_in_rows(
            mst, rows, bq, self.spec, min_bucket=self.min_bucket,
            growth=self.growth))

    def _drained(self, mst):
        self.repaired_rows += mst.dirty_count()
        return self._mut.drain_repairs(mst, self.spec, self.repair_bq)

    def _padded(self, ids: np.ndarray, rows: Optional[np.ndarray]):
        """(ids, rows, m): a batch padded to its mutation shape (filler id
        -1, zero rows)."""
        m = len(ids)
        shape = _mutation_shape(m)
        pid = np.full(shape, -1, np.int64)
        pid[:m] = ids
        if rows is None:
            return pid, None, m
        prows = np.zeros((shape, rows.shape[1]), np.float32)
        prows[:m] = rows
        return pid, prows, m

    def apply_update(self, ids: np.ndarray, rows: np.ndarray) -> int:
        pid, prows, m = self._padded(np.asarray(ids), np.asarray(rows))
        return self._write(lambda mst: self._drained(
            self._mut.update_ratings(mst, pid, prows, m, self.spec)))

    def apply_remove(self, ids: np.ndarray) -> int:
        pid, _, m = self._padded(np.asarray(ids), None)
        return self._write(lambda mst: self._drained(
            self._mut.remove_users(mst, pid, m)))

    def refresh(self) -> Tuple[int, np.ndarray]:
        """Refresh-boundary compaction: drain outstanding repairs, slide the
        tombstoned rows out, publish. Returns ``(generation, table)``, where
        ``table[old_id]`` is the surviving row's new id or -1: the caller
        remaps its id universe once per swap."""
        table = None

        def step(mst):
            nonlocal table
            mst = self._mut.drain_repairs(mst, self.spec, self.repair_bq)
            tomb = mst.tomb.cpu().numpy()
            live = ~tomb[:mst.n_valid]
            table = np.full(len(tomb), -1, np.int64)
            table[:mst.n_valid][live] = np.arange(int(live.sum()))
            return self._mut.compact_tombstones(mst)

        return self._write(step), table


def _devices(sstate) -> Tuple[torch.device, ...]:
    """The distinct CUDA devices of a sharded state's blocks."""
    return tuple(dict.fromkeys(d for d in sstate.devices
                               if d.type == "cuda"))


def _sharded_tensors(sst) -> Tuple[torch.Tensor, ...]:
    """Every tensor of a ``ShardedLandmarkState``."""
    out = [sst.landmark_idx]
    for blocks in (sst.representation, sst.ratings, sst.row_rank):
        out.extend(blocks)
    for g in sst.graph:
        out.extend((g.indices, g.weights))
    return tuple(out)


class ShardedBackend:
    """Mesh executor: reads go through the query router
    (``serving.router``), folds through ``buckets.fold_in_rows_sharded`` on
    a copy of the published state. A request names users by logical id;
    the published cell ``(state, id_shard, id_slot, generation)`` carries
    the logical id → (shard, slot) tables that translate them to sharded
    row ids (``shard * capacity + slot``) at execution time, so a capacity
    regrow between two publishes never mixes old ids with a new layout.
    The tables grow with every fold.

    Streams: the lanes need a read stream and a write stream on every
    device that holds a shard (:class:`LocalBackend` keeps one pair on its
    one device). A mesh on one card has one pair; round-robin over several
    cards, one pair a card. A write runs on the write streams after the
    read streams' queued work and is published once all of them have
    finished, its tensors marked in use on the read streams.

    ``serialize_folds`` is False: the port's mesh is one process with
    explicit collectives and no rendezvous, and a write builds its
    generation in fresh tensors, so folds overlap reads as on one device
    (``RequestEngine.verify_sample`` re-checks that reads stay bitwise the
    reads alone). The reference serializes them to avoid a JAX host-mesh
    deadlock the port cannot have.
    """

    serialize_folds = False

    def __init__(self, sstate, id_shard: np.ndarray, id_slot: np.ndarray,
                 spec, *, min_bucket: int = 32, growth: float = 2.0,
                 warm_shapes: Tuple[int, ...] = (), warm_topn: int = 10):
        self.spec = spec
        self.min_bucket = min_bucket
        self.growth = growth
        self.warm_shapes = warm_shapes
        self.warm_topn = warm_topn
        self._pub = self._cell(sstate, id_shard, id_slot)
        self.caps_used = {sstate.capacity}
        self.device = sstate.devices[0]  # where the routed reads gather
        self.read_streams, self.fold_streams = {}, {}
        for dev in _devices(sstate):
            here = torch.cuda.current_stream(dev)
            for lane in (self.read_streams, self.fold_streams):
                lane[dev] = torch.cuda.Stream(dev)
                lane[dev].wait_stream(here)

    @staticmethod
    def _cell(state, id_shard, id_slot):
        return (state, np.asarray(id_shard, np.int64),
                np.asarray(id_slot, np.int64), 0)

    @staticmethod
    def _on_all(streams: dict):
        stack = contextlib.ExitStack()
        for st in streams.values():
            stack.enter_context(torch.cuda.stream(st))
        return stack

    def _warm(self, pub) -> None:
        """Run the reads of a new shard capacity before the publish, on the
        read streams (the geometries recorded, the pools grown)."""
        for s in self.warm_shapes:
            z = np.zeros(s, np.int64)
            self.predict_pairs(pub, z, z)
            self.recommend_topn(pub, z, self.warm_topn)

    @property
    def generation(self) -> int:
        return self._pub[3]

    @property
    def n_users(self) -> int:
        return len(self._pub[1])

    def snapshot(self):
        return self._pub

    @staticmethod
    def sharded_state(state):
        """The ``ShardedLandmarkState`` of a published state."""
        return state

    def sharded_ids(self, pub, users: np.ndarray) -> torch.Tensor:
        """Logical ids -> sharded row ids against ``pub``'s tables."""
        state, id_shard, id_slot, _ = pub
        users = np.asarray(users, np.int64)
        cap = self.sharded_state(state).capacity
        return torch.as_tensor(id_shard[users] * cap + id_slot[users],
                               device=self.device)

    @staticmethod
    def read_tomb(state):
        """The tombstone bitmap a read of ``state`` passes the router."""
        return None

    def predict_pairs(self, pub, users: np.ndarray,
                      items: np.ndarray) -> np.ndarray:
        from .router import predict_pairs_routed

        state = pub[0]
        with self._on_all(self.read_streams):
            out = predict_pairs_routed(
                self.sharded_state(state), self.sharded_ids(pub, users),
                torch.as_tensor(items, device=self.device),
                tomb=self.read_tomb(state))
            return out.cpu().numpy()

    def recommend_topn(self, pub, users: np.ndarray, n: int):
        from .router import recommend_topn_routed

        state = pub[0]
        with self._on_all(self.read_streams):
            ti, ts = recommend_topn_routed(
                self.sharded_state(state), self.sharded_ids(pub, users), n,
                tomb=self.read_tomb(state))
            return ti.cpu().numpy(), ts.cpu().numpy()

    @staticmethod
    def _state_tensors(state) -> Tuple[torch.Tensor, ...]:
        return _sharded_tensors(state)

    def _record(self, state, lane: dict) -> None:
        for t in self._state_tensors(state):
            if t.device in lane:
                t.record_stream(lane[t.device])

    def _write(self, step: Callable) -> int:
        """Run ``step(published cell) -> (state, id_shard, id_slot)`` on the
        write streams (after the read streams' queued work) and publish the
        result once they have finished; returns the new generation."""
        old = self._pub
        gen = old[3]
        with self._on_all(self.fold_streams):
            for dev, st in self.fold_streams.items():
                st.wait_stream(self.read_streams[dev])
            self._record(old[0], self.fold_streams)
            state, id_shard, id_slot = step(old)
        for st in self.fold_streams.values():
            st.synchronize()
        self._record(state, self.read_streams)
        pub = (state, id_shard, id_slot, gen + 1)
        cap = self.sharded_state(state).capacity
        if cap not in self.caps_used:
            self._warm(pub)
            self.caps_used.add(cap)
        self._pub = pub
        return gen + 1

    def fold_in(self, rows: np.ndarray, bq: int) -> int:
        def step(pub):
            sstate, id_shard, id_slot, _ = pub
            new, shards, slots = buckets.fold_in_rows_sharded(
                sstate.clone(), rows, bq, self.spec,
                min_bucket=self.min_bucket, growth=self.growth)
            return (new, np.concatenate([id_shard, shards]),
                    np.concatenate([id_slot, slots]))

        return self._write(step)


class MutableShardedBackend(ShardedBackend):
    """:class:`ShardedBackend` with the write path open: the published
    cell holds a ``mutation.MutableStateSharded``. Reads pass its
    replicated tombstone bitmap to the router; ``"update"``/``"remove"``
    requests translate their logical ids to sharded ids against the
    published tables, pad to the write lane's shapes, apply on the owner
    shards (``mutation.sharded``), drain their repairs and publish on the
    write streams, as a fold does. ``refresh()`` compacts every shard (rows
    never change owner) and renumbers the logical id -> (shard, slot)
    tables in place; logical ids stay what they were.
    """

    def __init__(self, sstate, id_shard: np.ndarray, id_slot: np.ndarray,
                 spec, *, repair_bq: int = 64, **kw):
        from .. import mutation

        msst = mutation.from_sharded(sstate)  # before the lanes fork
        super().__init__(sstate, id_shard, id_slot, spec, **kw)
        self._mut = mutation
        self.repair_bq = repair_bq
        self.repaired_rows = 0
        self._pub = self._cell(msst, id_shard, id_slot)

    @staticmethod
    def sharded_state(state):
        return state.sstate

    @staticmethod
    def read_tomb(state):
        return state.tomb

    @staticmethod
    def _state_tensors(msst) -> Tuple[torch.Tensor, ...]:
        return _sharded_tensors(msst.sstate) + (msst.landmarks, msst.tomb,
                                                msst.dirty, msst.rank)

    @property
    def tombstone_frac(self) -> float:
        return self._pub[0].tombstone_frac()

    def tomb(self) -> np.ndarray:
        """Host view of the live generation's tombstone bitmap, indexed by
        logical id."""
        msst, id_shard, id_slot, _ = self._pub
        return msst.tomb.cpu().numpy()[id_shard * msst.capacity + id_slot]

    def fold_in(self, rows: np.ndarray, bq: int) -> int:
        def step(pub):
            msst, id_shard, id_slot, _ = pub
            new, shards, slots = self._mut.fold_in_rows_sharded(
                msst, rows, bq, self.spec, min_bucket=self.min_bucket,
                growth=self.growth)
            return (new, np.concatenate([id_shard, shards]),
                    np.concatenate([id_slot, slots]))

        return self._write(step)

    def _drained(self, msst):
        self.repaired_rows += msst.dirty_count()
        return self._mut.drain_repairs_sharded(msst, self.spec,
                                               self.repair_bq)

    def _batch(self, pub, ids: np.ndarray, rows: Optional[np.ndarray]):
        """(sharded ids, rows, m): a batch padded to its mutation shape
        (filler id -1, zero rows)."""
        m = len(ids)
        shape = _mutation_shape(m)
        pid = np.full(shape, -1, np.int64)
        pid[:m] = self.sharded_ids(pub, ids).cpu().numpy()
        if rows is None:
            return pid, None, m
        prows = np.zeros((shape, rows.shape[1]), np.float32)
        prows[:m] = rows
        return pid, prows, m

    def apply_update(self, ids: np.ndarray, rows: np.ndarray) -> int:
        def step(pub):
            pid, prows, m = self._batch(pub, np.asarray(ids),
                                        np.asarray(rows))
            return (self._drained(self._mut.update_ratings_sharded(
                pub[0], pid, prows, m, self.spec)), pub[1], pub[2])

        return self._write(step)

    def apply_remove(self, ids: np.ndarray) -> int:
        def step(pub):
            pid, _, m = self._batch(pub, np.asarray(ids), None)
            return (self._drained(self._mut.remove_users_sharded(
                pub[0], pid, m)), pub[1], pub[2])

        return self._write(step)

    def refresh(self) -> Tuple[int, np.ndarray]:
        """Refresh-boundary compaction on every shard: drain outstanding
        repairs, slide the tombstoned rows out, renumber the tables,
        publish. Returns ``(generation, table)`` over logical ids:
        ``table[id]`` is ``id`` for a surviving row and -1 for a removed
        one (whose table entries now point at slot 0 of shard 0)."""
        table = None

        def step(pub):
            nonlocal table
            msst, id_shard, id_slot, _ = pub
            msst = self._mut.drain_repairs_sharded(msst, self.spec,
                                                   self.repair_bq)
            c = msst.capacity
            moved, _, _ = self._mut.sharded.compact_tables(msst)
            sid = id_shard * c + id_slot
            dead = msst.tomb.cpu().numpy()[sid]
            table = np.where(dead, -1, np.arange(len(sid), dtype=np.int64))
            return (self._mut.compact_tombstones_sharded(msst),
                    np.where(dead, 0, id_shard),
                    np.where(dead, 0, moved[sid] % c))

        return self._write(step), table


class RequestEngine:
    """Deadline-heap admission + continuous micro-batching + async folds.

    The core is synchronous and single-threaded-testable: ``submit()`` then
    ``pump_reads()`` / ``pump_folds()``. ``start()`` wraps the two pumps in
    their own threads for open-loop load generation; folds then drain on a
    cadence that never touches the read thread.

    ``exec_lock`` serializes device-program *launches*. Read batches always
    hold it (uncontended on the happy path — microseconds). Folds take it
    only when the backend sets ``serialize_folds`` (a backend whose fold
    and read programs must not run at once). Sidecar device work that runs
    beside a live engine (e.g. retrieval health probes) holds the same
    lock.
    """

    def __init__(self, backend, config: EngineConfig = EngineConfig(),
                 clock: Callable[[], float] = time.monotonic,
                 obs: Optional["obslib.Observability"] = None):
        self.backend = backend
        self.config = config
        self.clock = clock
        # obs is optional; the tracer reference is always valid (the
        # DISABLED singleton's inert tracer when off) so hot-path guards
        # are a single ``.active`` attribute read
        self.obs = obs
        self._tracer = obs.tracer if obs is not None else obslib.DISABLED.tracer
        self.exec_lock = threading.Lock()
        self._lock = threading.Lock()
        self._read_cond = threading.Condition(self._lock)
        self._fold_cond = threading.Condition(self._lock)
        self._heap: List[Tuple[float, int, Request]] = []
        self._folds: List[Request] = []
        self._queued_rows = 0
        self._seq = 0
        self._threads: List[threading.Thread] = []
        self._running = False
        # each lane thread's ids (``start``): its ``threading`` ident (the
        # pthread handle) and its OS thread id — a device trace names the
        # thread that launched each kernel by one of them
        self.lane_ids: dict = {}
        # stats
        self.submitted = {k: 0 for k in READ_KINDS + WRITE_KINDS}
        self.shed = {k: 0 for k in READ_KINDS + WRITE_KINDS}
        self.completed = {k: 0 for k in READ_KINDS + WRITE_KINDS}
        # bounded log-bucketed histograms (ms) — fixed memory regardless of
        # how long the server runs, quantiles within one bucket width
        self.latencies = {k: Histogram() for k in READ_KINDS + WRITE_KINDS}
        self.launches: dict = {}        # (kind, pad_shape) -> launch count
        self.batches = 0
        self.exec_rows = 0
        self.pad_rows = 0
        self.nonfinite = 0
        self.folded_rows = 0
        self.mutated_rows = 0
        self._verify_ring: List[Tuple[Request, object]] = []
        self._verify_cap = 64

    # ------------------------------------------------------------- admission
    def submit(self, kind: str, *, users=None, items=None, rows=None,
               deadline_ms: Optional[float] = None) -> Optional[Request]:
        """Admit one request; returns it, or ``None`` when shed."""
        now = self.clock()
        slo = self.config.slo_ms if deadline_ms is None else deadline_ms
        if kind in READ_KINDS:
            users = np.asarray(users, np.int64)
            if kind == "pair":
                items = np.asarray(items, np.int64)
            req = Request(kind, users, items, None, now + slo / 1e3, now, 0)
            if req.n_rows > self.config.max_batch:
                raise ValueError(
                    f"request of {req.n_rows} rows exceeds max_batch="
                    f"{self.config.max_batch}; split it client-side")
            with self._lock:
                if self._queued_rows + req.n_rows > self.config.queue_cap:
                    self.shed[kind] += 1
                    return None
                req.seq = self._seq = self._seq + 1
                self._queued_rows += req.n_rows
                self.submitted[kind] += 1
                heapq.heappush(self._heap, (req.deadline, req.seq, req))
                self._read_cond.notify()
            tr = self._tracer
            if tr.active and tr.should_sample():
                req.sampled = True
                req.trace_id = tr.new_id()
            return req
        if kind in WRITE_KINDS:
            if kind in MUTATION_KINDS and not hasattr(self.backend,
                                                      "apply_update"):
                raise ValueError(
                    f"kind {kind!r} needs a mutable backend "
                    "(MutableLocalBackend / MutableShardedBackend)")
            if kind == "fold":
                req = Request(kind, None, None, np.asarray(rows),
                              now + slo / 1e3, now, 0)
            elif kind == "update":
                req = Request(kind, np.asarray(users, np.int64), None,
                              np.asarray(rows), now + slo / 1e3, now, 0)
            else:  # remove
                req = Request(kind, np.asarray(users, np.int64), None, None,
                              now + slo / 1e3, now, 0)
            with self._lock:
                if len(self._folds) >= self.config.fold_queue_cap:
                    self.shed[kind] += 1
                    return None
                req.seq = self._seq = self._seq + 1
                self.submitted[kind] += 1
                self._folds.append(req)
                self._fold_cond.notify()
            tr = self._tracer
            if tr.active and tr.should_sample():
                req.sampled = True
                req.trace_id = tr.new_id()
            return req
        raise ValueError(f"unknown request kind {kind!r}")

    # ---------------------------------------------------------- batch former
    def _form_batch(self) -> List[Request]:
        """Take the earliest-deadline request's kind, then fill with that
        kind's requests in deadline order up to ``max_batch`` rows, skipping
        over other-kind entries (they keep their heap position and form the
        next batch — per-kind deadline order is preserved, and the other
        kind cannot starve because its earliest deadline picks the next
        batch's kind). Caller holds the lock."""
        if not self._heap:
            return []
        kind = self._heap[0][2].kind
        batch, deferred, rows = [], [], 0
        while self._heap:
            entry = heapq.heappop(self._heap)
            nxt = entry[2]
            if nxt.kind != kind:
                deferred.append(entry)
                continue
            if batch and rows + nxt.n_rows > self.config.max_batch:
                deferred.append(entry)
                break
            self._queued_rows -= nxt.n_rows
            batch.append(nxt)
            rows += nxt.n_rows
        for entry in deferred:
            heapq.heappush(self._heap, entry)
        return batch

    def _execute(self, batch: List[Request]) -> None:
        kind = batch[0].kind
        rows = sum(r.n_rows for r in batch)
        shape = self.config.pad_shape(rows)
        users = np.zeros(shape, np.int64)
        items = np.zeros(shape, np.int64)
        off = 0
        for r in batch:
            users[off:off + r.n_rows] = r.users
            if kind == "pair":
                items[off:off + r.n_rows] = r.items
            off += r.n_rows
        tr = self._tracer
        t_ready = self.clock() if tr.active else 0.0
        with self.exec_lock:
            t_launch = self.clock() if tr.active else 0.0
            pub = self.backend.snapshot()
            if kind == "pair":
                out = self.backend.predict_pairs(pub, users, items)
                self.nonfinite += int((~np.isfinite(out[:rows])).sum())
            else:
                out = self.backend.recommend_topn(pub, users,
                                                  self.config.topn)
        now = self.clock()
        gen = pub[-1]   # the backend publishes (..., generation)
        off = 0
        for r in batch:
            if kind == "pair":
                r.result = out[off:off + r.n_rows]
            else:
                r.result = (out[0][off:off + r.n_rows],
                            out[1][off:off + r.n_rows])
            off += r.n_rows
            r.generation = gen
            r.t_done = now
            self.completed[kind] += 1
            self.latencies[kind].record((now - r.t_submit) * 1e3)
            r.done.set()
            if len(self._verify_ring) < self._verify_cap:
                self._verify_ring.append((r, r.result))
        self.batches += 1
        self.exec_rows += rows
        self.pad_rows += shape - rows
        key = (kind, shape)
        self.launches[key] = self.launches.get(key, 0) + 1
        if tr.active:
            bid = batch[0].seq
            evs = []
            if t_launch > t_ready:
                evs.append({"name": "exec_wait", "cat": "engine",
                            "t0": t_ready, "t1": t_launch,
                            "args": {"kind": kind}})
            evs.append({"name": f"execute[{kind}]", "cat": "engine",
                        "t0": t_launch, "t1": now,
                        "args": {"rows": rows, "shape": shape, "gen": gen,
                                 "batch": bid}})
            tr.complete_many(evs)
            recs = [(kind, r.t_submit, r.t_pickup, now, r.trace_id,
                     r.n_rows, gen, bid) for r in batch if r.sampled]
            if recs:
                tr.complete_requests(recs, child="exec")

    def pump_reads(self, max_batches: Optional[int] = None) -> int:
        """Drain queued reads now; returns the number of batches executed."""
        n = 0
        while max_batches is None or n < max_batches:
            with self._lock:
                batch = self._form_batch()
            if not batch:
                break
            tp = self.clock()
            for r in batch:
                r.t_pickup = tp
            self._execute(batch)
            n += 1
        return n

    # ------------------------------------------------------------ write lane
    def _apply_write(self, req: Request) -> int:
        if req.kind == "fold":
            return self.backend.fold_in(req.rows, self.config.fold_bq)
        if req.kind == "update":
            return self.backend.apply_update(req.users, req.rows)
        return self.backend.apply_remove(req.users)

    def pump_folds(self, max_folds: Optional[int] = None) -> int:
        """Drain queued writes — fold-ins, updates, removals — now (never
        called from the read path)."""
        n = 0
        tr = self._tracer
        while max_folds is None or n < max_folds:
            with self._lock:
                if not self._folds:
                    break
                req = self._folds.pop(0)
            t_pickup = self.clock() if tr.active else 0.0
            req.t_pickup = t_pickup
            if getattr(self.backend, "serialize_folds", False):
                with self.exec_lock:
                    t_apply = self.clock() if tr.active else t_pickup
                    gen = self._apply_write(req)
            else:
                t_apply = t_pickup
                gen = self._apply_write(req)
            now = self.clock()
            req.result = gen
            req.generation = gen
            req.t_done = now
            with self._lock:
                self.completed[req.kind] += 1
                self.latencies[req.kind].record((now - req.t_submit) * 1e3)
                if req.kind == "fold":
                    self.folded_rows += len(req.rows)
                else:
                    self.mutated_rows += len(req.users)
                self._verify_ring.clear()   # prior generation retired
            req.done.set()
            if tr.active:
                if t_apply > t_pickup:
                    tr.complete("exec_wait", "engine", t_pickup, t_apply,
                                args={"kind": req.kind})
                tr.complete(f"apply[{req.kind}]", "write", t_apply, now,
                            args={"rows": req.n_rows, "gen": gen})
                if req.sampled:
                    tr.complete_requests(
                        [(req.kind, req.t_submit, t_pickup, now,
                          req.trace_id, req.n_rows, gen, None)],
                        child="apply")
            n += 1
        return n

    # -------------------------------------------------------------- threaded
    def start(self) -> None:
        self._running = True

        def read_loop():
            while True:
                with self._lock:
                    while self._running and not self._heap:
                        self._read_cond.wait(timeout=0.05)
                    if not self._running and not self._heap:
                        return
                    first = self._heap[0][2] if self._heap else None
                # brief fill wait: let the batch accumulate, bounded by
                # max_wait and by the earliest deadline
                if first is not None:
                    wait = min(self.config.max_wait_ms / 1e3,
                               max(0.0, first.deadline - self.clock()))
                    deadline = self.clock() + wait
                    while (self.clock() < deadline
                           and self._queued_rows < self.config.max_batch):
                        time.sleep(0.0005)
                self.pump_reads(max_batches=1)

        def fold_loop():
            while True:
                with self._lock:
                    while self._running and not self._folds:
                        self._fold_cond.wait(timeout=0.05)
                    if not self._running and not self._folds:
                        return
                self.pump_folds(max_folds=1)

        for fn, name in ((read_loop, "engine-reads"),
                         (fold_loop, "engine-folds")):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)
            self.lane_ids[name] = {"ident": t.ident,
                                   "native_id": t.native_id}

    def stop(self) -> None:
        with self._lock:
            self._running = False
            self._read_cond.notify_all()
            self._fold_cond.notify_all()
        for t in self._threads:
            t.join(timeout=30.0)
        self._threads = []

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        offered = sum(self.submitted.values()) + sum(self.shed.values())
        reads = sum(self.completed[k] for k in READ_KINDS)
        read_h = Histogram()
        for k in READ_KINDS:
            read_h.merge(self.latencies[k])
        with self._lock:
            queue_rows = self._queued_rows
            write_queue = len(self._folds)
        return {
            "offered": offered,
            "submitted": dict(self.submitted),
            "completed": dict(self.completed),
            "shed": dict(self.shed),
            "shed_frac": (sum(self.shed.values()) / offered
                          if offered else 0.0),
            # per-kind shed fractions: write-lane pressure is visible
            # separately from read pressure instead of one aggregate
            "shed_frac_by_kind": {
                k: (self.shed[k] / (self.submitted[k] + self.shed[k])
                    if self.submitted[k] + self.shed[k] else 0.0)
                for k in READ_KINDS + WRITE_KINDS},
            "queue_rows": queue_rows,
            "write_queue": write_queue,
            "read_latency": histogram_latency(read_h),
            "fold_latency": histogram_latency(self.latencies["fold"]),
            "batches": self.batches,
            "mean_batch_rows": (self.exec_rows / self.batches
                                if self.batches else 0.0),
            "pad_frac": (self.pad_rows /
                         max(1, self.pad_rows + self.exec_rows)),
            "nonfinite": self.nonfinite,
            "folded_rows": self.folded_rows,
            "mutated_rows": self.mutated_rows,
            "tombstone_frac": getattr(self.backend, "tombstone_frac", 0.0),
            "repaired_rows": getattr(self.backend, "repaired_rows", 0),
            "generation": self.backend.generation,
            "reads_completed": reads,
        }

    def publish_metrics(self) -> None:
        """Copy the engine's hot-path stats into the obs registry — called
        at snapshot points (periodic, end-of-run), never per request, so
        the registry adds zero cost to the serve path. Idempotent: counters
        and histograms are published as absolute copies (``set`` /
        ``publish_histogram``), never re-accumulated."""
        o = self.obs
        if o is None or not o.enabled:
            return
        reg = o.registry
        for k in READ_KINDS + WRITE_KINDS:
            reg.counter(f"engine.submitted.{k}").set(self.submitted[k])
            reg.counter(f"engine.shed.{k}").set(self.shed[k])
            reg.counter(f"engine.completed.{k}").set(self.completed[k])
            reg.publish_histogram(f"engine.latency_ms.{k}",
                                  self.latencies[k])
        for (kind, shape), c in list(self.launches.items()):
            reg.counter(f"exec.engine.{kind}.b{shape}.launches").set(c)
        reg.counter("engine.batches").set(self.batches)
        reg.counter("engine.exec_rows").set(self.exec_rows)
        reg.counter("engine.pad_rows").set(self.pad_rows)
        reg.counter("engine.nonfinite").set(self.nonfinite)
        reg.counter("engine.folded_rows").set(self.folded_rows)
        reg.counter("engine.mutated_rows").set(self.mutated_rows)
        reg.counter("engine.repaired_rows").set(
            getattr(self.backend, "repaired_rows", 0))
        with self._lock:
            queue_rows = self._queued_rows
            write_queue = len(self._folds)
        reg.gauge("engine.queue_rows").set(float(queue_rows))
        reg.gauge("engine.write_queue").set(float(write_queue))
        reg.gauge("engine.row_occupancy").set(
            self.exec_rows / max(1, self.exec_rows + self.pad_rows))
        reg.gauge("engine.generation").set(float(self.backend.generation))
        reg.gauge("engine.tombstone_frac").set(
            float(getattr(self.backend, "tombstone_frac", 0.0)))

    def verify_sample(self, limit: int = 16) -> Tuple[int, int]:
        """Re-run up to ``limit`` recent completed reads SOLO against their
        generation and count bitwise mismatches. Only requests still on the
        live generation are checked (writes clear the ring; a read batch
        that began before a write may still land in it afterwards), so the
        comparison is exact.
        """
        pub = self.backend.snapshot()
        gen = pub[-1]
        checked = bad = 0
        with self._lock:  # a batch that began before a write lands stale
            ring = [(req, got) for req, got in self._verify_ring
                    if req.generation == gen][:limit]
        for req, got in ring:
            checked += 1
            shape = self.config.pad_shape(req.n_rows)
            users = np.zeros(shape, np.int64)
            users[:req.n_rows] = req.users
            if req.kind == "pair":
                items = np.zeros(shape, np.int64)
                items[:req.n_rows] = req.items
                ref = self.backend.predict_pairs(pub, users,
                                                 items)[:req.n_rows]
                ok = np.array_equal(ref, got)
            else:
                ti, ts = self.backend.recommend_topn(pub, users,
                                                     self.config.topn)
                ok = (np.array_equal(ti[:req.n_rows], got[0])
                      and np.array_equal(ts[:req.n_rows], got[1]))
            bad += 0 if ok else 1
        return checked, bad
