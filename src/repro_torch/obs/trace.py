"""Structured request tracing — span records + Chrome trace-event export.

A *span* is one completed interval: name, category, [t0, t1) in monotonic
seconds, the recording thread, an optional span id, an optional parent id,
and a small args dict. The engine emits:

  cat="request"  per *sampled* request: a root ``serve[kind]`` span
                 (submit → completion) with two children, ``queued``
                 (submit → batch-former pickup) and ``exec``/``apply``
                 (pickup → completion). Parent linkage rides in
                 ``args["parent"]`` — Chrome's flame view nests by
                 thread/time, the invariant tests check the ids.
  cat="engine"   per executed batch (regardless of sampling): an
                 ``execute[kind]`` span on the read thread and an
                 ``exec_wait`` span when the launch had to wait on
                 ``exec_lock`` — the contention the sharded backend's
                 serialized folds create is directly visible.
  cat="write"    per drained write: ``apply[fold|update|remove]``
                 including the atomic generation publish at its tail.
  cat="lifecycle"/"mutation"
                 background refresh fit/commit, repair drains, compaction.

Sampling is a deterministic 64-bit LCG (same seed + rate ⇒ same accept
sequence — replayable traces, testable sampler). The event buffer is
bounded: past ``max_events`` entries new spans are counted as ``dropped``
instead of growing memory (a compact request record occupies one buffer
slot and expands to its three spans at export).

``export()`` writes the Chrome trace-event JSON format (one object,
``traceEvents`` list of ``ph:"X"`` complete events with µs timestamps
relative to the earliest span, plus ``ph:"M"`` thread-name metadata) —
load it in ``chrome://tracing`` or Perfetto. Read/fold overlap shows as
``execute[pair]`` spans on the ``engine-reads`` track running *during* an
``apply[fold]`` span on the ``engine-folds`` track.
"""
from __future__ import annotations

import itertools
import json
import threading
from typing import Dict, List, Optional

_LCG_MUL = 6364136223846793005
_LCG_ADD = 1442695040888963407
_MASK64 = (1 << 64) - 1


class Sampler:
    """Deterministic LCG coin: ``sample()`` advances the state and accepts
    with probability ``rate``. Not cryptographic — replayable."""

    __slots__ = ("rate", "_state")

    def __init__(self, rate: float, seed: int = 0) -> None:
        self.rate = float(rate)
        self._state = ((seed * _LCG_MUL) + _LCG_ADD) & _MASK64

    def sample(self) -> bool:
        if self.rate >= 1.0:
            return True
        if self.rate <= 0.0:
            return False
        self._state = (self._state * _LCG_MUL + _LCG_ADD) & _MASK64
        # top 53 bits → uniform in [0, 1)
        return (self._state >> 11) / float(1 << 53) < self.rate


class Tracer:
    """Bounded span recorder. ``active=False`` is the no-op configuration:
    every producer guards on ``tracer.active`` before touching the tracer,
    so a disabled tracer costs one attribute read per call site."""

    def __init__(self, *, sample_rate: float = 1.0, seed: int = 0,
                 max_events: int = 200_000, active: bool = True) -> None:
        self.active = active
        self.dropped = 0
        self._sampler = Sampler(sample_rate, seed)
        self._events: List[dict] = []
        self._max_events = max_events
        self._thread_names: Dict[int, str] = {}
        # C-level iterator: next() is atomic under the GIL, so id minting
        # never contends with the recording lock — submit threads must not
        # serialize against the engine thread's complete_many()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    # ------------------------------------------------------------ sampling
    def should_sample(self) -> bool:
        # rate 0/1 needs no state advance — skip the lock on the hot path
        rate = self._sampler.rate
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        with self._lock:
            return self._sampler.sample()

    def new_id(self) -> int:
        return next(self._ids)

    # ----------------------------------------------------------- recording
    def complete(self, name: str, cat: str, t0: float, t1: float, *,
                 tid: Optional[int] = None, span_id: Optional[int] = None,
                 parent: Optional[int] = None,
                 args: Optional[dict] = None) -> None:
        """Record one finished span (monotonic seconds)."""
        th = threading.current_thread()
        ev = {"name": name, "cat": cat, "t0": float(t0), "t1": float(t1),
              "tid": th.ident if tid is None else tid}
        if span_id is not None:
            ev["id"] = span_id
        if parent is not None:
            ev["parent"] = parent
        if args:
            ev["args"] = args
        with self._lock:
            if len(self._events) >= self._max_events:
                self.dropped += 1
                return
            self._events.append(ev)
            if ev["tid"] not in self._thread_names:
                self._thread_names[ev["tid"]] = (
                    th.name if tid is None else f"tid-{tid}")

    def complete_many(self, evs: List[dict]) -> None:
        """Record a batch of finished spans under ONE lock acquisition.

        The hot path builds its event dicts locally (no contention) and
        hands them over in a single call — per-event locking is what the
        obs_overhead bench would pay for. Each dict needs
        ``name``/``cat``/``t0``/``t1``; ``tid`` defaults to the calling
        thread, ``id``/``parent``/``args`` ride along when present."""
        th = threading.current_thread()
        for ev in evs:
            ev.setdefault("tid", th.ident)
        with self._lock:
            room = self._max_events - len(self._events)
            if room < len(evs):
                self.dropped += len(evs) - max(room, 0)
                evs = evs[:max(room, 0)]
            if evs:
                self._events.extend(evs)
                if th.ident not in self._thread_names:
                    self._thread_names[th.ident] = th.name

    def complete_requests(self, recs: List[tuple],
                          child: str = "exec") -> None:
        """Record sampled-request span *triples* compactly: one buffer
        entry per request, expanded to the ``serve[kind]`` root plus
        ``queued``/``child`` children at :meth:`events` time. The engine's
        read path records three spans per sampled request; building three
        dicts (plus args dicts) per request on the engine thread costs
        measurable QPS (~2-3% at sample_rate=1.0 in the obs_overhead
        bench), one 8-tuple does not. Each rec is
        ``(kind, t_submit, t_pickup, t_done, span_id, rows, gen, batch)``
        with ``batch=None`` for the write lane."""
        th = threading.current_thread()
        tid = th.ident
        entries = [("_req", child, tid) + rec for rec in recs]
        with self._lock:
            room = self._max_events - len(self._events)
            if room < len(entries):
                # a compact entry stands for 3 exported spans
                self.dropped += 3 * (len(entries) - max(room, 0))
                entries = entries[:max(room, 0)]
            if entries:
                self._events.extend(entries)
                if tid not in self._thread_names:
                    self._thread_names[tid] = th.name

    def events(self) -> List[dict]:
        """All recorded spans in buffer order, compact request records
        expanded into their root + children dicts."""
        with self._lock:
            raw = list(self._events)
        out: List[dict] = []
        for e in raw:
            if isinstance(e, dict):
                out.append(e)
                continue
            _, child, tid, kind, t0, tp, t1, sid, rows, gen, batch = e
            out.append({"name": f"serve[{kind}]", "cat": "request",
                        "t0": t0, "t1": t1, "tid": tid, "id": sid,
                        "args": {"rows": rows, "gen": gen}})
            out.append({"name": "queued", "cat": "request", "t0": t0,
                        "t1": tp, "tid": tid, "parent": sid})
            ev = {"name": child, "cat": "request", "t0": tp, "t1": t1,
                  "tid": tid, "parent": sid}
            if batch is not None:
                ev["args"] = {"batch": batch}
            out.append(ev)
        return out

    # -------------------------------------------------------------- export
    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (``ph:"X"`` complete events,
        timestamps in µs relative to the earliest span)."""
        evs = self.events()
        origin = min((e["t0"] for e in evs), default=0.0)
        out = []
        with self._lock:
            names = dict(self._thread_names)
        for tid, name in sorted(names.items()):
            out.append({"ph": "M", "name": "thread_name", "pid": 0,
                        "tid": tid, "args": {"name": name}})
        for e in evs:
            args = dict(e.get("args", {}))
            if "id" in e:
                args["id"] = e["id"]
            if "parent" in e:
                args["parent"] = e["parent"]
            out.append({
                "name": e["name"], "cat": e["cat"], "ph": "X",
                "ts": (e["t0"] - origin) * 1e6,
                "dur": max(0.0, (e["t1"] - e["t0"]) * 1e6),
                "pid": 0, "tid": e["tid"], "args": args,
            })
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
