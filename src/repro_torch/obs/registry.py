"""Metrics registry — counters, gauges, and log-bucketed histograms.

One substrate for the serving stack's statistics: the request engine's
per-kind latencies and counters, the lifecycle's drift gauges and the
retrieval sidecar's gauges all land here, by dotted series name. A copy of
the JAX package's registry (pure Python and numpy), so that both packages
export the same schema:

  Counter    monotonic int64; ``inc`` on the producing thread, ``set`` to
             publish an externally-maintained total (the engine keeps its
             own plain-int hot-path counters and copies them in at
             snapshot time, so the registry adds zero hot-path cost).
  Gauge      a point-in-time float (queue depth, nprobe, holdout MAE).
  Histogram  HDR-style log-bucketed distribution with *fixed* memory:
             bucket upper edges ``lo * growth**i``, one int64 count per
             bucket plus an overflow slot, exact running count/sum/min/max.
             ``percentile(q)`` returns the upper edge of the bucket holding
             the rank-``ceil(q/100 * n)`` order statistic (the
             ``inverted_cdf`` convention), clamped to the observed max —
             always within one bucket width of the exact order statistic.
             With the default ``growth = 2**0.125`` the relative error is
             bounded by ``growth - 1`` ≈ 9%.

Everything is thread-safe: each instrument carries its own lock (a record
is one bisect + one int bump, ~µs), and the registry's creation path is
locked separately so get-or-create races can't mint two instruments for
one name. ``snapshot()`` exports a JSON-able dict, ``delta(prev)`` the
counter/bucket differences between two snapshots, ``to_prometheus()`` the
text exposition format (histograms as cumulative ``_bucket{le=...}``
series).
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional

import numpy as np

# defaults sized for request latencies in milliseconds: 1µs .. 60s
DEFAULT_LO_MS = 1e-3
DEFAULT_HI_MS = 6e4
DEFAULT_GROWTH = 2 ** 0.125


class Counter:
    """Monotonic event count. ``inc`` accumulates; ``set`` publishes an
    externally-maintained absolute total (hot paths keep plain ints and
    copy them in — see ``RequestEngine.publish_metrics``)."""

    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += int(n)

    def set(self, v: int) -> None:
        with self._lock:
            self.value = int(v)


class Gauge:
    """Point-in-time float — last write wins."""

    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = float("nan")
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)


class Histogram:
    """Log-bucketed distribution with fixed memory.

    Bucket ``i`` covers ``(edges[i-1], edges[i]]`` (bucket 0 is
    ``(-inf, edges[0]]``); values above ``edges[-1]`` land in the overflow
    slot. Recording a value that equals an edge exactly lands in that
    edge's own bucket — the boundary-exactness contract the unit tests pin
    down, inherited from ``np.searchsorted(side="left")``.
    """

    __slots__ = ("edges", "counts", "count", "total", "vmin", "vmax",
                 "_lock")

    def __init__(self, lo: float = DEFAULT_LO_MS, hi: float = DEFAULT_HI_MS,
                 growth: float = DEFAULT_GROWTH) -> None:
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError(f"bad histogram geometry lo={lo} hi={hi} "
                             f"growth={growth}")
        n = int(math.ceil(math.log(hi / lo) / math.log(growth))) + 1
        self.edges = lo * growth ** np.arange(n, dtype=np.float64)
        self.counts = np.zeros(n + 1, dtype=np.int64)  # [-1] == overflow
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self._lock = threading.Lock()

    def record(self, v: float) -> None:
        v = float(v)
        i = int(np.searchsorted(self.edges, v, side="left"))
        with self._lock:
            self.counts[i] += 1     # i == len(edges) is the overflow slot
            self.count += 1
            self.total += v
            self.vmin = min(self.vmin, v)
            self.vmax = max(self.vmax, v)

    def percentile(self, q: float) -> float:
        """Upper edge of the bucket holding the rank-``ceil(q/100 * n)``
        order statistic (``inverted_cdf``), clamped to ``[vmin, vmax]`` —
        within one bucket width of the exact order statistic."""
        with self._lock:
            if not self.count:
                return float("nan")
            rank = max(1, int(math.ceil(q / 100.0 * self.count)))
            cum = np.cumsum(self.counts)
            i = int(np.searchsorted(cum, rank, side="left"))
            if i >= len(self.edges):    # overflow bucket: best bound is max
                return self.vmax
            return float(min(max(self.edges[i], self.vmin), self.vmax))

    def merge(self, other: "Histogram") -> "Histogram":
        """Accumulate ``other`` into self (same geometry required).
        Associative and commutative over the bucket algebra — merging
        shard-local histograms in any order yields identical counts."""
        if len(self.edges) != len(other.edges) or not np.array_equal(
                self.edges, other.edges):
            raise ValueError("histogram merge requires identical bucket "
                             "geometry")
        with other._lock:
            oc = other.counts.copy()
            on, ot = other.count, other.total
            omin, omax = other.vmin, other.vmax
        with self._lock:
            self.counts += oc
            self.count += on
            self.total += ot
            self.vmin = min(self.vmin, omin)
            self.vmax = max(self.vmax, omax)
        return self

    def copy_from(self, other: "Histogram") -> None:
        """Overwrite with ``other``'s state — the publish path: the engine
        owns the live histogram and re-publishes a copy each snapshot, so
        repeated publishes never double-count."""
        with other._lock:
            oc = other.counts.copy()
            on, ot = other.count, other.total
            omin, omax = other.vmin, other.vmax
        with self._lock:
            self.counts = oc
            self.count = on
            self.total = ot
            self.vmin = omin
            self.vmax = omax

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "count": int(self.count),
                "sum": float(self.total),
                "min": float(self.vmin) if self.count else None,
                "max": float(self.vmax) if self.count else None,
                "edges": [float(e) for e in self.edges],
                "counts": [int(c) for c in self.counts],
            }


class MetricsRegistry:
    """Named instruments, get-or-create. One registry per process (or per
    test); subsystems address series by dotted prefix — ``engine.*``,
    ``retrieval.*``, ``lifecycle.*``, ``mutation.*``, ``exec.*``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str, *, like: Optional[Histogram] = None,
                  **kw) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                if like is not None:
                    kw = {"lo": float(like.edges[0]),
                          "hi": float(like.edges[-1]),
                          "growth": float(like.edges[1] / like.edges[0])}
                h = self._hists[name] = Histogram(**kw)
            return h

    def publish_histogram(self, name: str, src: Histogram) -> None:
        """Copy ``src`` into the registry under ``name`` (idempotent —
        republishing the same live histogram overwrites, never doubles)."""
        self.histogram(name, like=src).copy_from(src)

    def empty(self) -> bool:
        with self._lock:
            return not (self._counters or self._gauges or self._hists)

    # ------------------------------------------------------------- export
    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.snapshot()
                           for k, h in sorted(hists.items())},
        }

    def delta(self, prev: dict) -> dict:
        """Difference of the current snapshot against ``prev`` (an earlier
        ``snapshot()``): counters and histogram bucket counts subtract,
        gauges report their current value (a gauge delta is meaningless)."""
        cur = self.snapshot()
        pc = prev.get("counters", {})
        ph = prev.get("histograms", {})
        out = {
            "counters": {k: v - pc.get(k, 0)
                         for k, v in cur["counters"].items()},
            "gauges": dict(cur["gauges"]),
            "histograms": {},
        }
        for k, h in cur["histograms"].items():
            p = ph.get(k)
            if p is None or p.get("edges") != h["edges"]:
                out["histograms"][k] = h
                continue
            out["histograms"][k] = {
                "count": h["count"] - p["count"],
                "sum": h["sum"] - p["sum"],
                "min": h["min"], "max": h["max"],
                "edges": h["edges"],
                "counts": [a - b for a, b in zip(h["counts"], p["counts"])],
            }
        return out

    def to_prometheus(self) -> str:
        """Text exposition format. Histograms render as cumulative
        ``_bucket{le="..."}`` series plus ``_sum``/``_count``."""
        snap = self.snapshot()
        lines = []
        for k, v in snap["counters"].items():
            n = _prom_name(k)
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {v}")
        for k, v in snap["gauges"].items():
            n = _prom_name(k)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {_prom_value(v)}")
        for k, h in snap["histograms"].items():
            n = _prom_name(k)
            lines.append(f"# TYPE {n} histogram")
            cum = 0
            for edge, c in zip(h["edges"], h["counts"]):
                cum += c
                lines.append(f'{n}_bucket{{le="{edge:g}"}} {cum}')
            lines.append(f'{n}_bucket{{le="+Inf"}} {h["count"]}')
            lines.append(f"{n}_sum {_prom_value(h['sum'])}")
            lines.append(f"{n}_count {h['count']}")
        return "\n".join(lines) + "\n"


def _prom_name(name: str) -> str:
    return "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def _prom_value(v: float) -> str:
    if v != v:
        return "NaN"
    if v in (math.inf, -math.inf):
        return "+Inf" if v > 0 else "-Inf"
    return f"{v:g}"
