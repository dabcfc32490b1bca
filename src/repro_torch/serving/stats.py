"""Shared latency statistics — one percentile helper for every serve mode:
p50/p95/p99 plus the sample count, used by the wave replays of
``launch/serve.py`` and, through :func:`histogram_latency`, by the request
engine's bounded per-kind latency histograms."""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class LatencyStats:
    """Percentiles of one latency population, in milliseconds."""

    count: int
    p50_ms: float
    p95_ms: float
    p99_ms: float

    def brief(self) -> str:
        """The wave-log rendering: ``p50=0.63ms p95=1.09ms p99=1.31ms``."""
        if not self.count:
            return "p50=-- p95=-- p99=--"
        return (f"p50={self.p50_ms:.2f}ms p95={self.p95_ms:.2f}ms "
                f"p99={self.p99_ms:.2f}ms")


def latency_stats(ts: Sequence[float]) -> LatencyStats:
    """(count, p50, p95, p99) of a list of request latencies in *seconds*.

    Empty input yields NaN percentiles with ``count=0`` — callers render via
    :meth:`LatencyStats.brief` rather than branching on emptiness.
    """
    if not len(ts):
        return LatencyStats(0, float("nan"), float("nan"), float("nan"))
    ms = np.asarray(ts, dtype=float) * 1e3
    p50, p95, p99 = (float(x) for x in np.percentile(ms, (50, 95, 99)))
    return LatencyStats(len(ms), p50, p95, p99)



def histogram_latency(hist) -> LatencyStats:
    """:class:`LatencyStats` view of an ``obs.Histogram`` recorded in
    milliseconds — the engine's bounded replacement for raw latency lists.
    Quantiles are the histogram's bucket-resolved order statistics, within
    one bucket width (≤ ``growth - 1`` relative) of exact."""
    if not hist.count:
        return LatencyStats(0, float("nan"), float("nan"), float("nan"))
    return LatencyStats(hist.count, hist.percentile(50),
                        hist.percentile(95), hist.percentile(99))
