"""Unified observability: metrics registry + request tracing + profiling.

One container object (:class:`Observability`) bundles the substrates — a
:class:`~repro_torch.obs.registry.MetricsRegistry` and a
:class:`~repro_torch.obs.trace.Tracer` — and is either threaded explicitly
(``RequestEngine(..., obs=o)``) or installed as the process-wide current
instance (:func:`install`) so subsystems that have no parameter path to the
serve loop (the background refresh thread) can emit spans and counters via
:func:`current` / :func:`span`. ``profile.py`` holds the device-side hooks:
a ``torch.profiler`` capture and the launch/geometry accounting.

The disabled configuration costs nothing on hot paths: producers guard on
``tracer.active`` (one attribute read) and the engine's own bounded
histograms and plain-int counters are always on — the registry is written
only at ``publish_metrics`` time. ``DISABLED`` is the canonical inert
instance.

Series naming convention (dotted prefixes, one registry):
``engine.*`` request path · ``retrieval.*`` ANN sidecar · ``lifecycle.*``
drift monitor + refresh · ``exec.*`` per-family launch/geometry accounting.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Optional

from .profile import (count_launch, profile_trace, profiled,
                      publish_compile_counts, strip_markers)
from .registry import Counter, Gauge, Histogram, MetricsRegistry
from .trace import Sampler, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Sampler",
    "Tracer", "Observability", "DISABLED", "install", "uninstall",
    "current", "span", "count_launch", "profile_trace", "profiled",
    "strip_markers",
    "publish_compile_counts",
]


class Observability:
    """Registry + tracer + export, one handle."""

    def __init__(self, *, sample_rate: float = 1.0, seed: int = 0,
                 max_events: int = 200_000, enabled: bool = True) -> None:
        self.enabled = enabled
        self.registry = MetricsRegistry()
        self.tracer = Tracer(sample_rate=sample_rate, seed=seed,
                             max_events=max_events, active=enabled)

    def export_trace(self, trace_dir: str, name: str = "trace.json") -> str:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, name)
        self.tracer.export(path)
        return path

    def export_metrics(self, path: str) -> str:
        """Strict-JSON metrics snapshot (non-finite floats → null)."""
        snap = _sanitize(self.registry.snapshot())
        with open(path, "w") as f:
            json.dump(snap, f, indent=1, allow_nan=False)
        return path


def _sanitize(x):
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _sanitize(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_sanitize(v) for v in x]
    return x


DISABLED = Observability(enabled=False)

_current: Optional[Observability] = None


def install(obs: Observability) -> None:
    """Make ``obs`` the process-wide current instance (for subsystems with
    no parameter path from the serve loop)."""
    global _current
    _current = obs


def uninstall() -> None:
    global _current
    _current = None


def current() -> Optional[Observability]:
    return _current


@contextlib.contextmanager
def span(name: str, cat: str = "bg", args: Optional[dict] = None,
         obs: Optional[Observability] = None):
    """Record the block as one span on ``obs`` (default: the installed
    current instance). No-op when nothing is installed or tracing is off —
    background subsystems wrap coarse regions (a refit, a commit), so the
    disabled cost is one generator frame per region, never per request."""
    o = _current if obs is None else obs
    if o is None or not o.tracer.active:
        yield None
        return
    t0 = time.monotonic()
    try:
        yield o
    finally:
        o.tracer.complete(name, cat, t0, time.monotonic(), args=args)
