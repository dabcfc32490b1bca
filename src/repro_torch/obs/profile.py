"""Profiling hooks — a ``torch.profiler`` capture and launch/geometry
accounting.

Two concerns live here because both answer "what did the device run":

  ``profile_trace(dir)``   a context manager that wraps a region in a
                           ``torch.profiler`` capture (CPU activity, and
                           CUDA activity where a card is present) when
                           ``dir`` is set, and exports it as a Chrome trace
                           into ``dir`` on exit; a no-op otherwise. The
                           serve loop wraps the engine's load window in it
                           (``--torch-profile``). A capture that was asked
                           for and fails raises: a missing profile must not
                           pass silently.
  ``profiled()``           the session itself: one that traces CUDA opens
                           with ``PROFILE_MARKERS`` spin kernels and a sync.
                           Once a process has traced many kernels,
                           ``torch.profiler`` drops the first device records
                           of later sessions (on an H100 up to 87 a
                           session); the drop is a prefix, so when a marker
                           survives (``strip_markers``) the records after
                           them are whole.
  launch/geometry counts   ``count_launch`` bumps per-family launch and row
                           counters; ``publish_compile_counts`` publishes
                           ``exec.<family>.compiles`` — the growth since a
                           baseline of the distinct (capacity, batch)
                           geometries each request-path family ran at
                           (``lifecycle.buckets.geometry_counts``), the
                           port's counterpart of jit-cache growth, and the
                           quantity the serve smoke's geometry budget bounds.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional

from .registry import MetricsRegistry

TRACE_NAME = "torch_trace.json"
PROFILE_MARKERS = 256  # spin kernels that open a session tracing CUDA
MARKER = "spin_kernel"  # their device records' name (torch.cuda._sleep)


@contextlib.contextmanager
def profiled():
    """A ``torch.profiler`` session (CPU activity, and CUDA activity where
    a card is present) that, when it traces CUDA, opens with
    ``PROFILE_MARKERS`` spin kernels on the current device and a sync;
    yields the running profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        if cuda:
            for _ in range(PROFILE_MARKERS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        yield prof


def strip_markers(records, name=lambda r: r.name):
    """A ``profiled`` session's device records split from its markers:
    ``(records less the markers, markers lost)``, the first None when
    every marker was lost (and so maybe some of the run's records).
    ``name`` reads a record's kernel name (a profiler event's ``.name``, a
    Chrome-trace event's ``["name"]``)."""
    records = list(records)
    kept = [r for r in records if MARKER not in name(r)]
    seen = len(records) - len(kept)
    return (kept if seen else None), PROFILE_MARKERS - seen


@contextlib.contextmanager
def profile_trace(trace_dir: Optional[str]):
    """Capture a ``profiled`` session of the block into
    ``trace_dir/torch_trace.json``; yields the running profiler, or None
    when ``trace_dir`` is unset. Errors from the profiler propagate."""
    if not trace_dir:
        yield None
        return
    os.makedirs(trace_dir, exist_ok=True)
    with profiled() as prof:
        yield prof
    path = os.path.join(trace_dir, TRACE_NAME)
    prof.export_chrome_trace(path)
    if not os.path.getsize(path):
        raise RuntimeError(f"torch.profiler wrote an empty trace to {path}")


def count_launch(registry: MetricsRegistry, family: str, rows: int) -> None:
    """One device-program launch of ``family`` covering ``rows`` rows."""
    registry.counter(f"exec.{family}.launches").inc()
    registry.counter(f"exec.{family}.rows").inc(rows)


def publish_compile_counts(registry: MetricsRegistry,
                           baseline: Optional[Dict[str, int]] = None) -> None:
    """Gauge ``exec.<family>.compiles`` = growth of each step family's
    distinct geometries since ``baseline`` (an earlier
    ``geometry_counts()``; the serve loop takes it before its warm-up)."""
    from ..lifecycle.buckets import geometry_counts

    baseline = baseline or {}
    for family, n in sorted(geometry_counts().items()):
        registry.gauge(f"exec.{family}.compiles").set(
            float(n - baseline.get(family, 0)))
