"""Retrieval-side observability: the ANN sidecar's gauges, one registry.

The serve loop's IVF health sidecar computes everything worth watching —
the escalating ``nprobe``, the early-exit probe counts, the recall-SLO
probe results. One call per measurement point publishes them as the
``retrieval.*`` series of the unified metrics registry, so retrieval
pressure correlates (by snapshot) with engine queue depth and lifecycle
drift in a single export.

When serving runs *without* an ANN index the retrieval series still
exists: ``retrieval.exact = 1`` with ``nprobe = 0`` states that reads are
exact full-graph lookups — the metrics schema (engine + retrieval +
lifecycle groups present) holds in every serve mode.
"""
from __future__ import annotations

import math
from typing import Optional


def publish_retrieval(registry, *, nprobe: int = 0, clusters: int = 0,
                      probed_per_q: float = math.nan,
                      recall: float = math.nan,
                      early_exit: Optional[bool] = None,
                      escalations: int = 0,
                      probes: Optional[int] = None) -> None:
    """Publish the ``retrieval.*`` gauge/counter series.

    ``nprobe``/``clusters`` describe the active index geometry (0/0 ⇒
    exact retrieval, also flagged by ``retrieval.exact``); ``probed_per_q``
    is the early-exit mean probes per query (== nprobe when early exit is
    off); ``recall`` the latest recall-sidecar measurement against the
    full-budget reference; ``escalations`` the cumulative count of
    SLO-driven nprobe raises; ``probes`` the cumulative number of sidecar
    probe batches run.
    """
    registry.gauge("retrieval.exact").set(0.0 if clusters else 1.0)
    registry.gauge("retrieval.nprobe").set(float(nprobe))
    registry.gauge("retrieval.clusters").set(float(clusters))
    registry.gauge("retrieval.probed_per_q").set(float(probed_per_q))
    registry.gauge("retrieval.recall").set(float(recall))
    if early_exit is not None:
        registry.gauge("retrieval.early_exit").set(1.0 if early_exit
                                                   else 0.0)
    registry.counter("retrieval.escalations").set(int(escalations))
    if probes is not None:
        registry.counter("retrieval.probes").set(int(probes))
