"""Request-path serving: the micro-batching engine and latency stats.

``serving.stats`` is the shared p50/p95/p99 helper (wave loops + engine),
``serving.engine`` the continuous micro-batching core with admission
control and the async write lane (folds, and updates and removals on a
``MutableLocalBackend`` or ``MutableShardedBackend``), ``serving.router``
the sharded backends' owner-routed reads. ``launch/serve.py --engine``
wires them into the load-generator harness.
"""
from .engine import (EngineConfig, LocalBackend, MutableLocalBackend,
                     MutableShardedBackend, Request, RequestEngine,
                     ShardedBackend)
from .stats import LatencyStats, histogram_latency, latency_stats

__all__ = [
    "EngineConfig",
    "LatencyStats",
    "LocalBackend",
    "MutableLocalBackend",
    "MutableShardedBackend",
    "Request",
    "RequestEngine",
    "ShardedBackend",
    "histogram_latency",
    "latency_stats",
]
