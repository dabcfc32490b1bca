"""Continual-serving lifecycle: fit → serve → monitor → refresh, closed.

- ``buckets`` — capacity-padded :class:`BucketedState`, one geometry per
  bucket instead of one per fold-in, and ``compact_state`` (the uint16/bf16
  serving graph after a refresh swap);
- ``monitor`` — running stats from served traffic (holdout MAE/RMSE
  reservoir, fold-in volume, landmark coverage, list skew);
- ``policy`` — :class:`RefreshSpec` thresholds + hysteresis turning those
  stats into refresh decisions;
- ``refresh`` — :class:`RefreshManager`, the background refit + atomic
  artifact swap (generation-stamped through ``train.checkpoint``).

``launch/serve.py --workload cf --lifecycle`` drives the whole loop
against a drifting synthetic stream (``data.synthetic.drifting_ratings``).
"""
from .buckets import (BucketedState, bucket_capacity, bucket_schedule,
                      compact_state, ensure_capacity, fold_in_bucketed,
                      fold_in_rows, from_state, predict_pairs, recommend_topn)
from .monitor import (MonitorState, Snapshot, batch_coverage,
                      holdout_snapshot, init_monitor, observe_fold_in,
                      publish_snapshot, rebase, reservoir_add, shard_skew)
from .policy import (PolicyState, RefreshSpec, decide, should_compact,
                     should_compact_tombstones, should_rebalance)
from .refresh import RefreshManager

__all__ = [
    "BucketedState", "bucket_capacity", "bucket_schedule", "compact_state",
    "ensure_capacity",
    "fold_in_bucketed", "fold_in_rows", "from_state", "predict_pairs",
    "recommend_topn", "MonitorState", "Snapshot", "batch_coverage",
    "holdout_snapshot", "init_monitor", "observe_fold_in",
    "publish_snapshot", "rebase",
    "reservoir_add", "shard_skew", "PolicyState", "RefreshSpec", "decide",
    "should_compact", "should_compact_tombstones", "should_rebalance",
    "RefreshManager",
]
