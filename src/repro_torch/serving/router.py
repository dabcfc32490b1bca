"""The query router of the sharded request engine: owner-routed reads on a
block-partitioned ``ShardedLandmarkState``.

A read names users by sharded row id (``shard * C + slot``). Two phases
move only query-sized data off a shard:

  phase 1  each query's owner shard gives its (k,) graph row and its (P,)
           rating row: ``distributed.sharding.gather_rows`` reads the rows
           named on each shard and gathers them on shard 0, in query order;
  phase 2  each neighbor's owner shard gives that neighbor's rating row,
           gathered the same way into (b, k, P).
  epilogue Eq. (1) on the gathered rows: the one-device ``core.knn``
           arithmetic (``_pair_eq1`` / ``_block_eq1``, the k sums in
           ``_sum_k``'s fixed order), so a routed read is the one-device
           read's bits (``core.knn.predict_pairs_graph_sharded`` /
           ``recommend_topn_graph_sharded``).

``tomb`` is the write path's (S·C,) tombstone bitmap on shard 0
(``mutation.sharded``): it is read at the gathered neighbor ids only,
zeroing their weights before the padded-slot mask, as one device does.
Each call bumps ``exec.router.pair`` / ``exec.router.topn`` (launches and
rows) when an observability instance is installed, and records its
(capacity, batch) geometry with the bucketed steps'.

:func:`materialization_check` is the router's proof that a read never
builds a row-space tensor: it watches one routed pair batch and one routed
top-N batch under a ``TorchDispatchMode``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import obs as obslib
from ..core import knn
from ..distributed.sharding import materializations
from ..lifecycle import buckets


def _count_routed_launch(family: str, rows: int) -> None:
    o = obslib.current()
    if o is not None and o.enabled:
        obslib.count_launch(o.registry, f"router.{family}", rows)


def predict_pairs_routed(sstate, users: torch.Tensor, items: torch.Tensor,
                         tomb: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Routed pair predictions, (b,) on shard 0. ``users`` are sharded row
    ids; ``tomb`` masks tombstoned neighbors."""
    _count_routed_launch("pair", int(users.shape[0]))
    buckets.record_geometry("pair", sstate.capacity, users.shape[0])
    return knn.predict_pairs_graph_sharded(
        sstate.graph, sstate.ratings, users, items, n_valid=sstate.n_valid,
        shard_cap=sstate.capacity, tomb=tomb)


def recommend_topn_routed(sstate, users: torch.Tensor, n: int = 10,
                          tomb: Optional[torch.Tensor] = None):
    """Routed top-N: ``(items, scores)``, each (b, n) on shard 0."""
    _count_routed_launch("topn", int(users.shape[0]))
    buckets.record_geometry("topn", sstate.capacity, users.shape[0])
    return knn.recommend_topn_graph_sharded(
        sstate.graph, sstate.ratings, users, n, n_valid=sstate.n_valid,
        shard_cap=sstate.capacity, tomb=tomb)


def check_batch(sstate, b: int) -> int:
    """The largest batch ``<= b`` (halving) at which
    :func:`materialization_check` is not vacuous; raises when none is."""
    while b >= 1 and not _meaningful(sstate, b):
        b //= 2
    if b < 1:
        raise ValueError(f"the router check is vacuous at S*C="
                         f"{sstate.shard_count * sstate.capacity} rows at "
                         f"any batch: serve a larger population")
    return b


def _meaningful(sstate, b: int) -> bool:
    rows = sstate.shard_count * sstate.capacity
    p = sstate.ratings[0].shape[1]
    return rows > max(b * sstate.k, p, sstate.k * sstate.shard_count)


def materialization_check(sstate, b: int, n: int = 10,
                          tomb: Optional[torch.Tensor] = None
                          ) -> Tuple[int, List[tuple]]:
    """Run one routed pair batch and one routed top-N batch of ``b``
    queries under a dispatch mode that sees every tensor they build; returns
    ``(tensors scanned, offenders)``. An offender has S·C rows or more (a
    row-space tensor), or is a (b, >= S·C) score tensor. The gathers build
    (b·k, P) neighbor rows, so the check needs S·C > b·k (and > P, > k·S)
    to tell a row-space tensor from a gather: it raises otherwise
    (:func:`check_batch` picks a batch at which it is not)."""
    rows = sstate.shard_count * sstate.capacity
    if not _meaningful(sstate, b):
        raise ValueError(
            f"materialization check is vacuous at S*C={rows} rows (b*k="
            f"{b * sstate.k}, P={sstate.ratings[0].shape[1]}, "
            f"k*S={sstate.k * sstate.shard_count}); use a smaller batch")
    dev = sstate.devices[0]
    users = torch.zeros(b, dtype=torch.int64, device=dev)

    def run():
        predict_pairs_routed(sstate, users, users, tomb=tomb)
        recommend_topn_routed(sstate, users, n, tomb=tomb)

    return materializations(
        run, lambda shp: (len(shp) >= 1 and shp[0] >= rows)
        or (len(shp) >= 2 and shp[0] == b and shp[1] >= rows))
