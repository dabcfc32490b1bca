"""Online drift monitoring from served traffic — running stats on one device.

Three signals, cheap enough to update on the serve path:

- **holdout MAE/RMSE** — a reservoir (Vitter's algorithm R) of ratings
  withheld from fold-in batches; :func:`holdout_snapshot` scores them with
  the current artifact. Fold-in projects through frozen landmarks, so the
  representation decays as the population drifts away from them.
- **fold-in volume fraction** — folded rows / total rows since the last
  (re)fit.
- **landmark coverage** — EWMA over arrival batches of each new user's best
  |d1| similarity to any landmark: the leading indicator, MAE the lagging
  one.

Plus **list skew** — max/mean fill of a bounded-capacity fill vector (the
IVF posting lists), the signal of ``policy.should_rebalance``.
``policy.decide`` turns a :class:`Snapshot` into a refresh decision.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import knn
from . import buckets


@dataclasses.dataclass(frozen=True)
class MonitorState:
    """Running serving stats: the reservoir as tensors on the serving
    device, the counters and EWMAs as host numbers."""

    res_users: torch.Tensor  # (R,) int32 withheld (user, item, rating)
    res_items: torch.Tensor  # (R,) int32
    res_ratings: torch.Tensor  # (R,) float32
    res_filled: int  # occupied reservoir slots
    res_seen: int  # triples ever offered (algorithm-R denominator)
    n_base: int  # rows at the last (re)fit
    n_folded: int  # rows folded in since
    coverage: float  # EWMA of arrival landmark coverage
    base_coverage: float  # coverage measured right after the (re)fit

    @property
    def reservoir_size(self) -> int:
        return self.res_users.shape[0]


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """Host-side view of one monitoring step (inputs to ``policy.decide``)."""

    mae: float
    rmse: float
    holdout_count: int
    foldin_frac: float
    coverage: float
    coverage_ratio: float  # coverage / base_coverage
    shard_skew: float = 1.0  # max/mean fill (sharded serving)
    tombstone_frac: float = 0.0  # tombstoned rows / appended rows


def publish_snapshot(registry, snap: Snapshot,
                     prefix: str = "lifecycle") -> None:
    """Mirror a :class:`Snapshot` into an obs metrics registry as
    ``<prefix>.<field>`` gauges — the lifecycle series of the unified
    metrics export (``serve --metrics-json``). One gauge per field; an
    empty-reservoir NaN MAE exports as NaN (null in strict JSON), not 0 —
    absence of evidence stays distinguishable from a perfect score."""
    for f in dataclasses.fields(snap):
        registry.gauge(f"{prefix}.{f.name}").set(
            float(getattr(snap, f.name)))


def init_monitor(reservoir_size: int, n_base: int, base_coverage: float,
                 device="cuda") -> MonitorState:
    z = torch.zeros(reservoir_size, dtype=torch.int32, device=device)
    return MonitorState(
        res_users=z, res_items=z.clone(),
        res_ratings=torch.zeros(reservoir_size, device=device),
        res_filled=0, res_seen=0, n_base=int(n_base), n_folded=0,
        coverage=float(base_coverage), base_coverage=float(base_coverage))


def shard_skew(fills) -> float:
    """max/mean fill ratio of a bounded-capacity fill vector — 1.0 is
    perfectly balanced; an all-empty vector reports 1.0."""
    if isinstance(fills, torch.Tensor):
        fills = fills.cpu().numpy()
    f = np.asarray(fills, dtype=np.float64)
    mean = f.mean() if f.size else 0.0
    return float(f.max() / mean) if mean > 0 else 1.0


def batch_coverage(rep: torch.Tensor, valid: torch.Tensor) -> float:
    """Mean over valid rows of the best |d1| similarity to any landmark
    (``rep`` (b, n), ``valid`` (b,) bool or 0/1). A row with no co-rated
    items against every landmark scores 0."""
    best = rep.abs().amax(dim=1)
    v = valid.to(torch.float32)
    return float((best * v).sum() / v.sum().clamp(min=1.0))


def observe_fold_in(mon: MonitorState, new_rep: torch.Tensor, b_valid: int,
                    alpha: float = 0.3) -> MonitorState:
    """Fold one arrival batch into the volume and coverage stats (EWMA)."""
    valid = torch.arange(new_rep.shape[0], device=new_rep.device) < b_valid
    cov = batch_coverage(new_rep, valid)
    return dataclasses.replace(
        mon, n_folded=mon.n_folded + int(b_valid),
        coverage=(1.0 - alpha) * mon.coverage + alpha * cov)


def reservoir_add(mon: MonitorState, generator: torch.Generator,
                  users: torch.Tensor, items: torch.Tensor,
                  ratings: torch.Tensor, m_valid: int) -> MonitorState:
    """Algorithm-R reservoir sampling of withheld triples.

    Only the first ``m_valid`` entries are offered. While the reservoir has
    room each triple takes the next slot; after that triple t (counted over
    every offer so far) replaces a uniform slot with probability R/t. The
    slots are decided on the host from one draw of ``generator`` per
    offered triple, then written in one scatter (a later triple that lands
    on the slot of an earlier one of the same batch wins, as in sequence).
    """
    r_cap = mon.reservoir_size
    m = int(m_valid)
    draws = torch.rand(m, generator=generator, dtype=torch.float64).tolist()
    filled, seen = mon.res_filled, mon.res_seen
    slot_of = {}  # reservoir slot -> index of the triple that holds it
    for t in range(m):
        seen += 1
        if filled < r_cap:
            slot_of[filled] = t
            filled += 1
            continue
        j = int(draws[t] * seen)  # uniform in [0, seen)
        if j < r_cap:
            slot_of[j] = t
    if not slot_of:
        return dataclasses.replace(mon, res_filled=filled, res_seen=seen)
    dev = mon.res_users.device
    slots = torch.tensor(list(slot_of), dtype=torch.long, device=dev)
    src = torch.tensor(list(slot_of.values()), dtype=torch.long, device=dev)
    ru, ri, rr = (mon.res_users.clone(), mon.res_items.clone(),
                  mon.res_ratings.clone())
    ru[slots] = users.to(dev)[src].to(torch.int32)
    ri[slots] = items.to(dev)[src].to(torch.int32)
    rr[slots] = ratings.to(dev)[src].to(torch.float32)
    return dataclasses.replace(mon, res_users=ru, res_items=ri,
                               res_ratings=rr, res_filled=filled,
                               res_seen=seen)


def _holdout_stats(mon: MonitorState, graph, ratings, n_valid, tomb=None,
                   *, id_map=None, shard_cap=None):
    """Reservoir (MAE, RMSE) under the current artifact, padded rows
    masked through ``n_valid``. ``tomb`` (the write path's tombstone
    bitmap) drops the triples of deleted users, and their rows from every
    neighbor list.

    On the sharded path (``shard_cap`` set) ``graph`` and ``ratings`` are
    per-shard blocks, ``n_valid`` the per-shard fills, and the reservoir's
    logical user ids go through ``id_map`` (host array, logical id →
    sharded row id) first; ``tomb`` is then indexed by sharded row id."""
    r = mon.reservoir_size
    dev = mon.res_users.device
    slot_valid = torch.arange(r, device=dev) < mon.res_filled
    users = torch.where(slot_valid, mon.res_users, 0)
    if shard_cap is not None:
        users = torch.as_tensor(np.asarray(id_map)[users.cpu().numpy()])
    if tomb is not None:
        slot_valid = slot_valid & ~tomb[users.long().to(tomb.device)].to(dev)
    items = torch.where(slot_valid, mon.res_items, 0)
    if shard_cap is None:
        preds = knn.predict_pairs_graph(graph, ratings, users, items,
                                        n_valid=n_valid, tomb=tomb)
    else:
        preds = knn.predict_pairs_graph_sharded(
            graph, ratings, users, items, n_valid=n_valid,
            shard_cap=shard_cap, tomb=tomb).to(dev)
    err = (preds - mon.res_ratings) * slot_valid
    cnt = max(float(slot_valid.sum()), 1.0)
    mae = float(err.abs().sum()) / cnt
    rmse = float((err * err).sum() / cnt) ** 0.5
    return mae, rmse


def holdout_snapshot(mon: MonitorState, bstate, tomb=None,
                     tombstone_frac: float = 0.0) -> Snapshot:
    """Score the reservoir with the current artifact → :class:`Snapshot`.
    The geometry (capacity, reservoir) is recorded with the bucketed
    steps'. ``tomb``/``tombstone_frac`` come from the write path
    (``mutation.MutableState``): deleted users leave the holdout, and their
    fraction rides along for the compaction gate."""
    buckets.record_geometry("holdout", bstate.capacity, mon.reservoir_size)
    mae, rmse = _holdout_stats(mon, bstate.state.graph, bstate.state.ratings,
                               bstate.n_valid, tomb)
    frac = mon.n_folded / max(mon.n_base + mon.n_folded, 1)
    return Snapshot(mae=mae, rmse=rmse, holdout_count=mon.res_filled,
                    foldin_frac=frac, coverage=mon.coverage,
                    coverage_ratio=mon.coverage / max(mon.base_coverage, 1e-9),
                    tombstone_frac=tombstone_frac)


def holdout_snapshot_sharded(mon: MonitorState, sstate, id_map, tomb=None,
                             tombstone_frac: float = 0.0) -> Snapshot:
    """:func:`holdout_snapshot` for a ShardedLandmarkState. ``id_map`` maps
    the reservoir's logical user ids (stable across capacity regrowth and
    refresh repacking) to sharded row ids; ``tomb`` is the sharded write
    path's (S·C,) bitmap (``mutation.sharded``), indexed by sharded row id;
    the snapshot carries the fill skew of the shards (``shard_skew``)."""
    buckets.record_geometry("holdout", sstate.capacity, mon.reservoir_size)
    mae, rmse = _holdout_stats(mon, sstate.graph, sstate.ratings,
                               sstate.n_valid, tomb, id_map=id_map,
                               shard_cap=sstate.capacity)
    frac = mon.n_folded / max(mon.n_base + mon.n_folded, 1)
    return Snapshot(mae=mae, rmse=rmse, holdout_count=mon.res_filled,
                    foldin_frac=frac, coverage=mon.coverage,
                    coverage_ratio=mon.coverage / max(mon.base_coverage, 1e-9),
                    shard_skew=shard_skew(sstate.n_valid),
                    tombstone_frac=tombstone_frac)


def rebase(mon: MonitorState, n_base: int, base_coverage: float
           ) -> MonitorState:
    """Reset the per-generation stats after an artifact swap. The reservoir
    is kept: pre- and post-refresh MAE are measured on the same withheld
    set."""
    return dataclasses.replace(mon, n_base=int(n_base), n_folded=0,
                               coverage=float(base_coverage),
                               base_coverage=float(base_coverage))
