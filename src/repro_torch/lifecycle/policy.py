"""Refresh policy: thresholds + hysteresis over monitor snapshots.

Pure control plane — plain Python over host floats, the same rules as the
reference's ``repro.lifecycle.policy``. A refresh is an expensive
background refit, so the policy is sticky: a breach must persist
``patience`` consecutive evaluations, and after a swap no new refresh fires
for ``cooldown_waves`` evaluations (the post-swap stats need time to
rebase).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

from .monitor import Snapshot


@dataclasses.dataclass(frozen=True)
class RefreshSpec:
    """Knobs of the fit→serve→monitor→refresh loop."""

    mae_ratio: float = 1.10  # refresh when holdout MAE > base_mae * this
    min_coverage_ratio: float = 0.85  # ... or arrival coverage / base < this
    max_foldin_frac: float = 0.5  # ... or folded rows / total rows > this
    patience: int = 2  # consecutive breaching evaluations before firing
    cooldown_waves: int = 2  # evaluations after a swap with firing suppressed
    min_holdout: int = 32  # ignore the MAE signal below this reservoir fill
    reservoir: int = 512  # withheld-rating reservoir size
    holdout_frac: float = 0.2  # fraction of each arrival's ratings withheld
    compact_serving: bool = False  # after a refresh swap, serve the uint16/
    #                                bf16 compact graph (widened on growth)
    compact_max_rows: int = 65536  # uint16 id ceiling for compaction
    max_skew: float = 2.0  # rebalance when max/mean fill exceeds this ...
    rebalance_patience: int = 2  # ... for this many consecutive evaluations
    max_tombstone_frac: float = 0.25  # refresh (and compact the tombstones
    #                                   out) when deleted rows / appended
    #                                   rows exceeds this


@dataclasses.dataclass
class PolicyState:
    """Mutable hysteresis state carried across evaluations."""

    base_mae: float = math.nan  # holdout MAE right after the last (re)fit
    streak: int = 0  # consecutive breaching evaluations
    cooldown: int = 0  # evaluations left before firing is allowed again
    generation: int = 0  # last committed artifact generation
    refreshing: bool = False  # a background refit is in flight
    skew_streak: int = 0  # consecutive skew breaches (should_rebalance)


def decide(pol: PolicyState, spec: RefreshSpec, snap: Snapshot
           ) -> Tuple[bool, List[str]]:
    """One evaluation step: update hysteresis in place, return (fire, reasons).

    ``fire=True`` means "launch a background refresh now"; the caller flips
    ``pol.refreshing`` back off (via :func:`on_swap`) once the new artifact is
    committed and swapped in.
    """
    reasons = []
    if (not math.isnan(pol.base_mae) and snap.holdout_count >= spec.min_holdout
            and snap.mae > pol.base_mae * spec.mae_ratio):
        reasons.append(f"mae {snap.mae:.3f} > {spec.mae_ratio:.2f}x "
                       f"base {pol.base_mae:.3f}")
    if snap.coverage_ratio < spec.min_coverage_ratio:
        reasons.append(f"coverage ratio {snap.coverage_ratio:.2f} < "
                       f"{spec.min_coverage_ratio:.2f}")
    if snap.foldin_frac > spec.max_foldin_frac:
        reasons.append(f"fold-in frac {snap.foldin_frac:.2f} > "
                       f"{spec.max_foldin_frac:.2f}")
    if snap.tombstone_frac > spec.max_tombstone_frac:
        reasons.append(f"tombstone frac {snap.tombstone_frac:.2f} > "
                       f"{spec.max_tombstone_frac:.2f}")

    pol.streak = pol.streak + 1 if reasons else 0
    if pol.cooldown > 0:
        pol.cooldown -= 1
        return False, reasons
    if pol.refreshing or pol.streak < spec.patience:
        return False, reasons
    return True, reasons


def should_rebalance(pol: PolicyState, spec: RefreshSpec, skew: float) -> bool:
    """Hysteresis gate on a fill-skew signal (``monitor.shard_skew``): the
    breach must persist ``rebalance_patience`` consecutive evaluations, and
    firing resets the streak (the rebuild itself is the cooldown)."""
    if skew > spec.max_skew:
        pol.skew_streak += 1
    else:
        pol.skew_streak = 0
    if pol.skew_streak >= spec.rebalance_patience:
        pol.skew_streak = 0
        return True
    return False


def should_compact_tombstones(spec: RefreshSpec, tombstone_frac: float
                              ) -> bool:
    """Write-path compaction gate: evict tombstoned rows once the dead
    fraction of the appended row space crosses ``max_tombstone_frac``."""
    return tombstone_frac > spec.max_tombstone_frac


def should_compact(spec: RefreshSpec, n_rows: int) -> bool:
    """Serve the compact uint16/bf16 graph after a refresh commit while
    every row id fits a uint16 (``n_rows``: the padded capacity)."""
    return spec.compact_serving and n_rows < spec.compact_max_rows


def on_fire(pol: PolicyState) -> None:
    """Mark the background refit as launched (suppresses re-firing)."""
    pol.refreshing = True
    pol.streak = 0


def on_swap(pol: PolicyState, generation: int, post_swap_mae: float,
            spec: RefreshSpec) -> None:
    """Rebase hysteresis after the new artifact is swapped in."""
    assert generation > pol.generation, (generation, pol.generation)
    pol.generation = generation
    pol.base_mae = post_swap_mae
    pol.refreshing = False
    pol.streak = 0
    pol.cooldown = spec.cooldown_waves
