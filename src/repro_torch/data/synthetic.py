"""Synthetic inputs: LM token batches, the CF lifecycle's arrival stream
and the write path's mutation events.

Numpy copies of the reference's ``lm_batch``, ``drifting_ratings`` and
``mutation_events``: deterministic in ``(seed, step)`` / ``(seed, wave)``,
so one seed gives byte-identical arrays in both packages.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def lm_batch(seed: int, step: int, batch: int, seq_len: int, vocab: int
             ) -> Dict[str, np.ndarray]:
    """Zipf-distributed token stream with next-token labels."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # Zipf via inverse-CDF over a truncated harmonic distribution.
    u = rng.random((batch, seq_len + 1))
    toks = np.minimum((u ** (-1.0 / 1.1) - 1.0).astype(np.int64), vocab - 1)
    toks = toks % vocab
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }


def drifting_ratings(
    seed: int,
    wave: int,
    batch: int,
    n_items: int,
    *,
    n_waves: int = 8,
    n_groups: int = 4,
    drift: float = 1.0,
    density: float = 0.25,
    sigma: float = 0.6,
) -> np.ndarray:
    """Preference-drifting arrival stream for the CF lifecycle loop.

    Items are split into ``n_groups`` contiguous blocks; wave ``t``'s users
    concentrate their ratings on a Gaussian window of groups whose center
    slides from group 0 (wave 0) to ``drift * (n_groups - 1)`` (last wave), and
    rate focus-group items high and off-focus items low. Early and late waves
    therefore rate nearly disjoint item sets — landmarks selected at wave 0
    lose coverage of later arrivals, which is exactly what the drift monitor
    must detect (tested in tests/test_lifecycle.py).

    Deterministic in (seed, wave) like every generator in this module; returns
    a dense (batch, n_items) block, 0 == missing.
    """
    rng = np.random.default_rng(np.random.SeedSequence([seed, wave]))
    g = (np.arange(n_items) * n_groups) // n_items  # item -> group
    center = drift * (n_groups - 1) * wave / max(n_waves - 1, 1)
    aff = np.exp(-0.5 * ((np.arange(n_groups) - center) / sigma) ** 2)
    aff = aff / max(aff.max(), 1e-12)  # focus group -> 1.0
    # per-item rating probability: overall density held fixed, mass follows aff
    p_item = density * n_items * aff[g] / max(aff[g].sum(), 1e-12)
    p_item = np.clip(p_item, 0.0, 0.95)
    rated = rng.random((batch, n_items)) < p_item[None, :]
    base = 1.0 + 4.0 * aff[g]  # focus items ~5, fringe ~1
    vals = np.clip(np.rint(base[None, :] + rng.normal(0.0, 0.7, (batch, n_items))),
                   1, 5)
    return (vals * rated).astype(np.float32)


def mutation_events(
    seed: int,
    wave: int,
    n_users: int,
    n_items: int,
    *,
    n_events: int = 16,
    rerate_frac: float = 0.5,
    unrate_frac: float = 0.25,
    delete_frac: float = 0.25,
    density: float = 0.25,
) -> Dict[str, np.ndarray]:
    """Write-path event stream (re-rate / un-rate / delete), deterministic in
    ``(seed, wave)``.

    Each wave draws ``n_events`` events over distinct users of
    ``[0, n_users)``, each event's kind from the (rerate, unrate, delete)
    fractions, normalized. A re-rate carries a full replacement rating row
    at ``density``; an un-rate a replacement row with about half of a fresh
    row's entries cleared (both are ``"update"`` requests); a delete carries
    a zero row.

    Returns ``{"kinds", "users", "rows"}``: kinds (E,) int8 (0 = re-rate,
    1 = un-rate, 2 = delete), users (E,) int64 distinct ids, rows
    (E, n_items) float32.
    """
    if n_events > n_users:
        raise ValueError(f"n_events={n_events} > n_users={n_users}")
    rng = np.random.default_rng(np.random.SeedSequence([seed, wave, 7]))
    p = np.asarray([rerate_frac, unrate_frac, delete_frac], np.float64)
    if p.sum() <= 0:
        raise ValueError("at least one event fraction must be positive")
    p = p / p.sum()
    kinds = rng.choice(3, size=n_events, p=p).astype(np.int8)
    users = rng.choice(n_users, size=n_events, replace=False).astype(np.int64)
    rated = rng.random((n_events, n_items)) < density
    vals = np.clip(np.rint(3.0 + rng.normal(0.0, 1.2, (n_events, n_items))),
                   1, 5)
    rows = (vals * rated).astype(np.float32)
    thin = rng.random((n_events, n_items)) < 0.5
    rows[kinds == 1] *= thin[kinds == 1]
    rows[kinds == 2] = 0.0
    return {"kinds": kinds, "users": users, "rows": rows}
