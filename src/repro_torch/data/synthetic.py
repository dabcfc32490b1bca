"""Synthetic inputs: LM token batches and the CF lifecycle's arrival
stream.

Numpy copies of the reference's ``lm_batch`` and ``drifting_ratings``:
deterministic in ``(seed, step)`` / ``(seed, wave)``, so one seed gives
byte-identical arrays in both packages.
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
