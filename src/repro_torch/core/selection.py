"""Landmark selection (paper §3.3).

Only the deterministic strategy, popularity, is ported so far. The four
random or iterative strategies draw from ``jax.random`` in the reference,
whose bits torch cannot reproduce; they come with the lifecycle slice,
tested on their contracts.
"""
from __future__ import annotations

import torch

from .topk import canonical_topk

STRATEGIES = ("random", "dist_ratings", "coresets", "coresets_random", "popularity")


def _counts(ratings: torch.Tensor) -> torch.Tensor:
    return (ratings != 0).sum(dim=1).to(torch.float32)


def popularity_landmarks(ratings: torch.Tensor, n: int) -> torch.Tensor:
    """Top-n users by rating count, ties to the lowest id. Returns int64 ids."""
    _, idx = canonical_topk(_counts(ratings), n)
    return idx


def select_landmarks(ratings: torch.Tensor, n: int, strategy: str
                     ) -> torch.Tensor:
    """``n`` landmark row ids of ``ratings`` under ``strategy``."""
    if strategy == "popularity":
        return popularity_landmarks(ratings, n)
    if strategy in STRATEGIES:
        raise NotImplementedError(
            f"landmark selection {strategy!r} is ported with the lifecycle "
            f"slice; only 'popularity' is available")
    raise ValueError(f"unknown strategy {strategy!r}; expected one of {STRATEGIES}")
