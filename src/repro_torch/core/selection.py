"""The paper's five landmark selection strategies (§3.3).

All strategies return ``n`` distinct row ids (int64) into the rating block.
Popularity is deterministic; the other four draw from a ``torch.Generator``
(a CPU generator: the draws are made on the host from counts that are
exact on every device, so one seed picks the same rows on the CPU and on
the card). The reference draws from ``jax.random``, whose bits torch cannot
reproduce, so these are held to their contracts: distinct in-range ids,
determinism for a fixed seed, and the paper's cost ordering (claim C6):
Random < Dist. of Ratings < Popularity < Coresets Random < Coresets.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .topk import canonical_topk

STRATEGIES = ("random", "dist_ratings", "coresets", "coresets_random", "popularity")


def _counts(ratings: torch.Tensor) -> torch.Tensor:
    return (ratings != 0).sum(dim=1).to(torch.float32)


def _default(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def random_landmarks(generator: torch.Generator, ratings: torch.Tensor,
                     n: int) -> torch.Tensor:
    """n users uniformly at random, without replacement."""
    idx = torch.randperm(ratings.shape[0], generator=generator)[:n]
    return idx.to(ratings.device)


def dist_ratings_landmarks(generator: torch.Generator, ratings: torch.Tensor,
                           n: int) -> torch.Tensor:
    """Random, weighted by each user's number of ratings (paper: 'Dist. of
    Ratings'). Users without ratings are never picked while others remain."""
    w = _counts(ratings).cpu()
    if int((w > 0).sum()) < n:  # too few raters: floor every weight
        w = w + 1e-9
    idx = torch.multinomial(w, n, replacement=False, generator=generator)
    return idx.to(ratings.device)


def popularity_landmarks(ratings: torch.Tensor, n: int) -> torch.Tensor:
    """Top-n users by rating count, ties to the lowest id. Returns int64 ids."""
    _, idx = canonical_topk(_counts(ratings), n)
    return idx


def _coreset_rounds(n_users: int, n: int) -> int:
    """Halving schedule: the pool shrinks ~2× per round until empty."""
    return max(1, math.ceil(math.log2(max(2.0, n_users / max(n, 1)))) + 1)


def coresets_landmarks(generator: torch.Generator, ratings: torch.Tensor,
                       n: int, weighted: bool = True, sim_fn=None
                       ) -> torch.Tensor:
    """Coresets / Coresets Random (Feldman et al. 2011 flavour, paper §3.3).

    Each round samples candidates from the remaining pool (rating-count
    weighted if ``weighted``), scores every user's best d1 cosine to them
    (``sim_fn``, by default the d1 kernel's dispatcher
    ``kernels.ops.masked_similarity``), and drops the most similar half of
    the pool. The per-round sampler keeps a 1e-9 weight floor, so it can
    re-pick a dropped user once the pool runs short; the final pick
    therefore scores every user — picks a bonus decreasing in pick order,
    everyone else their normalized rating count — and takes the global
    top-n, which is n distinct ids by construction (the reference's
    duplicate-pick guarantee).
    """
    if sim_fn is None:
        from ..kernels.ops import masked_similarity as sim_fn
    dev = ratings.device
    n_users = ratings.shape[0]
    rounds = _coreset_rounds(n_users, n)
    per_round = max(1, math.ceil(n / rounds))
    counts = _counts(ratings)
    alive = torch.ones(n_users, dtype=torch.bool, device=dev)
    picked = []
    for _ in range(rounds):
        w = torch.where(alive, counts + 1.0 if weighted
                        else torch.ones_like(counts),
                        torch.zeros_like(counts)) + 1e-9
        cand = torch.multinomial(w.cpu(), per_round, replacement=False,
                                 generator=generator).to(dev)
        picked.append(cand)
        sims = sim_fn(ratings, ratings[cand], "cosine")  # (U, per_round)
        best = torch.where(alive, sims.max(dim=1).values,
                           torch.full_like(counts, float("-inf")))
        n_alive = int(alive.sum())
        kth = torch.sort(best, descending=True).values[max(n_alive // 2 - 1, 0)]
        alive = alive & ~((best >= kth) & alive)
        alive[cand] = False  # candidates leave the pool too
    picked = torch.cat(picked)
    size = picked.shape[0]
    bonus = torch.arange(size, 0, -1, dtype=torch.float32, device=dev)
    scores = counts / (counts.max() + 2.0)  # in [0, 1): below any bonus
    scores = scores.scatter_reduce(0, picked, bonus, reduce="amax")
    return canonical_topk(scores, n)[1]


def select_landmarks(ratings: torch.Tensor, n: int, strategy: str,
                     generator: Optional[torch.Generator] = None,
                     sim_fn=None) -> torch.Tensor:
    """``n`` landmark row ids of ``ratings`` under ``strategy``; the random
    strategies draw from ``generator`` (default: a CPU generator seeded 0)."""
    if strategy == "popularity":
        return popularity_landmarks(ratings, n)
    if strategy == "random":
        return random_landmarks(_default(generator), ratings, n)
    if strategy == "dist_ratings":
        return dist_ratings_landmarks(_default(generator), ratings, n)
    if strategy in ("coresets", "coresets_random"):
        return coresets_landmarks(_default(generator), ratings, n,
                                  weighted=strategy == "coresets",
                                  sim_fn=sim_fn)
    raise ValueError(f"unknown strategy {strategy!r}; expected one of {STRATEGIES}")
