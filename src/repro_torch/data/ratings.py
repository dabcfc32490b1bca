"""Synthetic rating data matched to the paper's Table 1 statistics.

A numpy copy of the reference's generator: the same seed gives
byte-identical arrays in both packages.

Raw MovieLens/Netflix are not redistributable in this container, so §Repro
validates the paper's *claims* on synthetic matrices with the same shape,
sparsity and a realistic generative structure:

    r_uv = clip(round(mu + b_u + b_v + p_u·q_v + noise), 1, 5)

with power-law user/item activity (so Popularity/Dist.-of-Ratings selection has
signal to exploit, as in real data). Observation probability follows the
item/user activity product — heavier users rate more, popular items are rated
more — reproducing the long-tail co-rating structure the paper relies on.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..core.types import RatingMatrix

# Paper Table 1.
DATASETS = {
    "movielens100k": dict(n_ratings=100_000, n_users=943, n_items=1_682),
    "netflix100k": dict(n_ratings=100_000, n_users=1_490, n_items=2_380),
    "movielens1m": dict(n_ratings=1_000_000, n_users=6_040, n_items=3_952),
    "netflix1m": dict(n_ratings=1_000_000, n_users=8_782, n_items=4_577),
}


@dataclasses.dataclass(frozen=True)
class RatingData:
    users: np.ndarray  # (N,) int32
    items: np.ndarray  # (N,) int32
    ratings: np.ndarray  # (N,) float32 in {1..5}
    n_users: int
    n_items: int

    def to_matrix(self, subset=slice(None), device="cuda") -> RatingMatrix:
        return RatingMatrix.from_coo(
            self.users[subset], self.items[subset], self.ratings[subset],
            self.n_users, self.n_items, device=device,
        )

    @property
    def n_ratings(self) -> int:
        return len(self.ratings)


def synthesize(
    name: str = "movielens100k",
    seed: int = 0,
    latent_dim: int = 8,
    noise: float = 0.6,
) -> RatingData:
    cfg = DATASETS[name]
    n_users, n_items, n_ratings = cfg["n_users"], cfg["n_items"], cfg["n_ratings"]
    rng = np.random.default_rng(seed)

    # Power-law activity (Zipf-ish), normalized to probability vectors.
    u_act = (1.0 / np.arange(1, n_users + 1) ** 0.8)
    i_act = (1.0 / np.arange(1, n_items + 1) ** 0.9)
    rng.shuffle(u_act), rng.shuffle(i_act)
    u_p, i_p = u_act / u_act.sum(), i_act / i_act.sum()

    # Sample observed (user, item) cells without replacement via flat indices.
    target = min(n_ratings, n_users * n_items // 2)
    seen: dict = {}
    users = np.empty(target, np.int64)
    items = np.empty(target, np.int64)
    got = 0
    while got < target:
        take = int((target - got) * 1.5) + 16
        uu = rng.choice(n_users, size=take, p=u_p)
        ii = rng.choice(n_items, size=take, p=i_p)
        flat = uu * n_items + ii
        for f, u, i in zip(flat, uu, ii):
            if f not in seen:
                seen[f] = True
                users[got], items[got] = u, i
                got += 1
                if got == target:
                    break

    mu = 3.6
    b_u = rng.normal(0, 0.35, n_users)
    b_v = rng.normal(0, 0.35, n_items)
    p = rng.normal(0, 1.0 / np.sqrt(latent_dim), (n_users, latent_dim))
    q = rng.normal(0, 1.0, (n_items, latent_dim))
    raw = mu + b_u[users] + b_v[items] + np.einsum("nd,nd->n", p[users], q[items])
    raw = raw + rng.normal(0, noise, target)
    vals = np.clip(np.rint(raw), 1, 5).astype(np.float32)
    order = rng.permutation(target)  # chronological-cut emulation = random here
    return RatingData(
        users[order].astype(np.int32),
        items[order].astype(np.int32),
        vals[order],
        n_users,
        n_items,
    )


def kfold_split(data: RatingData, fold: int, n_folds: int = 10, seed: int = 1):
    """Paper protocol: 10-fold CV over ratings. Returns (train, test) index arrays."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(data.n_ratings)
    folds = np.array_split(perm, n_folds)
    test = folds[fold]
    train = np.concatenate([folds[i] for i in range(n_folds) if i != fold])
    return train, test


def mae(preds: np.ndarray, truth: np.ndarray) -> float:
    return float(np.mean(np.abs(np.asarray(preds) - np.asarray(truth))))
