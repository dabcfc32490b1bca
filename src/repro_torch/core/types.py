"""Shared containers for the memory-based CF core (PyTorch port).

The rating matrix is carried in two equivalent forms:

- COO triples ``(user_idx, item_idx, rating)`` — the data-pipeline form.
- A dense block ``R`` with 0 at missing entries plus the implied mask
  ``R != 0`` — the compute form. All similarity math is phrased as masked
  matrix products over dense user blocks.

Containers are frozen dataclasses of tensors; the device is explicit on
every constructor and defaults to the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .topk import canonical_topk


@dataclasses.dataclass(frozen=True)
class RatingMatrix:
    """Dense rating block: ``ratings[u, v] = r_uv`` or 0 if missing."""

    ratings: torch.Tensor  # (U, P) float; 0 == missing
    n_users: int
    n_items: int

    @property
    def mask(self) -> torch.Tensor:
        return (self.ratings != 0).to(self.ratings.dtype)

    def transpose(self) -> "RatingMatrix":
        """Item-based CF == user-based CF on the transposed matrix."""
        return RatingMatrix(self.ratings.T.contiguous(), self.n_items,
                            self.n_users)

    def user_means(self) -> torch.Tensor:
        """Per-user mean rating over rated items (0 for users with no ratings)."""
        cnt = self.mask.sum(dim=1)
        return torch.where(cnt > 0, self.ratings.sum(dim=1) / cnt.clamp(min=1),
                           torch.zeros_like(cnt))

    def rating_counts(self) -> torch.Tensor:
        """Per-user count of rated items, in the ratings' dtype."""
        return self.mask.sum(dim=1)

    @staticmethod
    def from_coo(
        users: np.ndarray,
        items: np.ndarray,
        ratings: np.ndarray,
        n_users: int,
        n_items: int,
        dtype=torch.float32,
        device="cuda",
    ) -> "RatingMatrix":
        """Scatter COO triples into a dense block on ``device`` (raises when
        that device is absent — there is no fallback)."""
        dense = np.zeros((n_users, n_items), dtype=np.float32)
        dense[users, items] = ratings
        return RatingMatrix(torch.as_tensor(dense, dtype=dtype, device=device),
                            n_users, n_items)


@dataclasses.dataclass(frozen=True)
class NeighborGraph:
    """Sparse per-row top-k neighborhood — the consumable CF artifact.

    ``indices[u]`` are the ids of u's k most similar rows (self excluded at
    construction); ``weights[u]`` the matching similarities, with 0 stored
    for invalid slots (< 2 co-rated items, rows with fewer than k valid
    neighbors). Lists are in canonical order: weight descending, then id
    ascending.
    """

    indices: torch.Tensor  # (U, k) int32 neighbor row ids
    weights: torch.Tensor  # (U, k) float similarity weights; 0 == no contribution

    @property
    def n_nodes(self) -> int:
        return self.indices.shape[0]

    @property
    def k(self) -> int:
        return self.indices.shape[1]

    @property
    def is_compact(self) -> bool:
        return (self.indices.dtype != torch.int32
                or self.weights.dtype != torch.float32)

    def to_compact(self) -> "NeighborGraph":
        """Halve the artifact: uint16 ids + bf16 weights (U < 65536)."""
        if self.n_nodes > 65535:
            raise ValueError(
                f"compact ids are uint16: U={self.n_nodes} exceeds 65535")
        return NeighborGraph(self.indices.to(torch.uint16),
                             self.weights.to(torch.bfloat16))

    def to_full(self) -> "NeighborGraph":
        """Widen back to the canonical int32 ids + f32 weights."""
        return NeighborGraph(self.indices.to(torch.int32),
                             self.weights.to(torch.float32))

    def remap(self, table: torch.Tensor) -> "NeighborGraph":
        """Rewrite neighbor ids through an old-id → new-id ``table`` (the
        row space re-ordered: tombstone compaction in ``mutation``). Inert
        (0, 0.0) slots stay (0, 0.0) even when old row 0 moved; weights are
        untouched (similarities are row-pair-local)."""
        inert = (self.indices == 0) & (self.weights == 0)
        mapped = table[self.indices.long()].to(self.indices.dtype)
        return NeighborGraph(torch.where(inert, torch.zeros_like(mapped),
                                         mapped), self.weights)

    @staticmethod
    def from_dense_sims(sims: torch.Tensor, k: int, exclude_self: bool = True
                        ) -> "NeighborGraph":
        """Top-k reduction of a dense (U, U) similarity matrix: self is
        masked to -inf before the top-k, and non-finite values become zero
        weights."""
        u = sims.shape[0]
        if exclude_self:
            eye = torch.eye(u, dtype=torch.bool, device=sims.device)
            sims = sims.masked_fill(eye, float("-inf"))
        vals, idx = canonical_topk(sims, min(k, u))
        ok = torch.isfinite(vals)
        return NeighborGraph(idx.to(torch.int32),
                             torch.where(ok, vals, torch.zeros_like(vals)))


@dataclasses.dataclass(frozen=True)
class LandmarkSpec:
    """Parameters of the landmark reduction (paper §3)."""

    n_landmarks: int = 20
    selection: str = "popularity"  # random|dist_ratings|coresets|coresets_random|popularity
    d1: str = "cosine"  # user-landmark measure (Algorithm 2 family)
    d2: str = "cosine"  # landmark-space measure (Algorithm 4 family)
    k_neighbors: int = 13  # paper §4.4
    mode: str = "user"  # user|item based CF
    graph_backend: str = "auto"  # dense|streaming|kernel|auto (core.graph)


def pad_to(x: torch.Tensor, size: int, axis: int = 0) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` up to ``size``."""
    pad = size - x.shape[axis]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult
