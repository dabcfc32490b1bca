"""kNN rating prediction — the paper's Eq. (1), mean-centered weighted average.

    r̂_uv = ū + Σ_{u'∈N_k(u), u' rated v} s_uu' · (r_u'v − ū') / Σ |s_uu'|

Neighbors that did not rate the target item contribute nothing (their mask
zeroes both numerator and denominator terms).

- ``predict_all`` / ``predict_pairs`` take a dense (U, U) ``sims`` matrix
  and run top-k inline — the baseline path.
- ``predict_all_graph`` / ``predict_pairs_graph`` / ``recommend_topn_graph``
  take a fitted :class:`~repro_torch.core.types.NeighborGraph` — the O(U·k)
  path. Self-exclusion and <2-co-rated zeroing are baked into the graph
  weights (weight 0 contributes nothing).

The graph entry points accept an optional scalar ``n_valid``: rows
``>= n_valid`` are padding and their weights are forced to 0 before Eq. (1)
(the ``_sharded`` forms take the (S,) per-shard fills of a block-partitioned
state, the ``shard_cap`` mask);
and an optional (capacity,) bool ``tomb``: tombstoned rows (deleted users,
``mutation``) contribute nothing either, even before their citations are
repaired.

Both sums of Eq. (1) run over the k neighbors in one fixed order
(:func:`_sum_k`), never through a library reduction or batched product,
whose plan (and so its order of additions) may change with the batch
size. A row's prediction is therefore the same bits in every batch that
holds it — the request engine's bitwise-against-solo contract.
"""
from __future__ import annotations

from typing import Optional

import torch

from .topk import canonical_topk
from .types import NeighborGraph

EPS = 1e-8


def _mask_padded_rows(idx: torch.Tensor, w: torch.Tensor, n_valid,
                      tomb: Optional[torch.Tensor] = None, *,
                      shard_cap: Optional[int] = None) -> torch.Tensor:
    """Gathered neighbor weights with padded-row ids and tombstoned ids
    (``tomb[idx]``) zeroed. Operates on the (B, k) query slice only.

    With a scalar ``n_valid`` ids ``>= n_valid`` are padding. With
    ``shard_cap`` set, ``n_valid`` is the (S,) per-shard fill of a
    block-partitioned ``ShardedLandmarkState`` and id ``s*C + slot`` is
    valid iff ``slot < n_valid[s]``."""
    if tomb is not None:
        w = torch.where(tomb[idx], torch.zeros_like(w), w)
    if n_valid is None:
        return w
    if shard_cap is None:
        return torch.where(idx < n_valid, w, torch.zeros_like(w))
    fills = torch.as_tensor(n_valid, device=idx.device)
    return torch.where(idx % shard_cap < fills[idx // shard_cap], w,
                       torch.zeros_like(w))


def _gathered(graph: NeighborGraph, users: torch.Tensor, dtype):
    """(B, k) neighbor ids (int64) and weights for the query rows; compact
    graphs are widened here, after the gather. uint16 has few kernels (the
    card's advanced indexing refuses it, the CPU's ``index_select`` too),
    so compact ids are gathered as their int16 bits and masked back."""
    ids = graph.indices
    if ids.dtype == torch.uint16:
        idx = ids.view(torch.int16)[users].to(torch.int64) & 0xFFFF
    else:
        idx = ids[users].to(torch.int64)
    return idx, graph.weights[users].to(dtype)


def _center(ratings: torch.Tensor):
    """(mask, per-user means, mean-centered ratings) for Eq. (1)."""
    mask = (ratings != 0).to(ratings.dtype)
    cnt = mask.sum(dim=1)
    means = torch.where(cnt > 0, ratings.sum(dim=1) / cnt.clamp(min=1.0),
                        torch.zeros_like(cnt))
    return mask, means, (ratings - means[:, None]) * mask


def _sum_k(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 (the k neighbors) by pairwise halving after
    zero-padding k to a power of two: elementwise adds only, in an order
    fixed by k alone, so a row's sum does not depend on its batch."""
    k = x.shape[1]
    width = 1 << max(k - 1, 0).bit_length()
    if width != k:
        x = torch.cat([x, x.new_zeros((x.shape[0], width - k)
                                      + tuple(x.shape[2:]))], dim=1)
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        x = x[:, :half] + x[:, half:]
    return x[:, 0]


def _block_predict(idx, w, centered, mask, mu):
    """Eq. (1) for one user block given its (block, k) neighbor lists."""
    return _block_eq1(w, centered[idx], mask[idx], mu)


def _block_eq1(w, nb_centered, nb_mask, mu):
    """Eq. (1) over the (block, k, P) centered rows and masks of the
    neighbors."""
    num = _sum_k(w[:, :, None] * nb_centered)
    den = _sum_k(w.abs()[:, :, None] * nb_mask)
    return mu[:, None] + num / den.clamp(min=EPS)


def _topk_neighbors(sim_rows: torch.Tensor, self_idx: torch.Tensor, k: int):
    """Top-k neighbor (ids, weights) of each row, excluding the row itself."""
    rows = sim_rows.clone()
    rows[torch.arange(rows.shape[0], device=rows.device), self_idx] = float("-inf")
    vals, idx = canonical_topk(rows, k)
    return idx, torch.where(torch.isfinite(vals), vals, torch.zeros_like(vals))


def predict_all(sims: torch.Tensor, ratings: torch.Tensor, k: int = 13,
                block: int = 256) -> torch.Tensor:
    """Predict the full (U, P) matrix with the kNN rule from dense sims."""
    mask, means, centered = _center(ratings)
    out = []
    for b0 in range(0, ratings.shape[0], block):
        ids = torch.arange(b0, min(b0 + block, ratings.shape[0]),
                           device=ratings.device)
        idx, w = _topk_neighbors(sims[ids], ids, k)
        out.append(_block_predict(idx, w, centered, mask, means[ids]))
    return torch.cat(out)


def predict_all_graph(graph: NeighborGraph, ratings: torch.Tensor,
                      block: int = 256) -> torch.Tensor:
    """``predict_all`` from a NeighborGraph — no (U, U) array anywhere."""
    mask, means, centered = _center(ratings)
    out = []
    for b0 in range(0, ratings.shape[0], block):
        ids = torch.arange(b0, min(b0 + block, ratings.shape[0]),
                           device=ratings.device)
        idx, w = _gathered(graph, ids, centered.dtype)
        out.append(_block_predict(idx, w, centered, mask, means[ids]))
    return torch.cat(out)


def _pair_predict(idx, w, users, items, ratings, mask, means):
    """Eq. (1) for (B,) pairs given their (B, k) neighbor lists."""
    return _pair_eq1(w, ratings[idx, items[:, None]],
                     mask[idx, items[:, None]], means[idx], means[users])


def _pair_eq1(w, r, m, nb_means, mu):
    """Eq. (1) for (B,) pairs from the (B, k) neighbors' ratings of the
    item, their masks and means, and the users' means."""
    num = _sum_k(w * (r - nb_means) * m)
    den = _sum_k(w.abs() * m)
    return mu + num / den.clamp(min=EPS)


def predict_pairs(sims: torch.Tensor, ratings: torch.Tensor,
                  users: torch.Tensor, items: torch.Tensor, k: int = 13
                  ) -> torch.Tensor:
    """Predict only the requested (user, item) pairs from dense sims."""
    mask, means, _ = _center(ratings)
    users, items = users.to(torch.int64), items.to(torch.int64)
    idx, w = _topk_neighbors(sims[users], users, k)
    return _pair_predict(idx, w, users, items, ratings, mask, means)


def recommend_topn_graph(graph: NeighborGraph, ratings: torch.Tensor,
                         users: torch.Tensor, n: int = 10, *,
                         n_valid: Optional[int] = None,
                         tomb: Optional[torch.Tensor] = None):
    """Top-N unseen items per query user — the serve-path recommendation op.

    Scores every item with Eq. (1) from the user's neighbor list, masks
    items the user already rated, and returns ``(items, scores)`` of shape
    (B, n). Cold rows (all weights 0) fall back to the user mean. A user
    with fewer than ``n`` unrated items gets id -1 / score -inf in the
    exhausted slots — a rated item is never returned.
    """
    mask, means, centered = _center(ratings)
    users = users.to(torch.int64)
    idx, w = _gathered(graph, users, centered.dtype)
    w = _mask_padded_rows(idx, w, n_valid, tomb)
    preds = _block_predict(idx, w, centered, mask, means[users])  # (B, P)
    preds = preds.masked_fill(mask[users] > 0, float("-inf"))
    scores, items = canonical_topk(preds, n)
    items = torch.where(torch.isfinite(scores), items, torch.full_like(items, -1))
    return items.to(torch.int32), scores


def predict_pairs_graph(graph: NeighborGraph, ratings: torch.Tensor,
                        users: torch.Tensor, items: torch.Tensor, *,
                        n_valid: Optional[int] = None,
                        tomb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``predict_pairs`` from a NeighborGraph — no (U, U) array anywhere."""
    mask, means, _ = _center(ratings)
    users, items = users.to(torch.int64), items.to(torch.int64)
    idx, w = _gathered(graph, users, ratings.dtype)
    w = _mask_padded_rows(idx, w, n_valid, tomb)
    return _pair_predict(idx, w, users, items, ratings, mask, means)


# ----------------------------------------------- block-partitioned (sharded)
def _sharded_neighbors(graphs, ratings, users, n_valid, shard_cap,
                       tomb=None):
    """The read path of a block-partitioned state: the query rows' (B, k)
    neighbor lists (``tomb``- and ``shard_cap``-masked), the neighbors'
    rating rows (B, k, P) and the query rows (B, P), each row read from its
    owner shard (``distributed.sharding.gather_rows``) onto shard 0. No
    tensor of S·C rows is built: ``tomb`` is the (S·C,) bitmap on shard 0,
    read at the gathered neighbor ids only."""
    from ..distributed.sharding import gather_rows

    dst = ratings[0].device
    idx = gather_rows([g.indices for g in graphs], users, shard_cap,
                      dst).to(torch.int64)
    w = gather_rows([g.weights for g in graphs], users, shard_cap, dst)
    w = _mask_padded_rows(idx, w, n_valid, tomb, shard_cap=shard_cap)
    b, k = idx.shape
    nb = gather_rows(ratings, idx.reshape(-1), shard_cap, dst)
    return idx, w, nb.reshape(b, k, -1), gather_rows(ratings, users,
                                                     shard_cap, dst)


def predict_pairs_graph_sharded(graphs, ratings, users: torch.Tensor,
                                items: torch.Tensor, *, n_valid,
                                shard_cap: int,
                                tomb: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """``predict_pairs_graph`` on per-shard graph and rating blocks: users
    are sharded row ids, ``n_valid`` the per-shard fills, ``tomb`` the
    write path's (S·C,) tombstone bitmap (``mutation.sharded``). The
    arithmetic is the single-device path's, so the predictions are its
    bits."""
    _, w, nb, q = _sharded_neighbors(graphs, ratings, users, n_valid,
                                     shard_cap, tomb)
    b, k, p = nb.shape
    items = items.to(device=nb.device, dtype=torch.int64)
    nb_mask, nb_means, _ = _center(nb.reshape(b * k, p))
    _, mu, _ = _center(q)
    rows = torch.arange(b * k, device=nb.device)
    item_k = items.repeat_interleave(k)
    r = nb.reshape(b * k, p)[rows, item_k].reshape(b, k)
    m = nb_mask[rows, item_k].reshape(b, k)
    return _pair_eq1(w.to(nb.dtype), r, m, nb_means.reshape(b, k), mu)


def recommend_topn_graph_sharded(graphs, ratings, users: torch.Tensor,
                                 n: int = 10, *, n_valid, shard_cap: int,
                                 tomb: Optional[torch.Tensor] = None):
    """``recommend_topn_graph`` on per-shard blocks (sharded user ids and
    ``tomb``, see above)."""
    _, w, nb, q = _sharded_neighbors(graphs, ratings, users, n_valid,
                                     shard_cap, tomb)
    b, k, p = nb.shape
    nb_mask, _, nb_centered = _center(nb.reshape(b * k, p))
    q_mask, mu, _ = _center(q)
    preds = _block_eq1(w.to(nb.dtype), nb_centered.reshape(b, k, p),
                       nb_mask.reshape(b, k, p), mu)
    preds = preds.masked_fill(q_mask > 0, float("-inf"))
    scores, items = canonical_topk(preds, n)
    items = torch.where(torch.isfinite(scores), items,
                        torch.full_like(items, -1))
    return items.to(torch.int32), scores
