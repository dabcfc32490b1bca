"""Synthetic inputs: LM token batches, GNN graphs, recsys batches, the CF
lifecycle's arrival stream and the write path's mutation events.

Numpy copies of the reference's ``lm_batch``, ``random_graph``,
``NeighborSampler``, ``sampled_block``, ``molecule_batch``,
``fm_train_batch``, ``seq_rec_batch``, ``drifting_ratings`` and
``mutation_events``: deterministic in
``(seed, step)`` / ``(seed, wave)``, so one seed gives byte-identical
arrays in both packages.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

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


# ------------------------------------------------------------------------ GNN
def random_graph(
    seed: int,
    n_nodes: int,
    n_edges: int,
    d_feat: int,
    n_classes: int,
    pad_edges_to: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Power-law graph (preferential-attachment-ish degree distribution)."""
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, n_nodes + 1) ** 0.7
    w /= w.sum()
    src = rng.choice(n_nodes, size=n_edges, p=w).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    e_pad = pad_edges_to or n_edges
    mask = np.zeros(e_pad, np.float32)
    mask[:n_edges] = 1.0
    pad = e_pad - n_edges
    return {
        "node_feats": rng.normal(0, 1, (n_nodes, d_feat)).astype(np.float32),
        "edge_src": np.pad(src, (0, pad)),
        "edge_dst": np.pad(dst, (0, pad)),
        "edge_mask": mask,
        "labels": rng.integers(0, n_classes, n_nodes).astype(np.int32),
    }


class NeighborSampler:
    """Uniform fanout sampler over a CSR adjacency (GraphSAGE-style).

    Produces the sampled block for ``minibatch_lg``: seed nodes + their k-hop
    sampled neighborhood as a padded edge list over *local* node ids."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n_nodes: int):
        order = np.argsort(dst, kind="stable")
        self.sorted_src = src[order]
        self.indptr = np.zeros(n_nodes + 1, np.int64)
        counts = np.bincount(dst, minlength=n_nodes)
        self.indptr[1:] = np.cumsum(counts)
        self.n_nodes = n_nodes

    def sample(
        self, seed_nodes: np.ndarray, fanouts: Tuple[int, ...], rng: np.random.Generator
    ) -> Dict[str, np.ndarray]:
        """Returns local-id edge arrays + the global ids of every local node."""
        nodes = list(seed_nodes)
        local = {int(n): i for i, n in enumerate(seed_nodes)}
        srcs, dsts = [], []
        frontier = seed_nodes
        for fan in fanouts:
            nxt = []
            for nd in frontier:
                lo, hi = self.indptr[nd], self.indptr[nd + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = rng.integers(lo, hi, size=min(fan, deg))
                for s in self.sorted_src[take]:
                    s = int(s)
                    if s not in local:
                        local[s] = len(nodes)
                        nodes.append(s)
                        nxt.append(s)
                    srcs.append(local[s])
                    dsts.append(local[int(nd)])
            frontier = np.asarray(nxt, np.int64) if nxt else np.empty(0, np.int64)
        return {
            "global_ids": np.asarray(nodes, np.int64),
            "edge_src": np.asarray(srcs, np.int32),
            "edge_dst": np.asarray(dsts, np.int32),
        }


def sampled_block(
    seed: int,
    step: int,
    n_total_nodes: int,
    batch_nodes: int,
    fanouts: Tuple[int, ...],
    d_feat: int,
    n_classes: int,
    pad_nodes: int,
    pad_edges: int,
) -> Dict[str, np.ndarray]:
    """Shape-stable sampled subgraph batch (padded to fixed sizes for jit)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # Synthetic power-law neighborhood sizes (a real deployment would hold the
    # CSR in host RAM; see NeighborSampler above, exercised in tests).
    n_sub = batch_nodes
    srcs, dsts = [], []
    frontier = np.arange(batch_nodes)
    for fan in fanouts:
        deg = rng.integers(1, fan + 1, size=len(frontier))
        new = np.arange(n_sub, n_sub + int(deg.sum()))
        rep = np.repeat(frontier, deg)
        srcs.append(new)
        dsts.append(rep)
        n_sub += len(new)
        frontier = new
        if n_sub > pad_nodes - batch_nodes * fan:
            break
    src = np.concatenate(srcs)[: pad_edges]
    dst = np.concatenate(dsts)[: pad_edges]
    n_edges = len(src)
    n_sub = min(n_sub, pad_nodes)
    mask = np.zeros(pad_edges, np.float32)
    mask[:n_edges] = 1.0
    labels = np.full(pad_nodes, -1, np.int32)
    labels[:batch_nodes] = rng.integers(0, n_classes, batch_nodes)
    return {
        "node_feats": rng.normal(0, 1, (pad_nodes, d_feat)).astype(np.float32),
        "edge_src": np.pad(src, (0, pad_edges - n_edges)).astype(np.int32),
        "edge_dst": np.pad(dst, (0, pad_edges - n_edges)).astype(np.int32),
        "edge_mask": mask,
        "labels": labels,
    }


def molecule_batch(
    seed: int, step: int, batch: int, n_nodes: int, n_edges: int, d_feat: int
) -> Dict[str, np.ndarray]:
    """Batched small graphs as one block-diagonal graph + graph_ids pooling."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    total_n, total_e = batch * n_nodes, batch * n_edges
    offs = np.repeat(np.arange(batch) * n_nodes, n_edges)
    src = (rng.integers(0, n_nodes, total_e) + offs).astype(np.int32)
    dst = (rng.integers(0, n_nodes, total_e) + offs).astype(np.int32)
    return {
        "node_feats": rng.normal(0, 1, (total_n, d_feat)).astype(np.float32),
        "edge_src": src,
        "edge_dst": dst,
        "edge_mask": np.ones(total_e, np.float32),
        "graph_ids": np.repeat(np.arange(batch), n_nodes).astype(np.int32),
        "n_graphs": batch,
        "targets": rng.normal(0, 1, batch).astype(np.float32),
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


# --------------------------------------------------------------------- recsys
def fm_train_batch(seed, step, batch, field_vocabs) -> Dict[str, np.ndarray]:
    """FM click batch: one id per field (uniform in the field, offset into
    the shared table) and a 0/1 label."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    offsets = np.concatenate([[0], np.cumsum(field_vocabs)[:-1]])
    ids = np.stack(
        [rng.integers(0, v, batch) + o for v, o in zip(field_vocabs, offsets)],
        axis=1).astype(np.int32)
    return {"field_ids": ids,
            "labels": rng.integers(0, 2, batch).astype(np.int32)}


def seq_rec_batch(seed, step, batch, seq_len, n_items, n_mask=0,
                  n_negatives=0) -> Dict[str, np.ndarray]:
    """History batch for BERT4Rec/MIND/DIEN (Zipf item popularity: item
    ⌊u^(-1/1.2) - 1⌋, so item 0 takes 56.5% of the ids)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    u = rng.random((batch, seq_len))
    items = (np.minimum(u ** (-1.0 / 1.2) - 1.0, n_items - 1) % n_items
             ).astype(np.int32)
    out: Dict[str, np.ndarray] = {"item_ids": items}
    out["targets"] = rng.integers(0, n_items, batch).astype(np.int32)
    out["labels"] = rng.integers(0, 2, batch).astype(np.int32)
    if n_mask:
        out["mask_positions"] = np.sort(
            rng.integers(0, seq_len, (batch, n_mask)), axis=1
        ).astype(np.int32)
        out["targets"] = rng.integers(0, n_items, (batch, n_mask)
                                      ).astype(np.int32)
    if n_negatives:
        out["negatives"] = rng.integers(0, n_items, n_negatives
                                        ).astype(np.int32)
    return out
