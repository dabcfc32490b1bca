"""Sharded IVF: posting lists beside a ``ShardedLandmarkState``.

The single-device index (``retrieval.index``) on a mesh, with the request
path's cross-shard traffic bounded to one (b, k) merge:

  layout    cells are block-partitioned shard-major over the row axes:
            shard s owns cells ``[s*C_ps, (s+1)*C_ps)``, C_ps = C/S, whose
            ``lists``/``rows``/``scale`` blocks live on its device; the
            small ``centroids`` and ``fill`` stay replicated (on shard 0).
            Posting lists store *logical* row ids, so results merge across
            shards without translation. :func:`resolve_ivf_sharded` rounds
            C up to a multiple of S.

  append    the placement plan (``index.place_plan``) is computed once on
            the replicated (fill, choices); each shard applies the writes
            that land in its cells.

  search    each query's probe list comes from the replicated centroids;
            a shard takes the probed cells it owns, local hits first,
            scores at most ``local_budget`` of them (exactly C_ps at full
            probe), keeps a local top-k, and the (S, b, k) lists merge
            canonically (value desc, id asc) on shard 0. On the card a
            shard scores with the fused probe kernel (kernel 5) on its own
            cells, masking the probes it does not own; on the CPU with the
            single-device index's plain or gathered-kernel scorers.

At full probe every shard scores its cells with the single-device
search's arithmetic and the merge is the associative form of its
canonical order, so ``search_sharded`` at ``nprobe == C`` is bitwise the
single-device ``search`` with the same scorer. Partial probes are judged
by recall, as on one device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from ..core.similarity import dense_similarity
from ..core.topk import canonical_topk
from ..core.types import round_up
from ..distributed.sharding import (cf_shard_count, ordered_sum,
                                    shard_devices)
from ..kernels import ivf_probe, ref
from ..kernels.score_candidates import score_candidates
from .index import (INT_MAX, IVFIndex, IVFSpec, _list_choices, _padded_topk,
                    dequantize_payload, place_plan, probe_cells,
                    quantize_payload, resolve_ivf, resolve_scorer)


@dataclasses.dataclass(frozen=True)
class ShardedIVFIndex:
    """An :class:`IVFIndex` with its cells block-partitioned over a mesh:
    ``lists``/``rows``/``scale`` are S blocks of C_ps cells, block s on
    shard s's device; ``centroids`` (C, n) and ``fill`` (C,) replicated on
    shard 0."""

    centroids: torch.Tensor
    lists: List[torch.Tensor]  # S x (C_ps, cap) int32 logical ids
    rows: List[torch.Tensor]  # S x (C_ps, cap, n) payload
    fill: torch.Tensor  # (C,) int32 live entries per list
    scale: Optional[List[torch.Tensor]]  # S x (C_ps, cap) int8 scales
    mesh: object
    axes: Tuple[str, ...]

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def shard_count(self) -> int:
        return len(self.lists)

    @property
    def cells_per_shard(self) -> int:
        return self.lists[0].shape[0]

    @property
    def capacity(self) -> int:
        return self.lists[0].shape[1]

    @property
    def payload_dtype(self) -> str:
        return {torch.int8: "int8", torch.bfloat16: "bf16"}.get(
            self.rows[0].dtype, "f32")

    def gathered(self) -> IVFIndex:
        """The whole index on shard 0 (for checks and tests)."""
        home = self.centroids.device

        def cat(blocks):
            return torch.cat([b.to(home) for b in blocks])

        return IVFIndex(self.centroids, cat(self.lists), cat(self.rows),
                        self.fill, None if self.scale is None
                        else cat(self.scale))


def resolve_ivf_sharded(spec: Optional[IVFSpec], u: int,
                        n_shards: int) -> IVFSpec:
    """:func:`resolve_ivf` with C rounded up to a multiple of the shard
    count, so every shard owns exactly C/S cells (the full-probe budget)."""
    base = spec or IVFSpec()
    r = resolve_ivf(base, u)
    c = round_up(r.n_clusters, max(n_shards, 1))
    t = c if base.spill_choices <= 0 else min(base.spill_choices, c)
    return dataclasses.replace(r, n_clusters=c, nprobe=min(r.nprobe, c),
                               spill_choices=t)


def shard_index(index: IVFIndex, mesh, axes) -> ShardedIVFIndex:
    """Place an index on the mesh: each shard's cells on its device, the
    quantizer and fills on shard 0."""
    if index.is_compact:
        index = index.to_full()
    s = cf_shard_count(mesh, axes)
    c = index.n_clusters
    if c % s:
        raise ValueError(f"C={c} not divisible by {s} shards; build with "
                         "resolve_ivf_sharded")
    devs = shard_devices(mesh, axes)
    per = c // s

    def split(x):
        return [x[i * per:(i + 1) * per].to(d).contiguous()
                for i, d in enumerate(devs)]

    home = devs[0]
    return ShardedIVFIndex(
        index.centroids.to(home), split(index.lists), split(index.rows),
        index.fill.to(home), None if index.scale is None
        else split(index.scale), mesh, tuple(axes))


def build_index_sharded(rep: torch.Tensor, spec: IVFSpec, mesh, axes,
                        measure: str = "cosine",
                        n_valid: Optional[int] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> ShardedIVFIndex:
    """Full (re)build and mesh placement: the k-means (kernel 4 on the
    card, one global quantizer) and the packing are the single-device
    ``build_index``, so the index is bitwise the same on any mesh; only
    its residency is sharded."""
    from .index import build_index

    return shard_index(build_index(rep, spec, measure, n_valid=n_valid,
                                   generator=generator), mesh, axes)


def ensure_index_capacity_sharded(index: ShardedIVFIndex, incoming: int,
                                  slack: float = 1.25
                                  ) -> Tuple[ShardedIVFIndex, bool]:
    """Regrow every block's slot axis before an append of ``incoming``
    rows when the fullest list could overflow (the rule of
    ``index.ensure_index_capacity``); each block grows on its own device."""
    cap = index.capacity
    top = int(index.fill.max()) if index.n_clusters else 0
    if top + incoming <= cap:
        return index, False
    new_cap = round_up(max(int((top + incoming) * slack), top + incoming), 8)

    def widen(blocks):
        return [torch.cat([x, x.new_zeros((x.shape[0], new_cap - cap)
                                          + tuple(x.shape[2:]))], dim=1)
                for x in blocks]

    return dataclasses.replace(
        index, lists=widen(index.lists), rows=widen(index.rows),
        scale=None if index.scale is None else widen(index.scale)), True


def append_sharded(index: ShardedIVFIndex, new_rep: torch.Tensor,
                   new_ids: torch.Tensor, measure: str = "cosine",
                   b_valid: Optional[int] = None,
                   spill_choices: int = 0) -> ShardedIVFIndex:
    """Masked fold-in append: the plan once on shard 0, the scatter on each
    shard for the destinations it owns. Bitwise the single-device
    ``append`` on the gathered arrays (the same ``place_plan`` call)."""
    home = index.centroids.device
    b = new_rep.shape[0]
    q = new_rep.to(home, torch.float32)
    valid = (torch.arange(b, device=home) < b_valid) if b_valid is not None \
        else torch.ones(b, dtype=torch.bool, device=home)
    c, cap, per = index.n_clusters, index.capacity, index.cells_per_shard
    t = c if spill_choices <= 0 else spill_choices
    choices = _list_choices(q, index.centroids, measure, t)
    payload, pscale = quantize_payload(q, index.payload_dtype)
    dest_c, dest_s, ok, new_fill = place_plan(index.fill, choices, valid,
                                              cap)
    ids = new_ids.to(home, torch.int32)
    lists, rows = list(index.lists), list(index.rows)
    scale = None if index.scale is None else list(index.scale)
    for s, dev in enumerate(x.device for x in index.lists):
        mine = ok & (dest_c // per == s)
        if not bool(mine.any()):
            continue
        cc = (dest_c[mine] - s * per).to(dev)
        ss = dest_s[mine].to(dev)
        lists[s] = lists[s].clone()
        lists[s][cc, ss] = ids[mine].to(dev)
        rows[s] = rows[s].clone()
        rows[s][cc, ss] = payload[mine].to(dev, rows[s].dtype)
        if scale is not None:
            scale[s] = scale[s].clone()
            scale[s][cc, ss] = pscale[mine].to(dev)
    return dataclasses.replace(index, lists=lists, rows=rows, fill=new_fill,
                               scale=scale)


def _route(probe: torch.Tensor, s: int, per: int, budget: int):
    """Shard s's slice of the replicated probe table: its own cells first
    (a stable sort keeps their probe order), the first ``budget`` ranks,
    as local cell ids (0 where not owned) and an owned mask."""
    local = (probe // per) == s
    order = torch.sort((~local).to(torch.int8), dim=1, stable=True).indices
    pr = probe.gather(1, order)[:, :budget]
    ok = local.gather(1, order)[:, :budget]
    return torch.where(ok, pr - s * per, torch.zeros_like(pr)), ok


def _merge(lists, k: int, home) -> Tuple[torch.Tensor, torch.Tensor]:
    """The canonical (value desc, id asc) merge of the shards' (b, k)
    lists on ``home``; empty slots come out as (-inf, 0)."""
    vals = torch.cat([v.to(home) for v, _ in lists], 1)
    ids = torch.cat([i.to(home, torch.int64) for _, i in lists], 1)
    ids = ids.masked_fill(torch.isneginf(vals), INT_MAX)
    mv, mi = canonical_topk(vals, k, ids=ids)
    return mv, torch.where(torch.isneginf(mv), 0, mi).to(torch.int32)


def _shard_exact(q, sids, lists, rows, scale, fill, k, measure, mode,
                 tomb=None):
    """One shard's full-probe top-k with the single-device ``search``'s
    exact path: its cells' live rows as one id-sorted candidate matrix."""
    c_ps, cap = lists.shape
    n = rows.shape[2]
    slot = torch.arange(cap, device=lists.device)
    flat = lists.reshape(-1)
    fvalid = (slot[None, :] < fill[:, None]).reshape(-1)
    order = torch.sort(torch.where(fvalid, flat, torch.full_like(
        flat, INT_MAX)), stable=True).indices
    flat, fvalid = flat[order], fvalid[order]
    cmat = dequantize_payload(rows.reshape(c_ps * cap, n)[order],
                              None if scale is None
                              else scale.reshape(-1)[order])
    sims = (ref.gathered_sims(q, cmat, measure) if mode == "plain"
            else dense_similarity(q, cmat, measure))
    invalid = (~fvalid)[None, :] | (flat[None, :] == sids[:, None])
    if tomb is not None:
        invalid = invalid | (fvalid & tomb[flat.long()])[None, :]
    return _padded_topk(sims.masked_fill(invalid, float("-inf")),
                        flat.expand(q.shape[0], -1), k)


def search_sharded(index: ShardedIVFIndex, queries: torch.Tensor, k: int,
                   nprobe: int, measure: str = "cosine", *,
                   self_ids: Optional[torch.Tensor] = None,
                   scorer: str = "auto", local_budget: Optional[int] = None,
                   tomb: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Probe-routed search: ``(vals, ids, probed)`` on shard 0.

    Each shard scores only the probed cells it owns, local hits first, at
    most ``local_budget`` ranks (default ``nprobe``: nothing dropped; at
    full probe exactly C/S). A serving caller sets ``local_budget ≈
    2·ceil(nprobe/S)`` to bound a hot shard's work; dropped cells cost
    recall like a smaller nprobe. ``probed`` (b,) counts the cells scored
    across the shards. ``scorer`` as in ``search``: ``fused`` (``auto`` on
    the card) is kernel 5 on each shard's cells with the foreign probes
    masked; ``plain``/``kernel`` score the shard's gathered candidates
    (kernel 6 for ``kernel`` at partial probe), never more than
    (b, local_budget·cap) of them. ``tomb`` masks tombstoned ids: a bool
    table indexed by the ids the posting lists hold, on shard 0 and read
    by each shard at its own candidates' ids. As on one device, a tomb
    operand makes ``fused`` give way to ``kernel`` (the fused kernel takes
    no tombstones).
    """
    c, cap, per = index.n_clusters, index.capacity, index.cells_per_shard
    nprobe = min(nprobe, c)
    full = nprobe >= c
    budget = per if full else min(local_budget or nprobe, nprobe)
    home = index.centroids.device
    b = queries.shape[0]
    q = queries.to(home, torch.float32).contiguous()
    sids = (self_ids.to(home, torch.int32) if self_ids is not None
            else torch.full((b,), -1, dtype=torch.int32, device=home))
    probe = probe_cells(index, q, nprobe, measure).long()
    lists_out, probed = [], []
    for s, dev in enumerate(x.device for x in index.lists):
        lc, ok = _route(probe, s, per, budget)
        lc, ok = lc.to(dev), ok.to(dev)
        qs, ss = q.to(dev), sids.to(dev)
        fill = index.fill[s * per:(s + 1) * per].to(dev)
        lists, rows = index.lists[s], index.rows[s]
        scale = None if index.scale is None else index.scale[s]
        probed.append(ok.sum(1).to(torch.int32))
        mode = resolve_scorer(scorer, dev)
        tomb_s = None if tomb is None else tomb.to(dev)
        if mode == "fused" and tomb is not None:
            mode = "kernel"
        if mode == "fused":
            lists_out.append(ivf_probe.fused_probe_topk(
                qs, lc.to(torch.int32), lists, rows, scale, fill, k=k,
                measure=measure, self_ids=ss, probe_ok=ok))
            continue
        if full:
            v, i = _shard_exact(qs, ss, lists, rows, scale, fill, k,
                                measure, mode, tomb_s)
        else:
            m = budget * cap
            cand = dequantize_payload(
                rows[lc].reshape(b, m, -1),
                None if scale is None else scale[lc].reshape(b, m)
            ).contiguous()
            cc = lists[lc].reshape(b, m)
            slot = torch.arange(cap, device=dev)
            live = (ok[:, :, None] & (slot[None, None, :]
                                      < fill[lc][:, :, None])).reshape(b, m)
            sims = (score_candidates(qs, cand, measure) if mode == "kernel"
                    else ref.gathered_sims(qs, cand, measure))
            bad = ~live | (cc == ss[:, None])
            if tomb_s is not None:
                bad = bad | tomb_s[cc.long()]
            v, i = _padded_topk(sims.masked_fill(bad, float("-inf")), cc, k)
        lists_out.append((v, i))
    mv, mi = _merge(lists_out, k, home)
    return mv, mi, ordered_sum(probed, home)


def search_early_exit_sharded(index: ShardedIVFIndex, queries: torch.Tensor,
                              k: int, nprobe: int, measure: str = "cosine",
                              *, self_ids: Optional[torch.Tensor] = None,
                              patience: int = 2,
                              local_budget: Optional[int] = None,
                              tomb: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Per-query early exit with :func:`search_sharded`'s routing.

    Each shard walks its own probed cells in probe order (at most
    ``local_budget`` ranks), scoring a rank's (b, cap) rows with the
    gathered-candidate scorer (kernel 6 on the card) and merging them into
    a running local top-k; a query stops on a shard once its local list
    has been unchanged for ``patience`` scored cells. ``probed`` counts
    cells scored across the shards (a foreign rank is never scored, so it
    never retires a query). The shards' lists merge canonically. With
    ``patience >= nprobe`` the result is that of the single-device
    ``search_early_exit`` on data without score ties. ``tomb`` masks
    tombstoned ids as in :func:`search_sharded`.
    """
    c, cap, per = index.n_clusters, index.capacity, index.cells_per_shard
    nprobe = min(max(nprobe, 1), c)
    patience = max(int(patience), 1)
    budget = per if nprobe >= c else min(local_budget or nprobe, nprobe)
    home = index.centroids.device
    b = queries.shape[0]
    q = queries.to(home, torch.float32).contiguous()
    sids = (self_ids.to(home, torch.int32) if self_ids is not None
            else torch.full((b,), -1, dtype=torch.int32, device=home))
    probe = probe_cells(index, q, nprobe, measure).long()
    lists_out, probed_all = [], []
    for s, dev in enumerate(x.device for x in index.lists):
        lc, ok = _route(probe, s, per, budget)
        lc, ok = lc.to(dev), ok.to(dev)
        qs, ss = q.to(dev), sids.to(dev)
        fill = index.fill[s * per:(s + 1) * per].to(dev)
        lists, rows = index.lists[s], index.rows[s]
        scale = None if index.scale is None else index.scale[s]
        tomb_s = None if tomb is None else tomb.to(dev)
        slot = torch.arange(cap, device=dev)
        vals = torch.full((b, k), float("-inf"), device=dev)
        ids = torch.zeros((b, k), dtype=torch.int32, device=dev)
        stable = torch.zeros(b, dtype=torch.int32, device=dev)
        probed = torch.zeros(b, dtype=torch.int32, device=dev)
        active = torch.ones(b, dtype=torch.bool, device=dev)
        for j in range(budget):
            cell, own = lc[:, j], ok[:, j]
            score = active & own
            cand = dequantize_payload(
                rows[cell], None if scale is None else scale[cell]
            ).contiguous()
            cc = lists[cell]
            live = slot[None, :] < fill[cell][:, None]
            sims = score_candidates(qs, cand, measure)
            dead = (live & tomb_s[cc.long()] if tomb_s is not None
                    else torch.zeros_like(live))
            sims = sims.masked_fill(~live | dead | (cc == ss[:, None])
                                    | ~score[:, None], float("-inf"))
            mv, mi = _padded_topk(torch.cat([vals, sims], 1),
                                  torch.cat([ids, cc], 1), k)
            changed = ((mv != vals) | (mi != ids)).any(dim=1)
            stable = torch.where(changed, torch.zeros_like(stable),
                                 stable + score.to(torch.int32))
            probed = probed + score.to(torch.int32)
            active = active & (stable < patience)
            vals, ids = mv, mi
        lists_out.append((vals, ids))
        probed_all.append(probed)
    mv, mi = _merge(lists_out, k, home)
    return mv, mi, ordered_sum(probed_all, home)
