"""GatedGCN (Bresson & Laurent 2017; Dwivedi benchmark arXiv:2003.00982),
the reference's ``repro.models.gnn`` in PyTorch.

Update rule (edge-gated, with residuals; LayerNorm in place of BatchNorm,
as the reference has it):

    ê_ij = C e_ij + D h_i + E h_j ;  e_ij' = e_ij + ReLU(LN(ê_ij))
    η_ij = σ(ê_ij) / (Σ_{j'→i} σ(ê_ij') + ε)
    h_i' = h_i + ReLU(LN(U h_i + Σ_{j→i} η_ij ⊙ (V h_j)))

Message passing runs on ``kernels/segment_sum.py``: every gather by
``edge_src`` or ``edge_dst`` is a ``Gather`` and every sum into nodes a
``SegmentSum``, both over CSRs built once per
batch, so the forward and the backward add in one fixed order on the card
(the library's scatter-adds use atomics). A node-task layer launches the
kernel 2 times in its forward (the denominator and the aggregate) and 4 in
its backward (the gathers of hv and he by source, of hd and the
denominator by destination); with remat the forward runs twice.

On one device the reference's ``constrain`` calls (sharding annotations,
``gnn.py:117-119,138``) are no-ops. The mesh form
(:func:`gnn_forward_sharded`) is the reference's ``shard_map`` form on the
port's single-process mesh (``launch/mesh.py``).

Over a mesh of ranks (DTensor node features, edge arrays and parameters,
placed by :func:`param_logical` and ``launch/steps.py``) each rank holds
a block of nodes (``batch``: over ``pod`` and ``data``) and a block of
edges (``edge``: over every axis), and builds its CSRs from its own edge
block. Every gather by an edge index is a ``Gather`` and every sum into
nodes a ``SegmentSum`` on the rank's blocks (``local_map``), so the
kernel runs per rank in both directions. Two forms (:func:`gnn_forward`
with ``comm``):

- the base form, the reference's GSPMD step: each projection of h
  (node-sharded, or cast to ``comm_dtype`` first, as the reference pins
  it) is all-gathered for the edges' gathers; each rank's segment sums
  over all N nodes are partial sums, reduced over every axis (the
  denominator whole, the aggregate onto the node blocks: the reference's
  ``constrain`` of h);
- ``comm``, the reference's ``shard_map`` form (``gnn.py:185-270``) over
  the ranks: one bf16 all-gather of h a layer, edges dst-partitioned
  (:func:`dst_partition`: an edge lives with its destination's node
  block), each rank's bf16 segment sums within its owner's block added
  over ``model`` (the ``denom`` and ``agg`` psums). Its gradient is the
  autograd gradient of that forward.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import (all_gather_rows, cf_row_axes,
                                    cf_shard_count, filter_rules,
                                    ordered_sum, placements, shard_devices,
                                    spec_for, zeros_rows)
from ..kernels import ops  # noqa: F401  (first: it imports every wrapper)
from ..kernels.segment_sum import CSR, build_csr, gather, seg_sum

LAYER_MATS = ("U", "V", "C", "D", "E")
LAYER_NORMS = ("ln_h", "ln_e")
WIRE = torch.bfloat16  # the mesh form's all-gather and partial sums


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    """The reference's fields that change results. ``comm_dtype`` (e.g.
    ``torch.bfloat16``) casts the node→edge gathers and the edge→node
    sums, the reference's wire format. The reference's ``scan_unroll``
    only unrolls an XLA scan, which torch has no counterpart for: left
    out."""

    name: str
    n_layers: int = 16
    d_hidden: int = 70
    d_feat: int = 1433
    n_classes: int = 7
    task: str = "node"  # node | graph (molecule regression)
    dtype: torch.dtype = torch.float32
    comm_dtype: Optional[torch.dtype] = None


def gnn_logical(cfg: GNNConfig):
    """The reference's logical axes of the stacked parameter tree: every
    weight replicated (the GNN shards its nodes and edges)."""
    lin, vec = ("layers", "null", "null"), ("layers", "null")
    return {"embed_w": ("null", "null"), "embed_b": ("null",),
            "layers": {**{k: lin for k in LAYER_MATS},
                       **{k: vec for k in LAYER_NORMS}},
            "head_w": ("null", "null"), "head_b": ("null",)}


def param_logical(cfg: GNNConfig) -> Dict[str, tuple]:
    """Logical axes by ``named_parameters()`` name (layer i's
    ``layers.{i}.{name}``: the stacked tuple without ``"layers"``)."""
    tree = gnn_logical(cfg)
    out = {k: v for k, v in tree.items() if k != "layers"}
    for i in range(cfg.n_layers):
        for name, la in tree["layers"].items():
            out[f"layers.{i}.{name}"] = la[1:]
    return out


class GNNLayer(nn.Module):
    """One layer's parameters: U, V, C, D, E (H, H), ln_h, ln_e (H,)."""

    def __init__(self, cfg: GNNConfig, device="cuda"):
        super().__init__()
        h = cfg.d_hidden
        for name in LAYER_MATS:
            self.register_parameter(name, nn.Parameter(torch.zeros(
                (h, h), dtype=cfg.dtype, device=device)))
        for name in LAYER_NORMS:
            self.register_parameter(name, nn.Parameter(torch.ones(
                (h,), dtype=cfg.dtype, device=device)))


class GatedGCN(nn.Module):
    """The GNN's parameters: ``embed_w`` (d_feat, H), ``embed_b`` (H,),
    ``layers`` (a ``ModuleList`` of :class:`GNNLayer`), ``head_w`` (H,
    n_classes), ``head_b``. ``train/optimizer.py::stacks`` gathers
    ``layers.{i}.{name}`` into the reference's stacked tree."""

    def __init__(self, cfg: GNNConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        h, dt = cfg.d_hidden, cfg.dtype

        def zeros(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dt, device=device))

        self.embed_w = zeros(cfg.d_feat, h)
        self.embed_b = zeros(h)
        self.layers = nn.ModuleList(GNNLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.head_w = zeros(h, cfg.n_classes)
        self.head_b = zeros(cfg.n_classes)


def init_gnn(cfg: GNNConfig, generator: Optional[torch.Generator] = None,
             device="cuda") -> GatedGCN:
    """Random weights N(0, 1/fan_in) drawn from ``generator`` (on its own
    device, then moved) in the reference's order — embed_w, then U, V, C,
    D, E each as an (L, H, H) stack, then head_w — cast to ``cfg.dtype``;
    biases 0, norm scales 1. The draws cannot reproduce ``jax.random``:
    parity with the reference goes through ``models.convert``."""
    generator = generator or torch.Generator().manual_seed(0)
    model = GatedGCN(cfg, device)

    def draw(shape, fan_in):
        return torch.randn(shape, generator=generator,
                           device=generator.device) / np.sqrt(fan_in)

    h = cfg.d_hidden
    with torch.no_grad():
        model.embed_w.copy_(draw((cfg.d_feat, h), cfg.d_feat))
        for name in LAYER_MATS:
            stack = draw((cfg.n_layers, h, h), h)
            for lp, w in zip(model.layers, stack):
                getattr(lp, name).copy_(w)
        model.head_w.copy_(draw((h, cfg.n_classes), h))
    return model


def _ln(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The reference's ``_ln``: (x − μ) · rsqrt(var + 1e-5) · scale."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale


def _edge_update(e, lp, src_v, hd_dst, he_src, emask):
    """e' and the masked gate σ(ê)·mask of one layer (``gnn.py:120-127``)."""
    e_hat = e @ lp.C + hd_dst + he_src
    e_new = e + torch.relu(_ln(e_hat, lp.ln_e))
    return e_new, torch.sigmoid(e_hat) * emask


def _layer(h, e, lp: GNNLayer, src: CSR, dst: CSR, emask, cfg: GNNConfig):
    """One GatedGCN layer on one device (``gnn.py:107-139``)."""
    dt, cd = cfg.dtype, cfg.comm_dtype
    hu, hv, hd, he = (h @ getattr(lp, name) for name in "UVDE")
    if cd is not None:  # node→edge gathers move comm_dtype on the wire
        hv, hd, he = hv.to(cd), hd.to(cd), he.to(cd)
    src_v = gather(hv, src).to(dt)
    e_new, gate = _edge_update(e, lp, src_v, gather(hd, dst).to(dt),
                               gather(he, src).to(dt), emask)
    gsum = gate.to(cd) if cd is not None else gate
    denom = seg_sum(gsum, dst).to(dt) + 1e-6
    eta = gate / gather(denom, dst)
    msg = eta * src_v * emask
    if cd is not None:  # edge→node sums in comm_dtype
        msg = msg.to(cd)
    agg = seg_sum(msg, dst).to(dt)
    return h + torch.relu(_ln(hu + agg, lp.ln_h)), e_new


def gnn_forward(model: GatedGCN, node_feats: torch.Tensor,
                edge_src: torch.Tensor, edge_dst: torch.Tensor,
                edge_mask: torch.Tensor,
                graph_ids: Optional[torch.Tensor] = None,
                n_graphs: int = 0, rules=None,
                comm: bool = False) -> torch.Tensor:
    """(N, n_classes) logits, or (n_graphs, n_classes) with ``graph_ids``
    (mean-pooled readout). Padded edges point at node 0 with mask 0; the
    CSRs by source and destination are built once here and serve every
    layer, its recompute and the backward. With grad enabled each layer
    runs under ``torch.utils.checkpoint``: only its input is kept. DTensor
    inputs run over their mesh of ranks by ``rules`` (the base form, or
    with ``comm`` the ``shard_map`` form): :func:`_forward_ranks`."""
    if isinstance(node_feats, DTensor):
        return _forward_ranks(model, node_feats, edge_src, edge_dst,
                              edge_mask, graph_ids, n_graphs, rules, comm)
    if comm:
        raise ValueError("gnn_forward: the comm form runs over a mesh of "
                         "ranks (DTensor inputs), or gnn_forward_sharded")
    cfg = model.cfg
    n = node_feats.shape[0]
    src = build_csr(edge_src, n, edge_mask)
    dst = build_csr(edge_dst, n, edge_mask)
    h = node_feats.to(cfg.dtype) @ model.embed_w + model.embed_b
    e = torch.zeros((edge_src.shape[0], cfg.d_hidden), dtype=cfg.dtype,
                    device=h.device)
    emask = edge_mask[:, None].to(cfg.dtype)
    remat = torch.is_grad_enabled()
    for lp in model.layers:
        if remat:  # the reference's jax.checkpoint(..., nothing_saveable)
            h, e = checkpoint(_layer, h, e, lp, src, dst, emask, cfg,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            h, e = _layer(h, e, lp, src, dst, emask, cfg)
    if cfg.task == "graph":
        graphs = build_csr(graph_ids, n_graphs)
        pooled = seg_sum(h, graphs)
        cnt = seg_sum(torch.ones((n, 1), dtype=cfg.dtype, device=h.device),
                      graphs)
        h = pooled / torch.clamp_min(cnt, 1.0)
    return h @ model.head_w + model.head_b


def _nll_parts(logits: torch.Tensor, labels: torch.Tensor):
    """(−Σ log softmax at the labels, the number of labels), labels < 0
    masked. The label's term is a one-hot contraction, the sum of one
    value and zeros (exact), whose backward is no scatter: a gather's
    would add on the card with atomics."""
    labels = labels.long()
    mask = (labels >= 0).float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    classes = torch.arange(logp.shape[-1], device=logp.device)
    onehot = (labels.clamp_min(0)[:, None] == classes).to(logp.dtype)
    ll = (logp * onehot).sum(-1)
    return -(ll * mask).sum(), mask.sum()


def _node_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked mean of −log softmax at the labels (labels < 0 masked). On a
    mesh each rank sums its node block's, and the sums are added over the
    node axes."""
    if isinstance(logits, DTensor):
        from torch.distributed.tensor.experimental import local_map

        dm, pl = logits.device_mesh, tuple(logits.placements)
        summed = tuple(Partial() if p == Shard(0) else Replicate()
                       for p in pl)
        nll, cnt = local_map(_nll_parts, out_placements=(summed, summed),
                             in_placements=(pl, pl),
                             in_grad_placements=(pl, pl), device_mesh=dm,
                             redistribute_inputs=True)(logits, labels)
    else:
        nll, cnt = _nll_parts(logits, labels)
    return nll / torch.clamp_min(cnt, 1.0)


def gnn_loss(model: GatedGCN, batch: Dict[str, torch.Tensor], rules=None,
             comm: bool = False) -> torch.Tensor:
    """The node task's masked cross-entropy, or the graph task's MSE of
    the first logit against ``targets``; on a mesh of ranks by ``rules``
    (``comm``: the ``shard_map`` form)."""
    logits = gnn_forward(model, batch["node_feats"], batch["edge_src"],
                         batch["edge_dst"], batch["edge_mask"],
                         graph_ids=batch.get("graph_ids"),
                         n_graphs=int(batch.get("n_graphs", 0)),
                         rules=rules, comm=comm)
    if model.cfg.task == "graph":  # regression (ZINC-style)
        return torch.mean((logits[..., 0] - batch["targets"]) ** 2)
    return _node_loss(logits, batch["labels"])


# ---------------------------------------------------------------------------
# Over a mesh of ranks: each rank's node and edge blocks (DTensor).
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _RankEdges:
    """A rank's edge block over a ``DeviceMesh`` and the placements the
    layers move between."""

    mesh: Any
    rep: tuple  # replicated
    node_pl: tuple  # (N, ·) node blocks
    edge_pl: tuple  # (E, ·) edge blocks
    part_pl: tuple  # a sum of every rank's edges: partial where split
    owner_pl: tuple  # comm: node blocks, partial over an owner's ranks
    src: CSR  # by source over all N nodes
    dst: CSR  # by destination over all N nodes
    local: Optional[CSR]  # comm: by destination within the owner's block
    emask: torch.Tensor  # (E, 1) DTensor


def _placed(x, dm, pl) -> DTensor:
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == tuple(pl) else x.redistribute(
            dm, pl)
    return DTensor.from_local(x, dm, pl, run_check=False)


def _rank_edges(feats: DTensor, edge_src, edge_dst, edge_mask, rules,
                comm: bool, dtype) -> _RankEdges:
    dm = feats.device_mesh
    r = filter_rules(rules, dm)
    edge_pl = placements(spec_for(("edge",), r), dm)
    node_pl = tuple(feats.placements)
    rep = (Replicate(),) * dm.ndim
    part_pl = tuple(Partial() if p == Shard(0) else Replicate()
                    for p in edge_pl)
    owner_pl = tuple(n if n == Shard(0) else e
                     for n, e in zip(node_pl, part_pl))
    src, dst, mask = (_placed(x, dm, edge_pl).to_local()
                      for x in (edge_src, edge_dst, edge_mask))
    n = feats.shape[0]
    local = None
    if comm:
        blocks = [i for i, p in enumerate(node_pl) if p == Shard(0)]
        if not blocks or n % math.prod(int(dm.mesh.shape[i]) for i in blocks):
            raise ValueError(f"gnn comm form: {n} nodes do not split into "
                             f"equal blocks over {node_pl}")
        coord, owner = dm.get_coordinate(), 0
        for i in blocks:
            owner = owner * dm.mesh.shape[i] + coord[i]
        n_local = feats.to_local().shape[0]
        dst_l = dst.long() - owner * n_local
        owned = (dst_l >= 0) & (dst_l < n_local)
        mask = mask * owned.to(mask.dtype)  # off-block destinations
        local = build_csr(dst_l.clamp(0, n_local - 1), n_local, mask)
    emask = DTensor.from_local(mask[:, None].to(dtype), dm, edge_pl,
                               run_check=False)
    return _RankEdges(dm, rep, node_pl, edge_pl, part_pl, owner_pl,
                      build_csr(src, n, mask), build_csr(dst, n, mask),
                      local, emask)


def _on_ranks(fn, x, in_pl, out_pl, grad_pl, dm):
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=(out_pl,), in_placements=(in_pl,),
                     in_grad_placements=(grad_pl,), device_mesh=dm,
                     redistribute_inputs=True)(x)


def _to_edges(x: DTensor, csr: CSR, ed: _RankEdges, in_pl=None,
              grad_pl=None) -> DTensor:
    """``x[index]`` at the rank's edges: ``x`` (N, H) gathered whole (or
    in ``in_pl``), its gradient a partial sum of every rank's edges."""
    return _on_ranks(lambda t: gather(t, csr), x, in_pl or ed.rep,
                     ed.edge_pl, grad_pl or ed.part_pl, ed.mesh)


def _to_nodes(m: DTensor, csr: CSR, ed: _RankEdges, out_pl) -> DTensor:
    """The rank's edges' segment sums over ``csr``'s nodes, a partial sum
    (``out_pl``)."""
    return _on_ranks(lambda t: seg_sum(t, csr), m, ed.edge_pl, out_pl,
                     ed.edge_pl, ed.mesh)


def _layer_ranks(h, e, lp: GNNLayer, ed: _RankEdges, cfg: GNNConfig,
                 comm: bool):
    """One layer over the ranks (the base form, or the ``comm`` form)."""
    dt, cd, dm = cfg.dtype, cfg.comm_dtype, ed.mesh
    hu = h @ lp.U
    if comm:  # one bf16 all-gather of h
        h_full = h.to(WIRE).redistribute(dm, ed.rep).to(dt)
        hv, hd, he = (h_full @ getattr(lp, name) for name in "VDE")
    else:  # the projections gathered, in comm_dtype when it is set
        hv, hd, he = (h @ getattr(lp, name) for name in "VDE")
        if cd is not None:
            hv, hd, he = hv.to(cd), hd.to(cd), he.to(cd)
    src_v = _to_edges(hv, ed.src, ed).to(dt)
    e_new, gate = _edge_update(e, lp, src_v, _to_edges(hd, ed.dst, ed).to(dt),
                               _to_edges(he, ed.src, ed).to(dt), ed.emask)
    if comm:  # partials within the owner's block, summed over model
        denom = _to_nodes(gate.to(WIRE), ed.local, ed, ed.owner_pl
                          ).redistribute(dm, ed.node_pl).to(dt) + 1e-6
        eta = gate / _to_edges(denom, ed.local, ed, ed.node_pl, ed.owner_pl)
        agg = _to_nodes((eta * src_v * ed.emask).to(WIRE), ed.local, ed,
                        ed.owner_pl).redistribute(dm, ed.node_pl).to(dt)
    else:  # partials over all N nodes, summed over every axis
        gsum = gate.to(cd) if cd is not None else gate
        denom = _to_nodes(gsum, ed.dst, ed, ed.part_pl).redistribute(
            dm, ed.rep).to(dt) + 1e-6
        eta = gate / _to_edges(denom, ed.dst, ed)
        msg = eta * src_v * ed.emask
        if cd is not None:
            msg = msg.to(cd)
        agg = _to_nodes(msg, ed.dst, ed, ed.part_pl).redistribute(
            dm, ed.node_pl).to(dt)
    return h + torch.relu(_ln(hu + agg, lp.ln_h)), e_new


def _forward_ranks(model: GatedGCN, feats: DTensor, edge_src, edge_dst,
                   edge_mask, graph_ids, n_graphs: int, rules,
                   comm: bool) -> DTensor:
    """:func:`gnn_forward` over the mesh of ranks of ``feats``."""
    cfg = model.cfg
    if comm and cfg.task != "node":
        raise ValueError("gnn comm form: the node task only, as the "
                         "reference's")
    ed = _rank_edges(feats, edge_src, edge_dst, edge_mask, rules, comm,
                     cfg.dtype)
    h = feats.to(cfg.dtype) @ model.embed_w + model.embed_b
    e = zeros_rows(ed.emask, (ed.emask.shape[0], cfg.d_hidden), cfg.dtype)
    remat = torch.is_grad_enabled()
    for lp in model.layers:
        if remat:
            h, e = checkpoint(_layer_ranks, h, e, lp, ed, cfg, comm,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            h, e = _layer_ranks(h, e, lp, ed, cfg, comm)
    if cfg.task == "graph":  # every rank pools the whole graph batch
        ids = _placed(graph_ids, ed.mesh, ed.rep).to_local()
        graphs = build_csr(ids, n_graphs)

        def pool(t):
            pooled = seg_sum(t, graphs)
            cnt = seg_sum(torch.ones((t.shape[0], 1), dtype=cfg.dtype,
                                     device=t.device), graphs)
            return pooled / torch.clamp_min(cnt, 1.0)

        h = _on_ranks(pool, h, ed.rep, ed.rep, ed.rep, ed.mesh)
    return h @ model.head_w + model.head_b


# ---------------------------------------------------------------------------
# The mesh form: the reference's shard_map message passing with explicit
# wire control (gnn.py:185-270) on the port's single-process mesh. Node
# blocks are split over ('pod', 'data'); edges over ('pod', 'data',
# 'model'), dst-partitioned by the data pipeline (an edge lives with its
# destination's node block; off-shard destinations are masked). Per layer:
# one bf16 all-gather of h; each edge shard's bf16 segment-sum partials
# are added over 'model' by their (pod, data) owner in linear shard order.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _EdgeShard:
    device: torch.device
    owner: int  # node shard
    csr_src: CSR  # by source over all N nodes
    csr_dst: CSR  # by global destination over all N nodes
    csr_local: CSR  # by destination within the owner's block
    emask: torch.Tensor  # (E_s, 1)


def _split(x: torch.Tensor, parts: int, what: str) -> List[torch.Tensor]:
    if x.shape[0] % parts:
        raise ValueError(f"gnn mesh form: {x.shape[0]} {what} do not split "
                         f"into {parts} equal shards")
    return list(torch.split(x, x.shape[0] // parts))


def _edge_shards(mesh, edge_src, edge_dst, edge_mask, n: int,
                 n_local: int) -> List[_EdgeShard]:
    eaxes = cf_row_axes(mesh, ("pod", "data", "model"))
    parts = cf_shard_count(mesh, eaxes)
    per_owner = mesh.shape.get("model", 1)
    shards = []
    for s, (dev, src, dst, mask) in enumerate(zip(
            shard_devices(mesh, eaxes),
            *(_split(x, parts, "edges")
              for x in (edge_src, edge_dst, edge_mask)))):
        owner = s // per_owner
        src, dst, mask = src.to(dev), dst.to(dev), mask.to(dev)
        dst_l = dst.long() - owner * n_local
        owned = (dst_l >= 0) & (dst_l < n_local)
        mask = mask * owned.to(mask.dtype)
        dst_l = dst_l.clamp(0, n_local - 1)
        shards.append(_EdgeShard(
            dev, owner, build_csr(src, n, mask),
            build_csr(dst, n, mask), build_csr(dst_l, n_local, mask),
            mask[:, None]))
    return shards


def _sharded_layer(cfg: GNNConfig, shards: Sequence[_EdgeShard],
                   node_devs, lp: GNNLayer, n_nodes: int, *state):
    """One layer over every shard: ``state`` is the node blocks' h, then
    the edge shards' e; returns the new blocks in the same order."""
    dt = cfg.dtype
    h_blocks, e_blocks = state[:n_nodes], state[n_nodes:]
    wire_h = [h.to(WIRE) for h in h_blocks]
    proj = {}  # one all-gather and projection per device
    for dev in dict.fromkeys(sh.device for sh in shards):
        h_full = all_gather_rows(wire_h, dev).to(dt)
        proj[dev] = tuple(h_full @ getattr(lp, name).to(dev)
                          for name in "VDE")
    gates, src_vs, e_new, denom_parts = [], [], [], [[] for _ in h_blocks]
    for sh, e in zip(shards, e_blocks):
        hv, hd, he = proj[sh.device]
        src_v = gather(hv, sh.csr_src)
        e2, gate = _edge_update(e, lp, src_v, gather(hd, sh.csr_dst),
                                gather(he, sh.csr_src), sh.emask)
        e_new.append(e2)
        gates.append(gate)
        src_vs.append(src_v)
        denom_parts[sh.owner].append(seg_sum(gate.to(WIRE), sh.csr_local))
    denoms = [ordered_sum(p, dev).to(dt) + 1e-6
              for p, dev in zip(denom_parts, node_devs)]
    agg_parts = [[] for _ in h_blocks]
    for sh, gate, src_v in zip(shards, gates, src_vs):
        eta = gate / gather(denoms[sh.owner].to(sh.device), sh.csr_local)
        agg_parts[sh.owner].append(seg_sum((eta * src_v * sh.emask).to(WIRE),
                                           sh.csr_local))
    h_new = [h + torch.relu(_ln(h @ lp.U.to(dev)
                                + ordered_sum(p, dev).to(dt), lp.ln_h.to(dev)))
             for h, p, dev in zip(h_blocks, agg_parts, node_devs)]
    return tuple(h_new) + tuple(e_new)


def gnn_forward_sharded(model: GatedGCN, node_feats: torch.Tensor,
                        edge_src: torch.Tensor, edge_dst: torch.Tensor,
                        edge_mask: torch.Tensor, mesh) -> torch.Tensor:
    """(N, n_classes) logits of the node task through the mesh form, on the
    first node shard's device. ``node_feats`` splits into equal blocks over
    ('pod', 'data'), the edge arrays (global node ids) into equal shards
    over ('pod', 'data', 'model'); edge shard s belongs to node block
    s // |model| (:func:`dst_partition` lays a batch out so)."""
    cfg = model.cfg
    if cfg.task != "node":
        raise ValueError("gnn_forward_sharded: the mesh form serves the node "
                         "task, as the reference's")
    naxes = cf_row_axes(mesh, ("pod", "data"))
    node_devs = shard_devices(mesh, naxes)
    n = node_feats.shape[0]
    feats = _split(node_feats, cf_shard_count(mesh, naxes), "nodes")
    n_local = feats[0].shape[0]
    shards = _edge_shards(mesh, edge_src, edge_dst, edge_mask, n, n_local)
    h_blocks = [f.to(dev).to(cfg.dtype) @ model.embed_w.to(dev)
                + model.embed_b.to(dev) for f, dev in zip(feats, node_devs)]
    e_blocks = [torch.zeros((sh.csr_src.n_edges, cfg.d_hidden),
                            dtype=cfg.dtype, device=sh.device)
                for sh in shards]
    state = tuple(h_blocks) + tuple(e_blocks)
    remat = torch.is_grad_enabled()
    for lp in model.layers:
        args = (cfg, shards, node_devs, lp, len(h_blocks)) + state
        state = (checkpoint(_sharded_layer, *args, use_reentrant=False,
                            preserve_rng_state=False) if remat
                 else _sharded_layer(*args))
    logits = [h @ model.head_w.to(dev) + model.head_b.to(dev)
              for h, dev in zip(state[:len(h_blocks)], node_devs)]
    return all_gather_rows(logits, node_devs[0])


def gnn_loss_sharded(model: GatedGCN, batch: Dict[str, torch.Tensor],
                     mesh) -> torch.Tensor:
    """The node task's loss through :func:`gnn_forward_sharded`."""
    logits = gnn_forward_sharded(model, batch["node_feats"],
                                 batch["edge_src"], batch["edge_dst"],
                                 batch["edge_mask"], mesh)
    return _node_loss(logits, batch["labels"].to(logits.device))


def dst_partition(batch: Dict, n_node_shards: int, multiple: int) -> Dict:
    """The data pipeline's contract for the mesh form, on host arrays: the
    live edges grouped by the node block of their destination (blocks of
    N / n_node_shards rows, N padded up to a multiple of n_node_shards),
    each group in edge order and padded to one length, a multiple of
    ``multiple``, with edges (0 → the block's first node, mask 0). Nodes
    past N get zero features and label -1."""
    feats = batch["node_feats"]
    n = -(-feats.shape[0] // n_node_shards) * n_node_shards
    n_local = n // n_node_shards
    live = batch["edge_mask"] != 0
    src, dst = batch["edge_src"][live], batch["edge_dst"][live]
    owner = dst // n_local
    per = max(int((owner == i).sum()) for i in range(n_node_shards))
    per = max(-(-per // multiple) * multiple, multiple)
    out_src, out_dst, out_mask = [], [], []
    for i in range(n_node_shards):
        sel = owner == i
        pad = per - int(sel.sum())
        out_src.append(np.pad(src[sel], (0, pad)))
        out_dst.append(np.pad(dst[sel], (0, pad), constant_values=i * n_local))
        out_mask.append(np.pad(np.ones(int(sel.sum()), np.float32), (0, pad)))
    out = dict(batch)
    out["node_feats"] = np.pad(feats, ((0, n - feats.shape[0]), (0, 0)))
    out["edge_src"] = np.concatenate(out_src).astype(np.int32)
    out["edge_dst"] = np.concatenate(out_dst).astype(np.int32)
    out["edge_mask"] = np.concatenate(out_mask)
    if "labels" in batch:
        out["labels"] = np.pad(batch["labels"], (0, n - feats.shape[0]),
                               constant_values=-1)
    return out
