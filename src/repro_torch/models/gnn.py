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
``gnn.py:117-119,138``) are no-ops and are left out. The mesh form
(:func:`gnn_forward_sharded`) is the reference's ``shard_map`` form on the
port's single-process mesh (``launch/mesh.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import (all_gather_rows, cf_row_axes,
                                    cf_shard_count, ordered_sum,
                                    shard_devices)
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
                n_graphs: int = 0) -> torch.Tensor:
    """(N, n_classes) logits, or (n_graphs, n_classes) with ``graph_ids``
    (mean-pooled readout). Padded edges point at node 0 with mask 0; the
    CSRs by source and destination are built once here and serve every
    layer, its recompute and the backward. With grad enabled each layer
    runs under ``torch.utils.checkpoint``: only its input is kept."""
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


def _node_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked mean of −log softmax at the labels (labels < 0 masked)."""
    labels = labels.long()
    mask = (labels >= 0).float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels.clamp_min(0)[:, None])[:, 0]
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def gnn_loss(model: GatedGCN, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
    """The node task's masked cross-entropy, or the graph task's MSE of
    the first logit against ``targets``."""
    logits = gnn_forward(model, batch["node_feats"], batch["edge_src"],
                         batch["edge_dst"], batch["edge_mask"],
                         graph_ids=batch.get("graph_ids"),
                         n_graphs=int(batch.get("n_graphs", 0)))
    if model.cfg.task == "graph":  # regression (ZINC-style)
        return torch.mean((logits[..., 0] - batch["targets"]) ** 2)
    return _node_loss(logits, batch["labels"])


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
