"""Cells: one step function per (architecture × input shape), the
reference's ``repro.launch.steps`` for the LM, GNN, recsys and CF
families on one device (the GNN's ``comm`` variant on the port's
single-process mesh).

``build_cell(arch, shape_name)`` returns a :class:`Cell`: the step
function and example inputs on the ``meta`` device (shapes and dtypes, no
memory — the counterpart of the reference's ``ShapeDtypeStruct``\\ s), for
``launch/train.py`` and ``launch/serve.py``-style callers to run with real
tensors. The port runs on one device, so a cell has no shardings and no
donation: the train step updates the model and the optimizer state in
place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..core import knn as core_knn
from ..core.graph import build_neighbor_graph
from ..core.selection import select_landmarks
from ..core.types import NeighborGraph, round_up
from ..kernels import ops
from ..models import gnn as gnn_mod
from ..models import recsys as rec_mod
from ..models import transformer as lm_mod
from ..train.optimizer import opt_init, opt_update
from .mesh import make_mesh

# the GNN's comm variant runs on the reference's debug mesh
COMM_MESH = (("data", "model"), (2, 4))


@dataclasses.dataclass
class Cell:
    arch: ArchConfig
    shape: ShapeSpec
    fn: Callable
    args: Tuple[Any, ...]  # example inputs on the meta device


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_model(cfg) -> lm_mod.LM:
    return lm_mod.LM(cfg, device="meta")


def value_and_grad(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
                   loss_fn: Callable = lm_mod.lm_loss):
    """(loss, {parameter name: gradient}) of ``loss_fn(model, batch)``
    (default ``lm_loss``), through ``torch.autograd.grad`` (nothing
    accumulates in ``.grad``). A parameter the loss does not reach gets a
    zero gradient, as under ``jax.grad`` (the GNN's last ``ln_e`` only
    updates edge states that nothing reads)."""
    names, params = zip(*model.named_parameters())
    loss = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), dict(zip(names, grads))


def _lm_train_cell(arch: ArchConfig, shape: ShapeSpec) -> Cell:
    b, s = shape.dims["batch"], shape.dims["seq"]
    accum = arch.grad_accum.get(shape.name, 1)
    mb = b // accum
    tok_shape = (accum, mb, s) if accum > 1 else (b, s)
    meta = _meta_model(arch.model)
    batch = {key: torch.empty(tok_shape, dtype=torch.int32, device="meta")
             for key in ("tokens", "labels")}

    def step(model, opt_state, batch):
        if accum > 1:
            # micro-batches in order; the accumulators are bf16 whatever the
            # parameters' dtype, as the reference's scan carries them
            batch = {key: val.reshape(accum, mb, *val.shape[-1:])
                     for key, val in batch.items()}
            g_acc, l_acc = None, 0.0
            for i in range(accum):
                loss, grads = value_and_grad(
                    model, {key: val[i] for key, val in batch.items()})
                if g_acc is None:
                    g_acc = {n: torch.zeros_like(g, dtype=torch.bfloat16)
                             for n, g in grads.items()}
                g_acc = {n: g_acc[n] + g.to(torch.bfloat16)
                         for n, g in grads.items()}
                l_acc = l_acc + loss
            grads = {n: g / accum for n, g in g_acc.items()}
            loss = l_acc / accum
        else:
            loss, grads = value_and_grad(model, batch)
        opt_update(model, grads, opt_state, arch.opt)
        return model, opt_state, {"loss": loss}

    return Cell(arch, shape, step, (meta, opt_init(meta, arch.opt), batch))


def _lm_prefill_cell(arch: ArchConfig, shape: ShapeSpec) -> Cell:
    b, s = shape.dims["batch"], shape.dims["seq"]
    tokens = torch.empty((b, s), dtype=torch.int32, device="meta")

    def step(model, tokens):
        with torch.inference_mode():
            return lm_mod.lm_prefill(model, tokens)

    return Cell(arch, shape, step, (_meta_model(arch.model), tokens))


def _lm_decode_cell(arch: ArchConfig, shape: ShapeSpec,
                    landmark: bool) -> Cell:
    cfg = arch.model
    b, cache_len = shape.dims["batch"], shape.dims["cache_len"]
    token = torch.empty((b, 1), dtype=torch.int32, device="meta")
    if landmark:
        cache = lm_mod.make_landmark_cache(cfg, b, device="meta")
        decode = lm_mod.lm_landmark_decode_step
    else:
        cache = lm_mod.make_cache(cfg, b, cache_len, device="meta")
        decode = lm_mod.lm_decode_step

    def step(model, cache, token):
        with torch.inference_mode():
            return decode(model, cache, token)

    return Cell(arch, shape, step, (_meta_model(cfg), cache, token))


def _gnn_sizes(shape: ShapeSpec, node_shards: int, edge_shards: int):
    """(nodes, edges) of a GNN shape's batch, as the reference's
    ``_gnn_batch_sds`` sizes it: a whole graph padded to split evenly over
    the node and edge shards."""
    d = shape.dims
    if shape.name == "molecule":
        return d["batch"] * d["n_nodes"], d["batch"] * d["n_edges"]
    if "pad_nodes" in d:
        return d["pad_nodes"], d["pad_edges"]
    edges = d.get("pad_edges", d["n_edges"])
    return (-(-d["n_nodes"] // node_shards) * node_shards,
            -(-edges // edge_shards) * edge_shards)


def _gnn_train_cell(arch: ArchConfig, shape: ShapeSpec,
                    variant: str = "base") -> Cell:
    """The GNN's train step at ``shape``: ``d_feat``, ``n_classes`` and the
    task (``molecule`` is graph regression) from the shape; the cell's
    ``arch.model`` is that config. ``variant="comm"`` runs the mesh form
    (``gnn_loss_sharded``) on the reference's debug mesh (data=2,
    model=4) over the parameters' device."""
    d = shape.dims
    task = "graph" if shape.name == "molecule" else "node"
    cfg = dataclasses.replace(arch.model, d_feat=d["d_feat"],
                              n_classes=d["n_classes"], task=task)
    if variant not in ("base", "comm"):
        raise ValueError(f"unknown GNN variant {variant!r}")
    if variant == "comm" and task == "graph":
        raise ValueError("the comm variant serves the node task")
    data, model = COMM_MESH[1] if variant == "comm" else (1, 1)
    n_nodes, n_edges = _gnn_sizes(shape, data, data * model)

    batch = {"node_feats": _meta((n_nodes, d["d_feat"]), torch.float32),
             "edge_src": _meta((n_edges,), torch.int32),
             "edge_dst": _meta((n_edges,), torch.int32),
             "edge_mask": _meta((n_edges,), torch.float32)}
    if task == "graph":
        batch["graph_ids"] = _meta((n_nodes,), torch.int32)
        batch["targets"] = _meta((d["batch"],), torch.float32)
    else:
        batch["labels"] = _meta((n_nodes,), torch.int32)

    def step(model, opt_state, batch):
        if task == "graph":
            batch = dict(batch, n_graphs=d["batch"])
        if variant == "comm":
            mesh = make_mesh(*COMM_MESH, next(model.parameters()).device)
            loss, grads = value_and_grad(
                model, batch, lambda mdl, b: gnn_mod.gnn_loss_sharded(
                    mdl, b, mesh))
        else:
            loss, grads = value_and_grad(model, batch, gnn_mod.gnn_loss)
        opt_update(model, grads, opt_state, arch.opt)
        return model, opt_state, {"loss": loss}

    model = gnn_mod.GatedGCN(cfg, device="meta")
    return Cell(dataclasses.replace(arch, model=cfg), shape, step,
                (model, opt_init(model, arch.opt), batch))


def _rec_batch_sds(arch: ArchConfig, shape: ShapeSpec, kind: str
                   ) -> Dict[str, torch.Tensor]:
    """A recsys cell's inputs on the ``meta`` device, in the reference's
    shapes and dtypes (``_rec_batch_sds``; one device, so no shardings)."""
    cfg = arch.model
    b = shape.dims["batch"]
    i32 = torch.int32
    out: Dict[str, torch.Tensor] = {}
    if isinstance(cfg, rec_mod.FMConfig):
        out["field_ids"] = _meta((b, cfg.n_fields), i32)
        if kind == "train":
            out["labels"] = _meta((b,), i32)
    else:
        out["item_ids"] = _meta((b, cfg.seq_len), i32)
        if kind == "train":
            if isinstance(cfg, rec_mod.Bert4RecConfig):
                n_mask = cfg.seq_len // 5
                out["mask_positions"] = _meta((b, n_mask), i32)
                out["targets"] = _meta((b, n_mask), i32)
                out["negatives"] = _meta((cfg.n_negatives,), i32)
            elif isinstance(cfg, rec_mod.MINDConfig):
                out["targets"] = _meta((b,), i32)
                out["negatives"] = _meta((cfg.n_negatives,), i32)
            else:  # DIEN
                out["targets"] = _meta((b,), i32)
                out["labels"] = _meta((b,), i32)
    if kind == "scores":
        c = shape.dims.get("n_candidates", 16)
        if isinstance(cfg, (rec_mod.Bert4RecConfig, rec_mod.MINDConfig)):
            out["candidates"] = _meta((b, c), i32)
        elif isinstance(cfg, rec_mod.DIENConfig):
            out["targets"] = _meta((b,), i32)
    if kind == "retrieval":
        out["cand_ids"] = _meta((shape.dims["n_candidates"],), i32)
    return out


def _rec_cell(arch: ArchConfig, shape: ShapeSpec) -> Cell:
    """A recsys cell: ``train`` (loss and gradients, then the arch's
    optimizer), ``scores`` (the model's scores of a batch) or
    ``retrieval`` (the top 100 over every item; FM over ``cand_ids``)."""
    fam = rec_mod.family(arch.model)
    kind = shape.kind
    model = fam.cls(arch.model, device="meta")
    batch = _rec_batch_sds(arch, shape, kind)
    if kind == "train":
        def step(model, opt_state, batch):
            loss, grads = value_and_grad(model, batch, fam.loss)
            opt_update(model, grads, opt_state, arch.opt)
            return model, opt_state, {"loss": loss}

        return Cell(arch, shape, step, (model, opt_init(model, arch.opt),
                                        batch))
    if kind == "scores":
        def step(model, batch):
            with torch.inference_mode():
                return fam.scores(model, batch)
    elif kind == "retrieval":
        def step(model, batch):
            with torch.inference_mode():
                return fam.retrieval(model, batch, k=100)
    else:
        raise ValueError(f"unknown recsys shape kind {kind!r}")
    return Cell(arch, shape, step, (model, batch))


def _cf_cell(arch: ArchConfig, shape: ShapeSpec,
             variant: str = "base") -> Cell:
    """Landmark CF at ``shape`` (the reference's ``_cf_cell``), on the
    device of the ratings it is given.

    ``cf_fit``: ``step(generator, ratings)`` selects the landmarks (the
    random strategies draw from the ``torch.Generator``, the reference's
    ``key``; the registry's popularity needs none, so the cell's example
    passes None), computes d1 through ``kernels/ops.py::masked_similarity``
    (kernel 1, ``masked_similarity.cu``, on CUDA tensors) and the (U, k)
    graph through ``core/graph.py::build_neighbor_graph`` (kernel 2,
    ``knn_topk.cu``'s scan, the ``kernel`` backend, on CUDA tensors; the
    plain d1 and the streaming graph on CPU ones), and returns
    ``(landmark ids, representation, weights, neighbor ids)``; the (U, U)
    matrix never exists. ``cf_predict``: ``step(weights, neighbor ids,
    ratings, users, items)`` runs ``core/knn.py::predict_pairs_graph``
    over the ``NeighborGraph``.

    The reference holds the ratings in bf16 past 100,000 users; kernel 1
    reads f32, so the port holds them in f32 at every size (4 bytes a
    rating: 275 GB at ``web_fit``'s 1,048,576 × 65,536, against the
    reference's 137 GB), and the dry run counts what it holds. Users are
    padded to a multiple of 8, as the reference's one-shard mesh pads
    them. The reference's ``fused`` variant is its pod-scale route
    through ``topk_sim_kernel`` under ``shard_map``; on one card the
    ``kernel`` backend is that route, so ``fused`` builds this same step.
    """
    if variant not in ("base", "fused"):
        raise ValueError(f"unknown CF variant {variant!r}")
    spec = arch.model
    d = shape.dims
    u = round_up(d["n_users"], 8)
    n_lm = d.get("n_landmarks", spec.n_landmarks)
    ratings = _meta((u, d["n_items"]), torch.float32)
    if shape.kind == "cf_fit":
        def step(generator, r):
            idx = select_landmarks(r, n_lm, spec.selection, generator)
            rep = ops.masked_similarity(r, r[idx], spec.d1)
            backend = "streaming" if r.device.type == "cpu" else "kernel"
            graph = build_neighbor_graph(rep, spec.d2, spec.k_neighbors,
                                         backend)
            return idx, rep, graph.weights, graph.indices

        return Cell(arch, shape, step, (None, ratings))
    if shape.kind != "cf_predict":
        raise ValueError(f"unknown CF shape kind {shape.kind!r}")
    pairs = d["n_pairs"]

    def step(nbr_w, nbr_i, r, users, items):
        return core_knn.predict_pairs_graph(NeighborGraph(nbr_i, nbr_w), r,
                                            users, items)

    k = spec.k_neighbors
    return Cell(arch, shape, step, (
        _meta((u, k), torch.float32), _meta((u, k), torch.int32), ratings,
        _meta((pairs,), torch.int32), _meta((pairs,), torch.int32)))


def build_cell(arch: ArchConfig, shape_name: str,
               variant: str = "base") -> Cell:
    """The cell of ``arch`` at its shape ``shape_name``. ``variant``, for a
    decode shape: ``landmark`` (O(n) landmark decode) or ``kv_int8`` (the
    int8 KV cache); for a GNN shape: ``comm`` (the mesh form); for a CF
    fit: ``fused`` (the same step on one card)."""
    shape = arch.shape(shape_name)
    if arch.family == "gnn":
        return _gnn_train_cell(arch, shape, variant)
    if arch.family == "recsys":
        return _rec_cell(arch, shape)
    if arch.family == "cf":
        return _cf_cell(arch, shape, variant)
    if arch.family != "lm":
        raise ValueError(f"build_cell: unknown family {arch.family!r}")
    if shape.kind == "train":
        return _lm_train_cell(arch, shape)
    if shape.kind == "prefill":
        return _lm_prefill_cell(arch, shape)
    if shape.kind == "decode":
        if variant == "kv_int8":
            arch = dataclasses.replace(arch, model=dataclasses.replace(
                arch.model, kv_quant=True))
            return _lm_decode_cell(arch, shape, False)
        return _lm_decode_cell(arch, shape, variant == "landmark")
    raise ValueError(shape.kind)
