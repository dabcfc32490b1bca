"""Cells: one step function per (architecture × input shape), the
reference's ``repro.launch.steps`` for the LM, GNN, recsys and CF
families on one device (the GNN's ``comm`` variant on the port's
single-process mesh).

``build_cell(arch, shape_name)`` returns a :class:`Cell`: the step
function and example inputs on the ``meta`` device (shapes and dtypes, no
memory — the counterpart of the reference's ``ShapeDtypeStruct``\\ s), for
``launch/train.py`` and ``launch/serve.py``-style callers to run with real
tensors. A cell has no donation: the train step updates the model and the
optimizer state in place.

The LM, GNN and recsys cells take an optional ``DeviceMesh``
(``launch/mesh.py::device_mesh``), the reference's placements: parameters
by the family's logical tree (``lm_logical``, ``gnn_logical``, the
recsys ``*_logical``; :func:`place_params`), the optimizer state like its
parameter (``opt_state_logical``), an LM's caches by ``cache_logical`` /
``landmark_cache_logical`` and its batch over ``("pod", "data")``
(:func:`place_tree`), a GNN batch's nodes over ``("pod", "data")`` and
its edges over every axis (:func:`gnn_batch_specs`), a recsys batch over
every axis where it divides them, else over ``("pod", "data")``
(:func:`rec_batch_specs`), all DTensors; the model then runs with the
arch's rules and its collectives are counted
(``launch/dist.py::Collectives``). Without a mesh a cell is the
one-device cell; the CF cells have only that form, as the reference's.
A train cell carries its ``loss``: the function its step differentiates.

The cells' host batches live here too, for the train CLI and the mesh
runs alike: the reference's recsys rows (:func:`rec_host_batch`,
:func:`rec_rows`), each GNN shape's generator (:func:`gnn_host_batch`)
and the ``--smoke`` shapes (:func:`smoke_shape`).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..core import knn as core_knn
from ..core.graph import build_neighbor_graph
from ..core.selection import select_landmarks
from ..core.types import NeighborGraph, round_up
from ..data import synthetic
from ..kernels import ops
from ..models import gnn as gnn_mod
from ..models import recsys as rec_mod
from ..models import transformer as lm_mod
from ..distributed.sharding import (DTensor, distribute, filter_rules,
                                    mesh_axes, spec_for, splits_merged)
from ..train.optimizer import opt_init, opt_update
from . import dist as dist_mod
from .mesh import Mesh, apart, make_mesh

# the GNN's comm variant runs on the reference's debug mesh
COMM_MESH = (("data", "model"), (2, 4))
SMOKE_GRAPH = (200, 800, 1024)  # nodes, edges, edges padded to
SMOKE_MOLECULES = (4, 10, 20)  # molecules, nodes and edges a molecule
REC_BATCH = {"fm": 256, "seq": 32}  # the reference's recsys rows a step


@dataclasses.dataclass
class Cell:
    arch: ArchConfig
    shape: ShapeSpec
    fn: Callable
    args: Tuple[Any, ...]  # example inputs on the meta device
    mesh: Any = None  # the DeviceMesh of the cell's placements
    # a train cell's loss(model, batch): the one its step differentiates
    loss: Optional[Callable] = None


def rec_rows(cfg) -> int:
    """The reference's recsys rows a step (its ``launch/train.py``)."""
    return REC_BATCH["fm" if isinstance(cfg, rec_mod.FMConfig) else "seq"]


def smoke_shape(arch: ArchConfig, shape_name: str) -> ShapeSpec:
    """The train CLI's ``--smoke`` shape: for the LM a (4, 128) batch, the
    recsys rows of :func:`rec_rows`, for the GNN the reference's
    ``random_graph(step, 200, 800, d_feat, n_classes, pad_edges_to=1024)``
    (``molecule``: 4 molecules of 10 nodes and 20 edges)."""
    cfg = arch.smoke_model
    if arch.family == "recsys":
        return ShapeSpec(shape_name, "train", dict(batch=rec_rows(cfg)))
    if arch.family == "lm":
        return ShapeSpec(shape_name, "train", dict(batch=4, seq=128))
    if shape_name == "molecule":
        b, n, e = SMOKE_MOLECULES
        return ShapeSpec(shape_name, "train_graph", dict(
            batch=b, n_nodes=n, n_edges=e, d_feat=cfg.d_feat, n_classes=1))
    n, e, pad = SMOKE_GRAPH
    return ShapeSpec(shape_name, "train_graph", dict(
        n_nodes=n, n_edges=e, pad_edges=pad, d_feat=cfg.d_feat,
        n_classes=cfg.n_classes))


def rec_host_batch(cfg, seed: int, step: int, rows: int
                   ) -> Dict[str, np.ndarray]:
    """The reference's recsys batch of ``rows`` rows (its
    ``launch/train.py::_batches``), deterministic in the step."""
    if isinstance(cfg, rec_mod.FMConfig):
        return synthetic.fm_train_batch(seed, step, rows, cfg.field_vocabs)
    if isinstance(cfg, rec_mod.Bert4RecConfig):
        return synthetic.seq_rec_batch(seed, step, rows, cfg.seq_len,
                                       cfg.n_items,
                                       n_mask=max(1, cfg.seq_len // 5),
                                       n_negatives=cfg.n_negatives)
    if isinstance(cfg, rec_mod.MINDConfig):
        return synthetic.seq_rec_batch(seed, step, rows, cfg.seq_len,
                                       cfg.n_items,
                                       n_negatives=cfg.n_negatives)
    return synthetic.seq_rec_batch(seed, step, rows, cfg.seq_len,
                                   cfg.n_items)


def gnn_host_batch(shape: ShapeSpec, step: int, seed: int = 0
                   ) -> Dict[str, np.ndarray]:
    """Each GNN shape's own generator, deterministic in the step:
    ``molecule_batch``, ``sampled_block`` (minibatch_lg) or
    ``random_graph`` (seeded by the step, as the reference's)."""
    d = shape.dims
    if shape.name == "molecule":
        return synthetic.molecule_batch(seed, step, d["batch"], d["n_nodes"],
                                        d["n_edges"], d["d_feat"])
    if "pad_nodes" in d:
        return synthetic.sampled_block(seed, step, d["n_total_nodes"],
                                       d["batch_nodes"], d["fanouts"],
                                       d["d_feat"], d["n_classes"],
                                       d["pad_nodes"], d["pad_edges"])
    return synthetic.random_graph(step, d["n_nodes"], d["n_edges"],
                                  d["d_feat"], d["n_classes"],
                                  pad_edges_to=d.get("pad_edges"))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_model(cfg) -> lm_mod.LM:
    return lm_mod.LM(cfg, device="meta")


@torch.no_grad()
def place_params(model: torch.nn.Module, logical: Dict[str, tuple], rules,
                 mesh) -> torch.nn.Module:
    """Each parameter, the same whole tensor on every rank, replaced in
    place by a DTensor of its logical axes (``logical`` by parameter
    name): each rank keeps its own block."""
    rules = filter_rules(rules, mesh)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, torch.nn.Parameter(
            distribute(p.detach(), mesh, spec_for(logical[name], rules)),
            requires_grad=p.requires_grad))
    return model


def place_tree(tree: Dict[str, torch.Tensor], logical: Dict[str, tuple],
               rules, mesh) -> Dict[str, torch.Tensor]:
    """A dict of whole tensors as DTensors of their logical axes; a key
    whose axes are () (a scalar, such as a cache's length) stays as it
    is."""
    rules = filter_rules(rules, mesh)
    return {k: (distribute(v, mesh, spec_for(logical[k], rules))
                if logical[k] else v) for k, v in tree.items()}


def place_specs(tree: Dict[str, torch.Tensor], specs: Dict[str, tuple],
                mesh) -> Dict[str, torch.Tensor]:
    """A dict of whole tensors as DTensors of their specs (mesh axes per
    dim, the reference's PartitionSpecs); a key without a spec stays
    as it is."""
    return {k: distribute(v, mesh, specs[k]) if k in specs else v
            for k, v in tree.items()}


def _axes_of(mesh, axes) -> Tuple[Tuple[str, ...], int]:
    sizes = mesh_axes(mesh)
    kept = tuple(a for a in axes if a in sizes)
    n = 1
    for a in kept:
        n *= sizes[a]
    return kept, n


def rec_batch_specs(batch: Dict[str, torch.Tensor], mesh
                    ) -> Dict[str, tuple]:
    """The reference's ``_rec_batch_sds`` placements: every batch-leading
    input over every mesh axis where the batch divides them, else over
    ``("pod", "data")`` where it divides those (else replicated, as a
    batch of 1); the shared negatives and the retrieval candidates
    replicated."""
    every, n_all = _axes_of(mesh, ("pod", "data", "model"))
    baxes, n_b = _axes_of(mesh, ("pod", "data"))
    out = {}
    for key, t in batch.items():
        b = t.shape[0] if t.ndim else 1
        if key in ("negatives", "cand_ids") or b == 1:
            axes = None
        elif b % n_all == 0:
            axes = every
        elif baxes and b % n_b == 0:
            axes = baxes
        else:
            axes = None
        out[key] = (axes,) + (None,) * max(t.ndim - 1, 0)
    return out


def gnn_batch_specs(batch: Dict[str, torch.Tensor], mesh
                    ) -> Dict[str, tuple]:
    """The reference's ``_gnn_batch_sds`` placements: the node features
    over ``("pod", "data")`` where the nodes divide them, the edge arrays
    over every axis, labels, graph ids and targets replicated."""
    every, _ = _axes_of(mesh, ("pod", "data", "model"))
    naxes, n_b = _axes_of(mesh, ("pod", "data"))
    n = batch["node_feats"].shape[0]
    out = {"node_feats": ((naxes if naxes and n % n_b == 0 else None),
                          None)}
    for key in ("edge_src", "edge_dst", "edge_mask"):
        out[key] = (every,)
    for key in ("labels", "graph_ids", "targets"):
        if key in batch:
            out[key] = (None,)
    return out


def _counting(mesh):
    """The collectives' count around a mesh cell's step; nothing without
    one."""
    return (contextlib.nullcontext() if mesh is None
            else dist_mod.Collectives())


def _serving(mesh):
    """A serving cell's grad mode: ``inference_mode`` on one device;
    ``no_grad`` on a mesh, where DTensor wraps local blocks in place
    (``local_map``), which inference tensors refuse."""
    return torch.inference_mode() if mesh is None else torch.no_grad()


def _whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _batch_rules(arch: ArchConfig, b: int):
    """The arch's rules, its batch replicated at batch 1 (the
    reference's decode cells)."""
    rules = dict(arch.rules)
    if b == 1:
        rules["batch"] = None
    return rules


def value_and_grad(model: torch.nn.Module, batch: Dict[str, torch.Tensor],
                   loss_fn: Callable = lm_mod.lm_loss):
    """(loss, {parameter name: gradient}) of ``loss_fn(model, batch)``
    (default ``lm_loss``), through ``torch.autograd.grad`` (nothing
    accumulates in ``.grad``). A parameter the loss does not reach gets a
    zero gradient, as under ``jax.grad`` (the GNN's last ``ln_e`` only
    updates edge states that nothing reads). On a mesh each gradient comes
    back in its parameter's placements (:func:`_reduced`)."""
    names, params = zip(*model.named_parameters())
    loss = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), {n: _reduced(g, p)
                           for n, g, p in zip(names, grads, params)}


def _reduced(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A mesh gradient that is a partial sum over some mesh dims (a weight
    the ranks' batch blocks each use) reduced once, to its parameter's
    placements: the optimizer reads it several times, and each read of a
    partial sum would reduce it again."""
    from torch.distributed.tensor import Partial

    if isinstance(g, DTensor) and any(isinstance(pl, Partial)
                                      for pl in g.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _lm_train_cell(arch: ArchConfig, shape: ShapeSpec, mesh=None) -> Cell:
    b, s = shape.dims["batch"], shape.dims["seq"]
    accum = arch.grad_accum.get(shape.name, 1)
    mb = b // accum
    tok_shape = (accum, mb, s) if accum > 1 else (b, s)
    meta = _meta_model(arch.model)
    batch = {key: torch.empty(tok_shape, dtype=torch.int32, device="meta")
             for key in ("tokens", "labels")}
    rules = arch.rules if mesh is not None else None
    if mesh is not None:
        place_params(meta, lm_mod.param_logical(arch.model), rules, mesh)
        tok = ("null", "batch", "null") if accum > 1 else ("batch", "null")
        batch = place_tree(batch, {"tokens": tok, "labels": tok}, rules,
                           mesh)

    def loss_fn(model, batch):
        return lm_mod.lm_loss(model, batch, rules)

    def step(model, opt_state, batch):
        with _counting(mesh):
            if accum > 1:
                # micro-batches in order; the accumulators are bf16
                # whatever the parameters' dtype, as the reference's scan
                # carries them
                batch = {key: val.reshape(accum, mb, *val.shape[-1:])
                         for key, val in batch.items()}
                g_acc, l_acc = None, 0.0
                for i in range(accum):
                    loss, grads = value_and_grad(
                        model, {key: val[i] for key, val in batch.items()},
                        loss_fn)
                    if g_acc is None:
                        g_acc = {n: torch.zeros_like(g, dtype=torch.bfloat16)
                                 for n, g in grads.items()}
                    g_acc = {n: g_acc[n] + g.to(torch.bfloat16)
                             for n, g in grads.items()}
                    l_acc = l_acc + loss
                grads = {n: g / accum for n, g in g_acc.items()}
                loss = l_acc / accum
            else:
                loss, grads = value_and_grad(model, batch, loss_fn)
            opt_update(model, grads, opt_state, arch.opt)
            loss = _whole(loss)
        return model, opt_state, {"loss": loss}

    return Cell(arch, shape, step, (meta, opt_init(meta, arch.opt), batch),
                mesh, loss_fn)


def _lm_prefill_cell(arch: ArchConfig, shape: ShapeSpec, mesh=None) -> Cell:
    b, s = shape.dims["batch"], shape.dims["seq"]
    tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
    model = _meta_model(arch.model)
    rules = arch.rules if mesh is not None else None
    if mesh is not None:
        place_params(model, lm_mod.param_logical(arch.model), rules, mesh)
        tokens = place_tree({"t": tokens}, {"t": ("batch", "null")}, rules,
                            mesh)["t"]

    def step(model, tokens):
        with _counting(mesh), _serving(mesh):
            return lm_mod.lm_prefill(model, tokens, rules=rules)

    return Cell(arch, shape, step, (model, tokens), mesh)


def _lm_decode_cell(arch: ArchConfig, shape: ShapeSpec,
                    landmark: bool, mesh=None) -> Cell:
    cfg = arch.model
    b, cache_len = shape.dims["batch"], shape.dims["cache_len"]
    token = torch.empty((b, 1), dtype=torch.int32, device="meta")
    if landmark:
        cache = lm_mod.make_landmark_cache(cfg, b, device="meta")
        cache_la = lm_mod.landmark_cache_logical()
        decode = lm_mod.lm_landmark_decode_step
    else:
        cache = lm_mod.make_cache(cfg, b, cache_len, device="meta")
        cache_la = lm_mod.cache_logical(cache_len > 100_000, cfg.kv_quant)
        decode = lm_mod.lm_decode_step
    model = _meta_model(cfg)
    rules = _batch_rules(arch, b) if mesh is not None else None
    if mesh is not None:
        if splits_merged(cache_la, rules, mesh):  # kv_seq_all at multi-pod
            mesh = apart(mesh)
        place_params(model, lm_mod.param_logical(cfg), rules, mesh)
        cache = place_tree(cache, cache_la, rules, mesh)
        token = place_tree({"t": token}, {"t": ("batch", "null")}, rules,
                           mesh)["t"]

    def step(model, cache, token):
        with _counting(mesh), _serving(mesh):
            return decode(model, cache, token, rules)

    return Cell(arch, shape, step, (model, cache, token), mesh)


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
                    variant: str = "base", mesh=None) -> Cell:
    """The GNN's train step at ``shape``: ``d_feat``, ``n_classes`` and the
    task (``molecule`` is graph regression) from the shape; the cell's
    ``arch.model`` is that config. ``variant="comm"`` runs the mesh form:
    without a ``DeviceMesh`` ``gnn_loss_sharded`` on the reference's debug
    mesh (data=2, model=4) over the parameters' device (or on ``mesh``, a
    single-process ``launch/mesh.py::Mesh``), on a ``DeviceMesh`` over its
    ranks (``gnn_loss(comm=True)``)."""
    d = shape.dims
    task = "graph" if shape.name == "molecule" else "node"
    cfg = dataclasses.replace(arch.model, d_feat=d["d_feat"],
                              n_classes=d["n_classes"], task=task)
    if variant not in ("base", "comm"):
        raise ValueError(f"unknown GNN variant {variant!r}")
    if variant == "comm" and task == "graph":
        raise ValueError("the comm variant serves the node task")
    one = mesh if isinstance(mesh, Mesh) else None
    if one is not None:
        if variant != "comm":
            raise ValueError("a single-process mesh serves the comm variant")
        mesh = None
    if mesh is not None or one is not None:
        _, data = _axes_of(mesh or one.shape, ("pod", "data"))
        _, chips = _axes_of(mesh or one.shape, ("pod", "data", "model"))
        n_nodes, n_edges = _gnn_sizes(shape, data, chips)
    else:
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

    model = gnn_mod.GatedGCN(cfg, device="meta")
    rules = arch.rules if mesh is not None else None
    if mesh is not None:
        place_params(model, gnn_mod.param_logical(cfg), rules, mesh)
        batch = place_specs(batch, gnn_batch_specs(batch, mesh), mesh)

    def loss_fn(mdl, batch):
        if task == "graph":
            batch = dict(batch, n_graphs=d["batch"])
        if variant == "comm" and mesh is None:
            sp = one or make_mesh(*COMM_MESH, next(mdl.parameters()).device)
            return gnn_mod.gnn_loss_sharded(mdl, batch, sp)
        return gnn_mod.gnn_loss(mdl, batch, rules, comm=variant == "comm")

    def step(model, opt_state, batch):
        with _counting(mesh):
            loss, grads = value_and_grad(model, batch, loss_fn)
            opt_update(model, grads, opt_state, arch.opt)
            loss = _whole(loss)
        return model, opt_state, {"loss": loss}

    return Cell(dataclasses.replace(arch, model=cfg), shape, step,
                (model, opt_init(model, arch.opt), batch), mesh, loss_fn)


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


def _rec_cell(arch: ArchConfig, shape: ShapeSpec, mesh=None) -> Cell:
    """A recsys cell: ``train`` (loss and gradients, then the arch's
    optimizer), ``scores`` (the model's scores of a batch) or
    ``retrieval`` (the top 100 over every item; FM over ``cand_ids``)."""
    fam = rec_mod.family(arch.model)
    kind = shape.kind
    model = fam.cls(arch.model, device="meta")
    batch = _rec_batch_sds(arch, shape, kind)
    if mesh is not None:
        place_params(model, rec_mod.param_logical(arch.model), arch.rules,
                     mesh)
        batch = place_specs(batch, rec_batch_specs(batch, mesh), mesh)
    if kind == "train":
        def step(model, opt_state, batch):
            with _counting(mesh):
                loss, grads = value_and_grad(model, batch, fam.loss)
                opt_update(model, grads, opt_state, arch.opt)
                loss = _whole(loss)
            return model, opt_state, {"loss": loss}

        return Cell(arch, shape, step, (model, opt_init(model, arch.opt),
                                        batch), mesh, fam.loss)
    if kind == "scores":
        def step(model, batch):
            with _counting(mesh), _serving(mesh):
                return fam.scores(model, batch)
    elif kind == "retrieval":
        def step(model, batch):
            with _counting(mesh), _serving(mesh):
                return fam.retrieval(model, batch, k=100)
    else:
        raise ValueError(f"unknown recsys shape kind {kind!r}")
    return Cell(arch, shape, step, (model, batch), mesh)


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
               variant: str = "base", mesh=None) -> Cell:
    """The cell of ``arch`` at its shape ``shape_name``. ``variant``, for a
    decode shape: ``landmark`` (O(n) landmark decode) or ``kv_int8`` (the
    int8 KV cache); for a GNN shape: ``comm`` (the mesh form); for a CF
    fit: ``fused`` (the same step on one card). ``mesh``: the
    ``DeviceMesh`` of an LM, GNN or recsys cell (a CF cell raises: it has
    the one-device form only, as the reference's)."""
    shape = arch.shape(shape_name)
    if mesh is not None and arch.family == "cf":
        raise ValueError("build_cell: the CF cells run on one device, as "
                         "the reference's")
    if arch.family == "gnn":
        return _gnn_train_cell(arch, shape, variant, mesh)
    if arch.family == "recsys":
        return _rec_cell(arch, shape, mesh)
    if arch.family == "cf":
        return _cf_cell(arch, shape, variant)
    if arch.family != "lm":
        raise ValueError(f"build_cell: unknown family {arch.family!r}")
    if shape.kind == "train":
        return _lm_train_cell(arch, shape, mesh)
    if shape.kind == "prefill":
        return _lm_prefill_cell(arch, shape, mesh)
    if shape.kind == "decode":
        if variant == "kv_int8":
            arch = dataclasses.replace(arch, model=dataclasses.replace(
                arch.model, kv_quant=True))
            return _lm_decode_cell(arch, shape, False, mesh)
        return _lm_decode_cell(arch, shape, variant == "landmark", mesh)
    raise ValueError(shape.kind)
