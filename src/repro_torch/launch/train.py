"""Training launcher: ``python -m repro_torch.launch.train --arch smollm-360m
[--shape train_4k] [--steps N] [--smoke] [--ckpt-dir D] [--device cpu]``,
``--arch gatedgcn [--shape full_graph_sm|minibatch_lg|molecule]``, or
``--arch {fm,bert4rec,mind,dien}``.

The reference's ``repro.launch.train`` for the LM, GNN and recsys families,
on one device: builds the arch's train cell (``launch/steps.py``), random
weights from ``torch.Generator`` seed 0, the arch's optimizer, and runs
``train/trainer.py::train_loop``, checkpointing every ``steps // 2`` steps
and resuming from the latest checkpoint in ``--ckpt-dir``. The LM trains
on ``data/synthetic.py::lm_batch`` batches; the GNN on each shape's own
generator: ``random_graph`` for ``full_graph_sm``, ``sampled_block`` for
``minibatch_lg``, ``molecule_batch`` for ``molecule`` (the reference feeds
its 200-node smoke graph at every shape, with full_graph_sm's dims:
ROADMAP B10). ``ogb_products`` does not fit one card and raises. The
recsys family trains as the reference's ``_batches`` feeds it, whatever
the shape's batch (ROADMAP B11): FM ``fm_train_batch`` of 256 rows, the
sequence models ``seq_rec_batch`` of 32 (BERT4Rec with ``seq_len // 5``
masked positions and its negatives, MIND with its negatives); only its
``train`` shape (``train_batch``) trains.
``--smoke`` swaps in the arch's smoke model, as the reference's: for the LM
a (4, 128) batch and no gradient accumulation, for the GNN the
reference's ``random_graph(step, 200, 800, d_feat, n_classes,
pad_edges_to=1024)`` (``molecule``: 4 molecules of 10 nodes and 20 edges).
Runs on the card unless ``--device cpu`` is given; without a card it
raises (it never falls back).

An LM trains sharded over a mesh of ranks under ``torchrun`` (one
process a rank, ``launch/dist.py::init``; the arch's rules place the
parameters, the optimizer state and each batch, ``launch/steps.py``):
``--production-mesh`` (16×16, or 2×16×16 with ``--multi-pod``),
``--debug-mesh`` (2×4, or 2×2×2 with ``--multi-pod``) or ``--mesh
data=2,model=2``, e.g.

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch smollm-360m --smoke --debug-mesh --steps 4 --ckpt-dir D

A world whose size is not the mesh's raises, naming both. Checkpoints are
written by every rank and resume on any mesh. The GNN's and the recsys
models' mesh forms, and ``ogb_products``, wait for later slices (ROADMAP
queue 1, items 4b and 4c) and raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import torch

from ..configs import registry
from ..configs.base import ShapeSpec
from ..data import synthetic as S
from ..models import gnn as gnn_mod
from ..models import recsys as rec_mod
from ..models import transformer as lm_mod
from ..train.optimizer import opt_init
from ..train.trainer import Prefetcher, TrainerConfig, to_device, train_loop
from . import dist
from .mesh import DEBUG, DEBUG_MULTI_POD, MULTI_POD, PRODUCTION, device_mesh
from .steps import build_cell, place_params, place_tree

SMOKE_BATCH, SMOKE_SEQ = 4, 128
SMOKE_GRAPH = (200, 800, 1024)  # nodes, edges, edges padded to
SMOKE_MOLECULES = (4, 10, 20)  # molecules, nodes and edges a molecule
REC_BATCH = {"fm": 256, "seq": 32}  # the reference's recsys rows a step
OGB_WAITS = (
    "launch.train: ogb_products (2,449,029 nodes, 61,859,140 edges) does "
    "not fit one card: one (E, 70) f32 edge tensor is 61.86 M x 70 x 4 B = "
    "17.3 GB, a layer's forward holds about six live (~104 GB), and "
    "per-layer remat keeps 16 carries of e (277 GB). It trains "
    "edge-sharded over a mesh and waits for the GNN's edge sharding "
    "(ROADMAP queue 1, item 4b).")
MESH_WAITS = {
    "gnn": "the GNN's edge sharding (ROADMAP queue 1, item 4b)",
    "recsys": "the recsys rows' sharding on DTensor (ROADMAP queue 1, item "
              "4a)"}


def _lm_batches(cfg, shape: ShapeSpec):
    b, s = shape.dims["batch"], shape.dims["seq"]
    step = 0
    while True:
        yield S.lm_batch(0, step, b, s, cfg.vocab)
        step += 1


def _gnn_batches(shape: ShapeSpec):
    """Each GNN shape's own generator, deterministic in the step."""
    d = shape.dims
    step = 0
    while True:
        if shape.name == "molecule":
            yield S.molecule_batch(0, step, d["batch"], d["n_nodes"],
                                   d["n_edges"], d["d_feat"])
        elif "pad_nodes" in d:
            yield S.sampled_block(0, step, d["n_total_nodes"],
                                  d["batch_nodes"], d["fanouts"], d["d_feat"],
                                  d["n_classes"], d["pad_nodes"],
                                  d["pad_edges"])
        else:
            yield S.random_graph(step, d["n_nodes"], d["n_edges"],
                                 d["d_feat"], d["n_classes"],
                                 pad_edges_to=d.get("pad_edges"))
        step += 1


def _rec_rows(cfg) -> int:
    return REC_BATCH["fm" if isinstance(cfg, rec_mod.FMConfig) else "seq"]


def _rec_batches(cfg):
    """The reference's recsys batches (``launch/train.py::_batches``):
    REC_BATCH rows a step, deterministic in the step."""
    rows = _rec_rows(cfg)
    step = 0
    while True:
        if isinstance(cfg, rec_mod.FMConfig):
            yield S.fm_train_batch(0, step, rows, cfg.field_vocabs)
        elif isinstance(cfg, rec_mod.Bert4RecConfig):
            yield S.seq_rec_batch(0, step, rows, cfg.seq_len, cfg.n_items,
                                  n_mask=max(1, cfg.seq_len // 5),
                                  n_negatives=cfg.n_negatives)
        elif isinstance(cfg, rec_mod.MINDConfig):
            yield S.seq_rec_batch(0, step, rows, cfg.seq_len, cfg.n_items,
                                  n_negatives=cfg.n_negatives)
        else:
            yield S.seq_rec_batch(0, step, rows, cfg.seq_len, cfg.n_items)
        step += 1


def _smoke_shape(arch, shape_name: str) -> ShapeSpec:
    cfg = arch.smoke_model
    if arch.family == "recsys":
        return ShapeSpec(shape_name, "train", dict(batch=_rec_rows(cfg)))
    if arch.family == "lm":
        return ShapeSpec(shape_name, "train",
                         dict(batch=SMOKE_BATCH, seq=SMOKE_SEQ))
    if shape_name == "molecule":
        b, n, e = SMOKE_MOLECULES
        return ShapeSpec(shape_name, "train_graph", dict(
            batch=b, n_nodes=n, n_edges=e, d_feat=cfg.d_feat, n_classes=1))
    n, e, pad = SMOKE_GRAPH
    return ShapeSpec(shape_name, "train_graph", dict(
        n_nodes=n, n_edges=e, pad_edges=pad, d_feat=cfg.d_feat,
        n_classes=cfg.n_classes))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced model (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; the CPU "
                    "only when asked for)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="shard over the 16x16 mesh (torchrun, 256 ranks)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="two pods: 2x16x16, or 2x2x2 with --debug-mesh")
    ap.add_argument("--debug-mesh", action="store_true",
                    help="shard over the 2x4 debug mesh (torchrun, 8 ranks)")
    ap.add_argument("--mesh", default=None,
                    help="shard over named axes, e.g. data=2,model=2")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch.train: no CUDA device; pass --device cpu "
                           "to train on the CPU")
    arch = registry.get(args.arch)
    axes = _mesh_axes(args)
    if axes is not None and arch.family in MESH_WAITS:
        raise NotImplementedError(
            f"launch.train: the {arch.family} family's mesh form waits for "
            f"{MESH_WAITS[arch.family]}")
    if arch.family == "cf":
        raise ValueError(f"launch.train: {args.arch!r} fits rather than "
                         f"trains: serve it with launch.serve --workload cf, "
                         f"or run its cf_fit cell (launch/steps.py)")
    shape_name = args.shape or arch.shapes[0].name
    if arch.family == "gnn" and shape_name == "ogb_products":
        raise NotImplementedError(OGB_WAITS)
    if args.smoke:
        arch = dataclasses.replace(arch, model=arch.smoke_model, grad_accum={},
                                   shapes=(_smoke_shape(arch, shape_name),))
    elif arch.family == "recsys" and arch.shape(shape_name).kind != "train":
        raise ValueError(f"launch.train: {shape_name!r} is a "
                         f"{arch.shape(shape_name).kind} shape; recsys "
                         f"trains on train_batch")

    mesh = launch = None
    if axes is not None:
        launch = dist.current()
        if launch is None and "RANK" in os.environ:  # started by torchrun
            launch = dist.init(args.device)
        mesh = device_mesh(*axes, device=device.type)  # raises off-size
        device = launch.device
    cell = build_cell(arch, shape_name, mesh=mesh)
    gen = torch.Generator(device).manual_seed(0)
    put = lambda b: to_device(b, device)  # noqa: E731
    if arch.family == "lm":
        model = lm_mod.init_lm(cell.arch.model, gen, device)
        batches = _lm_batches(arch.model, cell.shape)
        if mesh is not None:
            place_params(model, lm_mod.param_logical(arch.model), arch.rules,
                         mesh)
            accum = arch.grad_accum.get(shape_name, 1)
            tok = ("null", "batch", "null") if accum > 1 else ("batch", "null")
            put = lambda b: place_tree(  # noqa: E731
                to_device(_micro(b, accum), device),
                {"tokens": tok, "labels": tok}, arch.rules, mesh)
    elif arch.family == "gnn":
        model = gnn_mod.init_gnn(cell.arch.model, gen, device)
        batches = _gnn_batches(cell.shape)
    else:
        model = rec_mod.init_recsys(cell.arch.model, gen, device)
        batches = _rec_batches(cell.arch.model)
    opt_state = opt_init(model, arch.opt)
    quiet = launch is not None and launch.rank != 0
    out = train_loop(
        cell.fn, model, opt_state, Prefetcher(batches, put),
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=max(args.steps // 2, 1), log_every=10),
        log=(lambda _: None) if quiet else print,
    )
    if not quiet:
        where = f" on mesh {dict(zip(*axes))}" if axes else ""
        print(f"final loss {out['losses'][-1]:.4f} after "
              f"{out['last_step'] + 1} steps{where}; stragglers flagged: "
              f"{len(out['stragglers'])}")
    return out


def _mesh_axes(args):
    """(names, sizes) of the mesh the flags ask for, or None."""
    if args.mesh:
        pairs = [kv.split("=") for kv in args.mesh.split(",")]
        return tuple(k for k, _ in pairs), tuple(int(v) for _, v in pairs)
    if args.debug_mesh:
        return DEBUG_MULTI_POD if args.multi_pod else DEBUG
    if args.production_mesh or args.multi_pod:
        return MULTI_POD if args.multi_pod else PRODUCTION
    return None


def _micro(batch, accum: int):
    """A (B, S) batch as (accum, B / accum, S) micro-batches."""
    if accum == 1:
        return batch
    return {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
            for k, v in batch.items()}


if __name__ == "__main__":
    main()
