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
raises (it never falls back). The reference's ``--production-mesh`` and
``--multi-pod`` wait for the multi-process launcher (ROADMAP queue 1).
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from ..configs import registry
from ..configs.base import ShapeSpec
from ..data import synthetic as S
from ..models import gnn as gnn_mod
from ..models import recsys as rec_mod
from ..models import transformer as lm_mod
from ..train.optimizer import opt_init
from ..train.trainer import Prefetcher, TrainerConfig, to_device, train_loop
from .steps import build_cell

SMOKE_BATCH, SMOKE_SEQ = 4, 128
SMOKE_GRAPH = (200, 800, 1024)  # nodes, edges, edges padded to
SMOKE_MOLECULES = (4, 10, 20)  # molecules, nodes and edges a molecule
REC_BATCH = {"fm": 256, "seq": 32}  # the reference's recsys rows a step
OGB_WAITS = (
    "launch.train: ogb_products (2,449,029 nodes, 61,859,140 edges) does "
    "not fit one card: one (E, 70) f32 edge tensor is 61.86 M x 70 x 4 B = "
    "17.3 GB, a layer's forward holds about six live (~104 GB), and "
    "per-layer remat keeps 16 carries of e (277 GB). It trains "
    "edge-sharded over a mesh and waits for the multi-process launcher "
    "(ROADMAP queue 1, item 4).")


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
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch.train: no CUDA device; pass --device cpu "
                           "to train on the CPU")
    arch = registry.get(args.arch)
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

    cell = build_cell(arch, shape_name)
    gen = torch.Generator(device).manual_seed(0)
    if arch.family == "lm":
        model = lm_mod.init_lm(cell.arch.model, gen, device)
        batches = _lm_batches(arch.model, cell.shape)
    elif arch.family == "gnn":
        model = gnn_mod.init_gnn(cell.arch.model, gen, device)
        batches = _gnn_batches(cell.shape)
    else:
        model = rec_mod.init_recsys(cell.arch.model, gen, device)
        batches = _rec_batches(cell.arch.model)
    opt_state = opt_init(model, arch.opt)
    out = train_loop(
        cell.fn, model, opt_state,
        Prefetcher(batches, lambda b: to_device(b, device)),
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=max(args.steps // 2, 1), log_every=10),
    )
    print(f"final loss {out['losses'][-1]:.4f} after {out['last_step'] + 1} "
          f"steps; stragglers flagged: {len(out['stragglers'])}")
    return out


if __name__ == "__main__":
    main()
