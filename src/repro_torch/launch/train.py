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
ROADMAP B10). ``ogb_products`` does not fit one card and raises in one
process, naming the dry run's bytes a device at 16×16 (:func:`ogb_waits`):
it trains on a mesh of cards of its own. The
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

The LM, the GNN and the recsys models train sharded over a mesh of ranks
under ``torchrun`` (one process a rank, ``launch/dist.py::init``; the
arch's rules place the parameters, the optimizer state and each batch,
``launch/steps.py``: a table's rows over ``model``, a GNN batch's nodes
over ``data`` and its edges over every axis, a recsys batch over every
axis): ``--production-mesh`` (16×16, or 2×16×16 with ``--multi-pod``),
``--debug-mesh`` (2×4, or 2×2×2 with ``--multi-pod``) or ``--mesh
data=2,model=2``, e.g.

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch smollm-360m --smoke --debug-mesh --steps 4 --ckpt-dir D
    torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch fm --smoke --debug-mesh --device cpu

A world whose size is not the mesh's raises, naming both. Checkpoints are
written by every rank and resume on any mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
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
from .steps import (build_cell, gnn_batch_specs, gnn_host_batch,
                    place_params, place_specs, place_tree, rec_batch_specs,
                    rec_host_batch, rec_rows, smoke_shape)


def ogb_waits() -> str:
    """Why ``ogb_products`` does not train in one process, with the dry
    run's per-device bytes of its cell at 16×16 (counted here, on meta,
    in a fake group of 256)."""
    from .dryrun import run_cell

    names, sizes = PRODUCTION
    with dist.fake_group(math.prod(sizes)):
        rec = run_cell("gatedgcn", "ogb_products", verbose=False,
                       mesh=device_mesh(names, sizes, "cpu"))
    mem = rec["memory"]
    per = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    coll = sum(v for k, v in rec["collectives"].items()
               if not k.startswith("_"))
    return (
        f"launch.train: ogb_products (2,449,029 nodes, 61,859,140 edges) "
        f"does not fit one card: one (E, 70) f32 edge tensor is 61.86 M x "
        f"70 x 4 B = 17.3 GB, and per-layer remat keeps 16 carries of e "
        f"(about 277 GB for the step). Edge-sharded over the 16x16 mesh "
        f"(launch.dryrun) a device holds {per / 1e9:.3f} GB of arguments + "
        f"temps ({mem['argument_size_in_bytes']} + "
        f"{mem['temp_size_in_bytes']} bytes) and moves {coll:.4g} "
        f"collective bytes a step: it trains on a mesh of cards of its own "
        f"(torchrun --production-mesh); the 8 ranks of one card share "
        f"that card's memory{_card_memory()}, too little for the step.")


def _card_memory() -> str:
    """`` (N GB)``: the visible card's memory, or nothing without one."""
    if not torch.cuda.is_available():
        return ""
    return f" ({torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB)"


def _lm_batches(cfg, shape: ShapeSpec):
    b, s = shape.dims["batch"], shape.dims["seq"]
    step = 0
    while True:
        yield S.lm_batch(0, step, b, s, cfg.vocab)
        step += 1


def _gnn_batches(shape: ShapeSpec):
    """Each GNN shape's own generator, deterministic in the step."""
    step = 0
    while True:
        yield gnn_host_batch(shape, step)
        step += 1


def _rec_batches(cfg):
    """The reference's recsys batches (``launch/train.py::_batches``):
    :func:`~repro_torch.launch.steps.rec_rows` rows a step,
    deterministic in the step."""
    step = 0
    while True:
        yield rec_host_batch(cfg, 0, step, rec_rows(cfg))
        step += 1


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
    if arch.family == "cf":
        raise ValueError(f"launch.train: {args.arch!r} fits rather than "
                         f"trains: serve it with launch.serve --workload cf, "
                         f"or run its cf_fit cell (launch/steps.py)")
    shape_name = args.shape or arch.shapes[0].name
    if (arch.family == "gnn" and shape_name == "ogb_products"
            and axes is None):
        raise NotImplementedError(ogb_waits())
    if args.smoke:
        arch = dataclasses.replace(arch, model=arch.smoke_model, grad_accum={},
                                   shapes=(smoke_shape(arch, shape_name),))
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
    cfg = cell.arch.model
    if arch.family == "lm":
        model = lm_mod.init_lm(cfg, gen, device)
        batches = _lm_batches(arch.model, cell.shape)
        logical = lm_mod.param_logical(cfg)
        if mesh is not None:
            accum = arch.grad_accum.get(shape_name, 1)
            tok = ("null", "batch", "null") if accum > 1 else ("batch", "null")
            put = lambda b: place_tree(  # noqa: E731
                to_device(_micro(b, accum), device),
                {"tokens": tok, "labels": tok}, arch.rules, mesh)
    else:
        if arch.family == "gnn":
            model = gnn_mod.init_gnn(cfg, gen, device)
            batches = _gnn_batches(cell.shape)
            logical, specs = gnn_mod.param_logical(cfg), gnn_batch_specs
        else:
            model = rec_mod.init_recsys(cfg, gen, device)
            batches = _rec_batches(cfg)
            logical, specs = rec_mod.param_logical(cfg), rec_batch_specs
        if mesh is not None:
            put = lambda b: place_specs(  # noqa: E731
                to_device(b, device), specs(b, mesh), mesh)
    if mesh is not None:
        place_params(model, logical, arch.rules, mesh)
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
