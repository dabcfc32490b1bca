"""Training launcher: ``python -m repro_torch.launch.train --arch smollm-360m
[--shape train_4k] [--steps N] [--smoke] [--ckpt-dir D] [--device cpu]``.

The reference's ``repro.launch.train`` for the LM family, on one device:
builds the arch's train cell (``launch/steps.py``), random weights from
``torch.Generator`` seed 0, the arch's optimizer, and runs
``train/trainer.py::train_loop`` on ``data/synthetic.py::lm_batch``
batches, checkpointing every ``steps // 2`` steps and resuming from the
latest checkpoint in ``--ckpt-dir``. ``--smoke`` swaps in the arch's smoke
model, a (4, 128) batch and no gradient accumulation, as the reference's.
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
from ..models import transformer as lm_mod
from ..train.optimizer import opt_init
from ..train.trainer import Prefetcher, TrainerConfig, to_device, train_loop
from .steps import build_cell

SMOKE_BATCH, SMOKE_SEQ = 4, 128


def _batches(cfg, shape: ShapeSpec):
    b, s = shape.dims["batch"], shape.dims["seq"]
    step = 0
    while True:
        yield S.lm_batch(0, step, b, s, cfg.vocab)
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
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch.train: no CUDA device; pass --device cpu "
                           "to train on the CPU")
    arch = registry.get(args.arch)
    if arch.family != "lm":
        raise NotImplementedError(f"launch.train: only the LM family is "
                                  f"ported, not {arch.family!r}")
    shape_name = args.shape or arch.shapes[0].name
    if args.smoke:
        arch = dataclasses.replace(arch, model=arch.smoke_model, grad_accum={})
        shape = ShapeSpec(shape_name, "train",
                          dict(batch=SMOKE_BATCH, seq=SMOKE_SEQ))
        arch = dataclasses.replace(arch, shapes=(shape,))

    cell = build_cell(arch, shape_name)
    model = lm_mod.init_lm(arch.model, torch.Generator(device).manual_seed(0),
                           device)
    opt_state = opt_init(model, arch.opt)
    out = train_loop(
        cell.fn, model, opt_state,
        Prefetcher(_batches(arch.model, cell.shape),
                   lambda b: to_device(b, device)),
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=max(args.steps // 2, 1), log_every=10),
    )
    print(f"final loss {out['losses'][-1]:.4f} after {out['last_step'] + 1} "
          f"steps; stragglers flagged: {len(out['stragglers'])}")
    return out


if __name__ == "__main__":
    main()
