"""Cells: one step function per (architecture × input shape), the
reference's ``repro.launch.steps`` for the LM family on one device.

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
from ..models import transformer as lm_mod
from ..train.optimizer import opt_init, opt_update

# where the other families wait (ROADMAP queue 1)
WAITING = {
    "gnn": "models/gnn.py waits (ROADMAP queue 1, item 2.3)",
    "recsys": "models/recsys.py waits (ROADMAP queue 1, item 2.3)",
    "cf": "the CF cells wait with launch/dryrun.py (ROADMAP queue 1, item "
          "2.5); fit and serve CF through launch/serve.py",
}


@dataclasses.dataclass
class Cell:
    arch: ArchConfig
    shape: ShapeSpec
    fn: Callable
    args: Tuple[Any, ...]  # example inputs on the meta device


def _meta_model(cfg) -> lm_mod.LM:
    return lm_mod.LM(cfg, device="meta")


def value_and_grad(model: lm_mod.LM, batch: Dict[str, torch.Tensor]):
    """(loss, {parameter name: gradient}) of ``lm_loss`` at ``batch``,
    through ``torch.autograd.grad`` (nothing accumulates in ``.grad``)."""
    names, params = zip(*model.named_parameters())
    loss = lm_mod.lm_loss(model, batch)
    grads = torch.autograd.grad(loss, params)
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


def build_cell(arch: ArchConfig, shape_name: str,
               variant: str = "base") -> Cell:
    """The cell of ``arch`` at its shape ``shape_name``. ``variant``, for a
    decode shape: ``landmark`` (O(n) landmark decode) or ``kv_int8`` (the
    int8 KV cache). Families other than the LM raise NotImplementedError,
    naming where they wait."""
    shape = arch.shape(shape_name)
    if arch.family != "lm":
        raise NotImplementedError(
            f"build_cell: the {arch.family!r} family is not ported: "
            + WAITING.get(arch.family, "unknown family"))
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
