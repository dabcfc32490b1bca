"""An LM's train steps on a mesh of ranks, one process a rank: what the
tests and ``chip_smoke.py``'s multi-process phase run through
``launch/dist.py::spawn``.

:func:`lm_train` builds the arch's model from a seed on the rank's
device, places it, its optimizer state and each batch on the mesh
(``launch/steps.py``), runs the train cell's step and reports the
losses, the kernels' launches and the collectives by step, the step
times and the peak memory; with ``mesh=None`` it is the same run in one
process, the comparison the mesh is held to.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

import torch

from ..configs import registry
from ..configs.base import ShapeSpec
from ..data import synthetic
from ..distributed.sharding import DTensor
from ..kernels import cost, ops
from ..models import transformer as lm_mod
from ..train.optimizer import opt_init
from . import dist as dist_mod
from . import steps
from .mesh import device_mesh


def _whole_cpu(t: torch.Tensor) -> torch.Tensor:
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().float().cpu()


def smoke_arch(name: str, layers: Optional[int] = None,
               dtype: Optional[torch.dtype] = None, backend: str = "full",
               smoke: bool = True, batch: int = 4, seq: int = 64):
    """The arch with its smoke model (or its model), at ``layers`` and
    ``dtype`` if given, the attention ``backend``, one train shape of
    (batch, seq) and no gradient accumulation."""
    arch = registry.get(name)
    cfg = arch.smoke_model if smoke else arch.model
    over = {"attn_backend": backend}
    if layers is not None:
        over["n_layers"] = layers
    if dtype is not None:
        over["dtype"] = dtype
    cfg = dataclasses.replace(cfg, **over)
    shape = ShapeSpec("train", "train", dict(batch=batch, seq=seq))
    return dataclasses.replace(arch, model=cfg, shapes=(shape,),
                               grad_accum={})


def lm_train(launch, arch, *, mesh_axes: Optional[Sequence] = None,
             steps_n: int = 1, seed: int = 0, want_grads: bool = False,
             want_params: bool = False, leaves: Optional[Sequence[str]] = None,
             keep: bool = False) -> Dict:
    """Train ``arch`` (one train shape) ``steps_n`` steps from
    ``init_lm(seed)`` on ``synthetic.lm_batch(seed, step)`` batches.

    ``launch`` is the rank's ``launch/dist.py::Launch`` (its device) or a
    device for the one-process run; ``mesh_axes`` = (names, sizes) lays a
    ``DeviceMesh`` over the world. Returns, on every rank: ``losses``,
    ``launches`` (by wrapper, a step each), ``collectives`` (kind ->
    issued bytes, counts, moved bytes, a step each), ``step_ms``,
    ``peak_bytes`` (the card's peak allocation, 0 on the CPU), and with
    ``want_grads`` / ``want_params`` step 1's whole gradients and the
    whole parameters after the last step, on the CPU, by name (only those
    named in ``leaves`` if given); with ``keep`` the trained ``model`` and
    ``opt_state`` themselves."""
    device = getattr(launch, "device", launch)
    device = torch.device(device)
    cfg, shape = arch.model, arch.shapes[0]
    mesh = (device_mesh(*mesh_axes, device=device.type)
            if mesh_axes is not None else None)
    gen = torch.Generator(device).manual_seed(seed)
    model = lm_mod.init_lm(cfg, gen, device)
    rules = arch.rules if mesh is not None else None
    if mesh is not None:
        steps.place_params(model, lm_mod.param_logical(cfg), rules, mesh)
    opt_state = opt_init(model, arch.opt)
    cell = steps.build_cell(arch, shape.name, mesh=mesh)
    tok = ("batch", "null")
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    out = {"losses": [], "launches": [], "collectives": [], "step_ms": []}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for i in range(steps_n):
        host = synthetic.lm_batch(seed, i, shape.dims["batch"],
                                  shape.dims["seq"], cfg.vocab)
        batch = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
        if mesh is not None:
            batch = steps.place_tree(batch, {"tokens": tok, "labels": tok},
                                     rules, mesh)
        if want_grads and i == 0:
            loss_fn = (lambda m, b: lm_mod.lm_loss(m, b, rules))
            _, grads = steps.value_and_grad(model, batch, loss_fn)
            out["grads"] = {n: _whole_cpu(g) for n, g in grads.items()
                            if leaves is None or n in leaves}
            del grads
        ops.reset_launches()
        dist_mod.reset_moved()
        sync()
        t0 = time.perf_counter()
        with cost.tally() as tally:
            model, opt_state, metrics = cell.fn(model, opt_state, batch)
            loss = float(metrics["loss"])
            sync()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["losses"].append(loss)
        out["launches"].append(ops.launch_counts())
        out["collectives"].append({
            kind: {"count": c, "bytes": b,
                   "moved": dist_mod.MOVED.get(kind, 0)}
            for kind, (c, b) in tally["collectives"].items()})
        out["moved"] = dict(dist_mod.MOVED)
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
    if want_params:
        out["params"] = {n: _whole_cpu(p)
                         for n, p in model.named_parameters()
                         if leaves is None or n in leaves}
    if keep:
        out["model"], out["opt_state"] = model, opt_state
    return out


def lm_serve(launch, arch, *, mesh_axes: Optional[Sequence] = None,
             batch: int = 4, prompt: int = 32, tokens: int = 3,
             seed: int = 0) -> Dict:
    """Prefill a prompt, then decode ``tokens`` greedy tokens over the
    exact cache and over a landmark cache (random landmark keys and
    queries from seeds 1 and 2, as ``launch/serve.py`` makes them), with
    the arch's rules on a mesh. Returns the whole outputs on the CPU:
    ``prefill_logits``, ``cache_k``, ``decode_logits`` and
    ``landmark_logits`` (a list a step)."""
    device = torch.device(getattr(launch, "device", launch))
    cfg = arch.model
    mesh = (device_mesh(*mesh_axes, device=device.type)
            if mesh_axes is not None else None)
    rules = arch.rules if mesh is not None else None
    model = lm_mod.init_lm(cfg, torch.Generator(device).manual_seed(seed),
                           device)
    g = torch.Generator().manual_seed(seed + 7)
    toks = torch.randint(0, cfg.vocab, (batch, prompt), generator=g,
                         dtype=torch.int32).to(device)
    lcache = lm_mod.make_landmark_cache(cfg, batch, device)
    for key, s in (("k_lm", 1), ("q_lm", 2)):
        gen = torch.Generator(device).manual_seed(s)
        lcache[key] = torch.randn(lcache[key].shape, generator=gen,
                                  device=device).to(cfg.dtype)
    tok_la = {"t": ("batch", "null")}
    if mesh is not None:
        steps.place_params(model, lm_mod.param_logical(cfg), rules, mesh)
        toks = steps.place_tree({"t": toks}, tok_la, rules, mesh)["t"]
        lcache = steps.place_tree(lcache, lm_mod.landmark_cache_logical(),
                                  rules, mesh)
    out: Dict = {"decode_logits": [], "landmark_logits": []}
    with torch.no_grad():
        logits, cache = lm_mod.lm_prefill(model, toks, max_seq=prompt + tokens,
                                          rules=rules)
        out["prefill_logits"] = _whole_cpu(logits)
        out["cache_k"] = _whole_cpu(cache["k"])[:, :, :prompt]
        tok = _whole_cpu(logits)[:, -1:].argmax(-1).to(torch.int32)
        for _ in range(tokens):
            t = tok.to(device)
            if mesh is not None:
                t = steps.place_tree({"t": t}, tok_la, rules, mesh)["t"]
            logits, cache = lm_mod.lm_decode_step(model, cache, t, rules)
            logits_l, lcache = lm_mod.lm_landmark_decode_step(model, lcache,
                                                              t, rules)
            out["decode_logits"].append(_whole_cpu(logits))
            out["landmark_logits"].append(_whole_cpu(logits_l))
            tok = _whole_cpu(logits).argmax(-1).to(torch.int32)
    return out


def lm_checkpoint(launch, arch, directory: str, *, save_axes=None,
                  restore_axes=None, steps_n: int = 1) -> Dict:
    """Train ``steps_n`` steps on the ``save_axes`` mesh and save the
    training checkpoint ``(param_tree(model), opt_state)``; restore it
    onto the ``restore_axes`` mesh (a model and state placed there). Every
    rank returns the whole leaves of both, on the CPU, in flatten
    order."""
    from ..models.convert import param_tree
    from ..train.checkpoint import (_flatten, restore_checkpoint,
                                    save_checkpoint)

    device = torch.device(getattr(launch, "device", launch))
    out = {}
    if save_axes is not None:
        r = lm_train(launch, arch, mesh_axes=save_axes, steps_n=steps_n,
                     keep=True)
        tree = (param_tree(r["model"]), r["opt_state"])
        save_checkpoint(directory, steps_n, tree)
        out["saved"] = [_whole_cpu(x) for x in _flatten(tree)]
    if restore_axes is not None:
        mesh = device_mesh(*restore_axes, device=device.type)
        model = lm_mod.LM(arch.model, device)
        steps.place_params(model, lm_mod.param_logical(arch.model),
                           arch.rules, mesh)
        tree = restore_checkpoint(directory, (param_tree(model),
                                              opt_init(model, arch.opt)),
                                  device=device)
        out["restored"] = [_whole_cpu(x) for x in _flatten(tree)]
        out["placements"] = [str(getattr(x, "placements", None))
                             for x in _flatten(tree)]
    return out


def train_rank(launch, arch, mesh_axes, steps_n: int,
               leaves: Sequence[str] = ()) -> Dict:
    """:func:`lm_train` in a rank of ``launch/dist.py::spawn``, with the
    rank's place (backend and why, device, the collectives built from
    others) beside its report; with ``leaves``, those parameters' step-1
    gradients and last parameters, whole, in rank 0's report (every rank
    gathers them)."""
    out = lm_train(launch, arch, mesh_axes=mesh_axes, steps_n=steps_n,
                   want_grads=bool(leaves), want_params=bool(leaves),
                   leaves=leaves)
    if launch.rank != 0:
        out.pop("grads", None)
        out.pop("params", None)
    out.update(rank=launch.rank, device=str(launch.device),
               backend=launch.backend, reason=launch.reason,
               built=list(launch.built))
    return out
