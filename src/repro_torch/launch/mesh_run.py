"""Train steps on a mesh of ranks, one process a rank: what the tests
and ``chip_smoke.py``'s multi-process phases run through
``launch/dist.py::spawn``.

:func:`train` builds the arch's model from a seed on the rank's device,
places it, its optimizer state and each batch on the mesh
(``launch/steps.py``), runs the train cell's step and reports the losses,
the kernels' launches and the collectives by step, the step times and the
peak memory; with ``mesh_axes=None`` it is the same run in one process,
the comparison the mesh is held to. The batches are the train CLI's
(``launch/train.py``): ``synthetic.lm_batch``, the recsys generators
(``steps.rec_host_batch``) and each GNN shape's own
(``steps.gnn_host_batch``). :func:`ranks_run` is the spawn entry: a list
of such runs in each rank.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from ..configs import registry
from ..configs.base import ShapeSpec
from ..data import synthetic
from ..distributed.sharding import DTensor
from ..kernels import cost, ops
from ..models import gnn as gnn_mod
from ..models import recsys as rec_mod
from ..models import transformer as lm_mod
from ..train.optimizer import opt_init
from . import dist as dist_mod
from . import steps
from .mesh import device_mesh, make_mesh


def _whole_cpu(t: torch.Tensor) -> torch.Tensor:
    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().float().cpu()


def _block(t: torch.Tensor):
    """(the rank's block of ``t``: a copy in f32 on the CPU, never a view of
    a parameter that a later step updates in place; its DTensor layout
    (mesh, placements), or None for a plain tensor)."""
    if isinstance(t, DTensor):
        return (t.to_local().detach().to("cpu", torch.float32, copy=True),
                (t.device_mesh, tuple(t.placements)))
    return t.detach().to("cpu", torch.float32, copy=True), None


def _joined(block: torch.Tensor, layout) -> torch.Tensor:
    """A leaf whole on the CPU on every rank, from the ranks' blocks
    (:func:`_block`) over the process group on host memory: each sharded
    mesh dim's blocks joined in order, the innermost dim first (DTensor
    splits the outer dims first); a replicated dim moves nothing."""
    import torch.distributed as tdist

    if layout is None:
        return block
    mesh, pls = layout
    for i in reversed(range(mesh.ndim)):
        if _sharded(pls[i]):
            parts = [None] * mesh.size(i)
            tdist.all_gather_object(parts, block, group=mesh.get_group(i))
            block = torch.cat(parts, dim=pls[i].dim)
    return block


def _sharded(p) -> bool:
    """Whether a parameter's placement on a mesh dim splits it (a plain
    ``Shard``) or not (``Replicate``); any other raises."""
    from torch.distributed.tensor import Replicate, Shard

    if type(p) not in (Shard, Replicate):
        raise ValueError(f"mesh_run: a parameter placed {p}")
    return type(p) is Shard


def _rank_block(whole: torch.Tensor, mesh, pls) -> torch.Tensor:
    """This rank's block of ``whole`` under placements ``pls``, as DTensor
    splits it: each sharded mesh dim in order takes its coordinate's
    ``torch.chunk`` (empty past the last chunk)."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(pls):
        if _sharded(p):
            chunks = torch.chunk(whole, mesh.size(i), dim=p.dim)
            whole = (chunks[coord[i]] if coord[i] < len(chunks)
                     else whole.narrow(p.dim, 0, 0))
    return whole


def _held(block: torch.Tensor, layout, ref: torch.Tensor) -> list:
    """[Σ (block - ref)², Σ ref², replica] over this rank's block of a leaf
    and the same block of ``ref`` (the leaf whole), in f64, and which copy
    of the leaf the block belongs to: its coordinates on the mesh dims
    that replicate the leaf (:func:`held` adds one copy's blocks)."""
    replica = ()
    if layout is not None:
        mesh, pls = layout
        ref = _rank_block(ref, mesh, pls)
        replica = tuple(c for c, p in zip(mesh.get_coordinate(), pls)
                        if not _sharded(p))
    ref = ref.double()
    diff = block.double() - ref
    return [float((diff * diff).sum()), float((ref * ref).sum()), replica]


def held(reports: Sequence[Dict], key: str, leaf: str) -> float:
    """|run - reference| / |reference| (Frobenius) of ``leaf``'s ``key``
    (``grads``, ``params`` or ``updates``) from the ranks' reports of a
    :func:`train` run ``against`` a reference: each copy of the leaf (one
    block from each rank that holds a distinct block) summed apart, the
    largest over the copies."""
    sums: Dict[tuple, list] = {}
    for r in reports:
        diff, ref, replica = r["held"][key][leaf]
        acc = sums.setdefault(tuple(replica), [0.0, 0.0])
        acc[0] += diff
        acc[1] += ref
    return max(math.sqrt(d / r) if r else (0.0 if d == 0 else math.inf)
               for d, r in sums.values())


def smoke_arch(name: str, layers: Optional[int] = None,
               dtype: Optional[torch.dtype] = None, backend: str = "full",
               smoke: bool = True, batch: int = 4, seq: int = 64):
    """The LM arch with its smoke model (or its model), at ``layers`` and
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


def rec_arch(name: str, smoke: bool = True, batch: Optional[int] = None):
    """A recsys arch with its smoke model (or its model) and one train
    shape of ``batch`` rows (default ``steps.rec_rows``)."""
    arch = registry.get(name)
    cfg = arch.smoke_model if smoke else arch.model
    shape = ShapeSpec("train_batch", "train",
                      dict(batch=batch or steps.rec_rows(cfg)))
    return dataclasses.replace(arch, model=cfg, shapes=(shape,))


def gnn_arch(shape_name: str = "full_graph_sm", smoke: bool = True,
             layers: Optional[int] = None):
    """GatedGCN with its smoke model at the smoke shape of
    ``shape_name``, or its model at the shape itself, at ``layers`` if
    given."""
    arch = registry.get("gatedgcn")
    cfg = arch.smoke_model if smoke else arch.model
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    shape = (steps.smoke_shape(arch, shape_name) if smoke
             else arch.shape(shape_name))
    return dataclasses.replace(arch, model=cfg, shapes=(shape,))


def _init(arch, device, seed) -> torch.nn.Module:
    """The arch's model from ``seed`` on ``device``."""
    gen = torch.Generator(device).manual_seed(seed)
    if arch.family == "lm":
        return lm_mod.init_lm(arch.model, gen, device)
    if arch.family == "gnn":
        return gnn_mod.init_gnn(arch.model, gen, device)
    return rec_mod.family(arch.model).init(arch.model, gen, device)


def _host_batch(arch, variant, comm_axes, seed) -> Callable[[int], Dict]:
    """Step ``i``'s batch on the host: the train CLI's generators; a comm
    GNN batch laid out by destination over ``comm_axes``' node blocks (the
    data pipeline's contract)."""
    cfg, shape = arch.model, arch.shapes[0]
    if arch.family == "lm":
        return lambda i: synthetic.lm_batch(seed, i, shape.dims["batch"],
                                            shape.dims["seq"], cfg.vocab)
    if arch.family == "recsys":
        return lambda i: steps.rec_host_batch(cfg, seed, i,
                                              shape.dims["batch"])
    if variant != "comm":
        return lambda i: steps.gnn_host_batch(shape, i, seed)
    axes = dict(zip(*comm_axes))
    blocks = axes.get("pod", 1) * axes.get("data", 1)
    return lambda i: gnn_mod.dst_partition(
        steps.gnn_host_batch(shape, i, seed), blocks, axes.get("model", 1))


def _placer(arch, mesh) -> Callable[[Dict], Dict]:
    """A batch of whole tensors placed on ``mesh`` as the family's cells
    place it (unchanged without a mesh)."""
    if mesh is None:
        return lambda b: b
    if arch.family == "lm":
        tok = ("batch", "null")
        return lambda b: steps.place_tree(
            b, {"tokens": tok, "labels": tok}, arch.rules, mesh)
    specs = (steps.rec_batch_specs if arch.family == "recsys"
             else steps.gnn_batch_specs)
    return lambda b: steps.place_specs(b, specs(b, mesh), mesh)


def _logical(arch) -> Dict[str, tuple]:
    mod = {"lm": lm_mod, "gnn": gnn_mod, "recsys": rec_mod}[arch.family]
    return mod.param_logical(arch.model)


def _profiled(run: Callable, watch: Sequence[str]):
    """(``run()``, its kernels): ``run()`` under ``torch.profiler``, and
    how many CUDA kernels it launched and how many of them hold each name
    in ``watch``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return out, {"kernels": len(names),
                 "watched": {w: sum(w in n for n in names) for w in watch}}


def train(launch, arch, *, mesh_axes=None, variant: str = "base",
          comm_axes=None, steps_n: int = 1, seed: int = 0,
          want_grads: bool = False, want_params: bool = False,
          want_updates: bool = False, leaves: Optional[Sequence[str]] = None,
          against: Optional[str] = None, keep: bool = False,
          watch: Sequence[str] = ()) -> Dict:
    """Train ``arch`` (one train shape) ``steps_n`` steps from the
    family's init at ``seed`` on the train CLI's batches: an LM on
    ``synthetic.lm_batch``, a recsys arch on its ``batch`` rows a step
    (the tables' rows over ``model``, the batch over every axis where it
    divides them), GatedGCN on its shape's generator, the ``base`` or
    ``comm`` ``variant``.

    ``launch`` is the rank's ``launch/dist.py::Launch`` (its device) or a
    device for the one-process run; ``mesh_axes`` = (names, sizes) lays a
    ``DeviceMesh`` over the world. ``comm`` lays each batch out by
    destination (``gnn.dst_partition``) over the node blocks of the mesh,
    or without one of ``comm_axes`` (default ``steps.COMM_MESH``), where
    it is the single-process mesh form on those axes
    (``gnn_loss_sharded``).

    Returns, on every rank: ``losses``, ``launches`` (by wrapper, a step
    each), ``collectives`` (kind -> issued bytes, counts, moved bytes, a
    step each), ``step_ms``, ``peak_bytes`` (the card's peak allocation, 0
    on the CPU); with ``want_grads`` step 1's gradients (of the cell's own
    loss, before its step), with ``want_params`` the parameters after the
    last step, with ``want_updates`` those less the initial ones, each
    whole, on the CPU, by name (only those named in ``leaves`` if given);
    ``against`` a file (``torch.save``) of such whole leaves, {"grads" |
    "params" | "updates": {name: tensor}}, from another run: ``held``, the
    rank's share of each one's distance from this run's (:func:`_held`;
    :func:`held` adds the ranks' shares), where nothing crosses the ranks;
    with ``keep`` the trained ``model`` and ``opt_state`` themselves."""
    device = torch.device(getattr(launch, "device", launch))
    shape = arch.shapes[0]
    mesh = (device_mesh(*mesh_axes, device=device.type)
            if mesh_axes is not None else None)
    comm_axes = mesh_axes or comm_axes or steps.COMM_MESH
    cell_mesh = mesh
    if arch.family == "gnn" and variant == "comm" and mesh is None:
        cell_mesh = make_mesh(*comm_axes, device.type)
    cell = steps.build_cell(arch, shape.name, variant, mesh=cell_mesh)
    arch = cell.arch  # a GNN cell's model takes its shape's task and widths
    host = _host_batch(arch, variant, comm_axes, seed)
    place = _placer(arch, mesh)
    model = _init(arch, device, seed)
    if mesh is not None:
        steps.place_params(model, _logical(arch), arch.rules, mesh)
    opt_state = opt_init(model, arch.opt)

    refs = (torch.load(against, mmap=True, weights_only=True)
            if against else {})
    if refs and leaves is None:
        leaves = sorted({n for part in refs.values() for n in part})
    wanted = {"grads": want_grads, "params": want_params,
              "updates": want_updates}
    need = {k for k, on in wanted.items() if on or k in refs}
    out = {"losses": [], "launches": [], "collectives": [], "step_ms": []}

    def blocks(named):
        return {n: _block(t) for n, t in named
                if leaves is None or n in leaves}

    def record(key, named_blocks):
        if wanted[key]:
            out[key] = {n: _joined(b, layout)
                        for n, (b, layout) in named_blocks.items()}
        if key in refs:
            out.setdefault("held", {})[key] = {
                n: _held(b, layout, refs[key][n])
                for n, (b, layout) in named_blocks.items() if n in refs[key]}

    init = blocks(model.named_parameters()) if "updates" in need else {}
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    for i in range(steps_n):
        batch = place({k: torch.as_tensor(v, device=device)
                       for k, v in host(i).items()})
        if "grads" in need and i == 0:
            _, grads = steps.value_and_grad(model, batch, cell.loss)
            record("grads", blocks(grads.items()))
            del grads
        if device.type == "cuda" and i == 0:  # the steps' peak alone
            torch.cuda.reset_peak_memory_stats(device)
        ops.reset_launches()
        dist_mod.reset_moved()
        sync()
        t0 = time.perf_counter()
        with cost.tally() as tally:
            if watch and device.type == "cuda" and i == 0:
                # the first step profiled (its kernels by name); the
                # later steps' times are free of the profiler
                res, out["profile"] = _profiled(
                    lambda: cell.fn(model, opt_state, batch), watch)
            else:
                res = cell.fn(model, opt_state, batch)
            model, opt_state, metrics = res
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
    last = blocks(model.named_parameters()) if need - {"grads"} else {}
    if "params" in need:
        record("params", last)
    if "updates" in need:  # each block's update
        record("updates", {n: (b - init[n][0], layout)
                           for n, (b, layout) in last.items()})
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


def rec_serve(launch, arch, *, mesh_axes=None, seed: int = 0,
              rows: int = 8, n_candidates: int = 16, k: int = 10) -> Dict:
    """A recsys model from ``steps.rec_host_batch``'s seed scored and queried
    over the mesh (or in one process): ``scores`` of ``n_candidates``
    random items a row (FM: of the rows' own fields) and the top ``k``
    ``retrieval`` over every item (FM over ``n_candidates`` rows),
    ``rows`` rows placed as the serving cells place them. Returns the
    whole outputs on the CPU."""
    device = torch.device(getattr(launch, "device", launch))
    cfg = arch.model
    fam = rec_mod.family(cfg)
    mesh = (device_mesh(*mesh_axes, device=device.type)
            if mesh_axes is not None else None)
    model = fam.init(cfg, torch.Generator(device).manual_seed(seed), device)
    host = steps.rec_host_batch(cfg, seed, 0, rows)
    g = torch.Generator().manual_seed(seed + 1)
    n_rows = cfg.table_rows if isinstance(cfg, rec_mod.FMConfig) \
        else cfg.n_items
    batch = {k_: torch.as_tensor(v) for k_, v in host.items()
             if k_ in ("field_ids", "item_ids", "targets")}
    batch["candidates"] = torch.randint(0, n_rows, (rows, n_candidates),
                                        generator=g, dtype=torch.int32)
    batch["cand_ids"] = torch.randint(0, n_rows, (n_candidates,),
                                      generator=g, dtype=torch.int32)
    batch = {k_: v.to(device) for k_, v in batch.items()}
    if mesh is not None:
        steps.place_params(model, rec_mod.param_logical(cfg), arch.rules,
                           mesh)
        batch = steps.place_specs(batch, steps.rec_batch_specs(batch, mesh),
                                  mesh)
    with torch.no_grad():
        scores = fam.scores(model, batch)
        vals, ids = fam.retrieval(model, batch, k=k)
    return {"scores": _whole_cpu(scores), "values": _whole_cpu(vals),
            "ids": _whole_cpu(ids).long()}


def _blank(arch, device) -> torch.nn.Module:
    """The arch's model with zero parameters on ``device`` (a restore's
    target)."""
    if arch.family == "lm":
        return lm_mod.LM(arch.model, device)
    if arch.family == "gnn":
        return gnn_mod.GatedGCN(arch.model, device)
    return rec_mod.family(arch.model).cls(arch.model, device)


def train_checkpoint(launch, arch, directory: str, *, save_axes=None,
                     restore_axes=None, steps_n: int = 1,
                     variant: str = "base") -> Dict:
    """Train ``steps_n`` steps on the ``save_axes`` mesh and save the
    training checkpoint ``(param_tree(model), opt_state)``; restore it
    onto the ``restore_axes`` mesh (a model and state placed there), for
    an LM, GNN or recsys arch. Every rank returns the whole leaves of
    both, on the CPU, in flatten order."""
    from ..models.convert import param_tree
    from ..train.checkpoint import (_flatten, restore_checkpoint,
                                    save_checkpoint)

    device = torch.device(getattr(launch, "device", launch))
    out = {}
    if save_axes is not None:
        r = train(launch, arch, mesh_axes=save_axes, steps_n=steps_n,
                  variant=variant, keep=True)
        tree = (param_tree(r["model"]), r["opt_state"])
        save_checkpoint(directory, steps_n, tree)
        out["saved"] = [_whole_cpu(x) for x in _flatten(tree)]
    if restore_axes is not None:
        mesh = device_mesh(*restore_axes, device=device.type)
        model = _blank(arch, device)
        steps.place_params(model, _logical(arch), arch.rules, mesh)
        tree = restore_checkpoint(directory, (param_tree(model),
                                              opt_init(model, arch.opt)),
                                  device=device)
        out["restored"] = [_whole_cpu(x) for x in _flatten(tree)]
        out["placements"] = [str(getattr(x, "placements", None))
                             for x in _flatten(tree)]
    return out


def ranks_run(launch, cases: Sequence, mesh_axes, steps_n: int,
              watch: Sequence[str] = ()) -> Dict:
    """The spawn entry (``launch/dist.py::spawn``): several :func:`train`
    runs in a rank, one after another, the card's cache emptied between
    them. ``cases`` is a list of (tag, arch, options): each run, with
    :func:`train`'s ``options`` (``variant``, ``against``, ...), reports
    under its tag, with ``watch`` its first step's kernels by name
    (``profile``). Beside the runs: the rank's place (backend and why,
    device, the collectives built from others)."""
    import gc

    out = {}
    for tag, arch, options in cases:
        out[tag] = train(launch, arch, mesh_axes=mesh_axes, steps_n=steps_n,
                         watch=watch, **options)
        gc.collect()
        if launch.device.type == "cuda":
            torch.cuda.empty_cache()
    out.update(rank=launch.rank, device=str(launch.device),
               backend=launch.backend, reason=launch.reason,
               built=list(launch.built))
    return out
