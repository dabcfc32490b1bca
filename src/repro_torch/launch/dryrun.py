"""Dry run: build every (architecture × input shape) cell on ``meta`` and
count what its step costs, with no memory and no arithmetic.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--debug-mesh] [--multi-pod] [--smoke] [--family F] [--skip-paper-native] [--out DIR] [--full-depth]

The reference's ``repro.launch.dryrun`` lowers and compiles each cell on a
512-device host mesh and reads XLA's cost and memory analyses. The port
runs each cell's step once on ``meta`` tensors inside
``launch/step_costs.py::measure`` (the counterpart of ``launch/hlo.py``):
the kernel wrappers return outputs of the right shapes and charge their
formulas (``kernels/cost.py``) without launching, the host steps that
read data take sizes from the cell's dims (``kernels/segment_sum.py``'s
meta CSR). A model of identical layers runs at depths 2 and 3 (and a
step of many micro-batches at 2 and 3 of them), and its counts are taken
to the cell on the line through them (:func:`count_cell`). One record a
cell, with the reference's keys where they mean something here: ``mesh``
and ``n_devices``, ``trace_s`` in place of ``lower_s`` and ``compile_s``,
``flops``, ``bytes_accessed`` (unfused), ``collectives`` and ``memory``.
It runs on the CPU and needs no card.

The LM, GNN and recsys cells are laid over the reference's meshes: its
16×16 production mesh by default, two pods (2×16×16) with
``--multi-pod``, its 8-position debug mesh (2×4, or 2×2×2 with
``--multi-pod``) with ``--debug-mesh``. One process sets up torch's
in-process ``fake`` group of the mesh's size
(``launch/dist.py::fake_group``), places each cell's parameters, state,
cache and batch as DTensors on ``meta`` by the arch's rules
(``launch/steps.py``: an LM's batch over ``data``, a GNN's nodes over
``data`` and edges over every axis, a recsys batch over every axis, the
tables' rows over ``model``) and runs its step as position 0: every count
is that device's (argument bytes: its local blocks, the fullest; temp
bytes; flops and bytes of its local ops) and ``collectives`` counts every
functional collective DTensor issues by its output bytes, the reference's
``launch/hlo.py`` convention. The CF cells keep their one-device record
(``n_devices`` 1), as in the reference; the run prints so. The fake group
is destroyed after the run. A cell that fails fails the run (exit code
1), as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import traceback
from pathlib import Path

from ..configs import registry
from . import dist
from ..distributed.sharding import mesh_axes
from .mesh import (DEBUG, DEBUG_MULTI_POD, MULTI_POD, PRODUCTION,
                   make_debug_mesh, make_production_mesh)
from .step_costs import StepCosts, measure, storage_bytes
from .steps import COMM_MESH, build_cell

DEPTHS = (2, 3)  # the depths a deeper model's step runs at
MICRO_BATCHES = (2, 3)  # and a step of more micro-batches
# the families whose cells are laid over the mesh (the CF cells run on one
# device, as the reference's)
MESH_FAMILIES = ("lm", "gnn", "recsys")
UNFUSED = ("every operation's inputs and outputs summed, unfused, plus the "
           "kernels' formulas (kernels/cost.py)")


def _scaled(arch, shape_name: str, layers: int, accum: int):
    """The arch at ``layers`` layers, its shape at ``accum`` micro-batches
    of the full cell's micro-batch."""
    shape = arch.shape(shape_name)
    full = arch.grad_accum.get(shape_name, 1)
    dims = dict(shape.dims)
    if accum != full:
        dims["batch"] = dims["batch"] // full * accum
    model = (arch.model if layers is None
             else dataclasses.replace(arch.model, n_layers=layers))
    return dataclasses.replace(
        arch, model=model, shapes=(dataclasses.replace(shape, dims=dims),),
        grad_accum={shape_name: accum})


def count_cell(arch, shape_name: str, variant: str = "base",
               full_depth: bool = False, mesh=None):
    """(the cell's StepCosts, its model's layers, the (layers, micro-
    batches) pairs traced).

    A model of more than three identical layers (the LMs and the GNN at
    full depth) runs its step at ``DEPTHS``, and a step of more than three
    micro-batches at ``MICRO_BATCHES``: each count is taken to the cell on
    the line (the plane) through them, since a layer and a micro-batch
    each add the same operations, bytes, launches, collectives and held
    activations wherever they stand. Neither the first layer (a prefill's
    peak grows by more at depth 1 → 2 than after) nor a lone micro-batch
    (a step of one accumulates nothing) is on that line, so the lines
    start at 2. The temp bytes go on the depth line of the runs of the
    fewest micro-batches: a micro-batch frees its activations before the
    next starts, so the peak does not grow with their number. The
    argument bytes are the full cell's, counted from its inputs.
    ``full_depth`` traces the whole cell instead. ``mesh``: the cell's
    ``DeviceMesh`` (per-device counts)."""
    cell = build_cell(arch, shape_name, variant, mesh)
    layers = getattr(arch.model, "n_layers", None)
    accum = arch.grad_accum.get(shape_name, 1)
    deep = (layers or 0) > max(DEPTHS)
    ls = DEPTHS if deep else (layers,)
    accs = MICRO_BATCHES if accum > max(MICRO_BATCHES) else (accum,)
    if mesh is not None:
        # DTensor's first call of an op on new placements runs its sharding
        # propagation and a slow path that the counts must not see: one
        # untimed step of the cell's smallest form first
        warm = (cell if full_depth else build_cell(
            _scaled(arch, shape_name, ls[0], accs[0]), shape_name, variant,
            mesh))
        measure(warm.fn, warm.args)
    if full_depth or (not deep and accum <= max(MICRO_BATCHES)):
        return measure(cell.fn, cell.args)[1], layers, [(layers, accum)]
    runs = {}
    for lay in ls:
        for acc in accs:
            c = build_cell(_scaled(arch, shape_name, lay, acc), shape_name,
                           variant, mesh)
            runs[lay, acc] = measure(c.fn, c.args)[1]

    def weights(points, x):  # the line through one or two points at x
        if len(points) == 1:
            return {points[0]: 1.0}
        a, b = points
        return {a: (b - x) / (b - a), b: (x - a) / (b - a)}

    wl, wa = weights(ls, layers), weights(accs, accum)
    costs = StepCosts.combine([(wl[lay] * wa[acc], c)
                               for (lay, acc), c in runs.items()])
    costs.memory["temp_size_in_bytes"] = int(sum(
        wl[lay] * runs[lay, accs[0]].memory["temp_size_in_bytes"]
        for lay in ls))
    costs.memory["argument_size_in_bytes"] = storage_bytes(cell.args)
    return costs, layers, sorted(runs)


def run_cell(arch_name: str, shape_name: str, variant: str = "base",
             verbose: bool = True, full_depth: bool = False,
             mesh=None, smoke: bool = False) -> dict:
    """Build the cell on ``meta``, count its step and return its record;
    an LM, GNN or recsys cell over ``mesh`` (a ``DeviceMesh``) when one is
    given; with
    ``smoke`` the arch's smoke model at the cell's shape."""
    arch = registry.get(arch_name)
    if smoke:
        arch = dataclasses.replace(arch, model=arch.smoke_model)
    if arch.family not in MESH_FAMILIES:
        mesh = None
    c, layers, traced = count_cell(arch, shape_name, variant, full_depth,
                                   mesh)
    if mesh is not None:
        sizes, n_dev = tuple(mesh_axes(mesh).values()), mesh.size()
    else:
        sizes, n_dev = COMM_MESH[1] if variant == "comm" else (1, 1), 1
    rec = {
        "arch": arch_name,
        "shape": shape_name,
        "variant": variant,
        "mesh": "x".join(map(str, sizes)),
        "n_devices": n_dev,
        "trace_s": round(c.seconds, 3),
        "layers": layers,
        "layers_traced": traced,
        "flops": c.flops,
        "matmul_flops": c.matmul_flops,
        "kernel_ops": c.kernel_ops,
        "bytes_accessed": c.bytes_accessed,
        "bytes_accessed_note": UNFUSED,
        "collectives": c.collectives,
        "memory": c.memory,
        "kernels": c.kernels,
    }
    if verbose:
        mem = rec["memory"]
        coll = sum(v for k, v in c.collectives.items()
                   if not k.startswith("_"))
        print(f"[OK] {arch_name}/{shape_name}/{variant} mesh={rec['mesh']} "
              f"trace={c.seconds:.2f}s flops={c.flops:.3e} "
              f"bytes={c.bytes_accessed:.3e} "
              f"args={mem['argument_size_in_bytes'] / 1e9:.3f}GB "
              f"temp={mem['temp_size_in_bytes'] / 1e9:.3f}GB "
              f"coll_bytes={coll:.3e} kernels="
              f"{ {k: v['calls'] for k, v in c.kernels.items()} }",
              flush=True)
    return rec


def all_cells():
    """Every (arch, shape, variant) cell: each shape, plus ``landmark``
    where the shape has ``landmark_variant``."""
    cells = []
    for name, arch in registry.ARCHS.items():
        for s in arch.shapes:
            cells.append((name, s.name, "base"))
            if s.dims.get("landmark_variant"):
                cells.append((name, s.name, "landmark"))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--variant", default="base")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--debug-mesh", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-paper-native", action="store_true")
    ap.add_argument("--family", default=None,
                    help="with --all: only this family's cells (lm, gnn, "
                    "recsys, cf)")
    ap.add_argument("--smoke", action="store_true",
                    help="each arch's smoke model at its cells' shapes")
    ap.add_argument("--full-depth", action="store_true",
                    help="trace every layer and micro-batch (slow at full "
                    "depth) instead of taking the counts to them")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --all (with --arch: that arch's cells), or --arch "
                 "and --shape")
    if args.debug_mesh:
        names, sizes = DEBUG_MULTI_POD if args.multi_pod else DEBUG
        make = make_debug_mesh
    else:
        names, sizes = MULTI_POD if args.multi_pod else PRODUCTION
        make = make_production_mesh
    print(f"mesh axes={names} shape={sizes}: the {', '.join(MESH_FAMILIES)} "
          f"cells' placements on a fake group of {math.prod(sizes)}",
          flush=True)

    if args.all:
        cells = all_cells()
        if args.skip_paper_native:
            cells = [c for c in cells if registry.get(c[0]).family != "cf"]
        if args.family:
            cells = [c for c in cells
                     if registry.get(c[0]).family == args.family]
        if args.arch:
            cells = [c for c in cells if c[0] == args.arch]
    else:
        cells = [(args.arch, args.shape, args.variant)]
    waiting = sorted({registry.get(c[0]).family for c in cells}
                     - set(MESH_FAMILIES))
    if waiting:
        print(f"one device (as the reference's): {', '.join(waiting)} cells",
              flush=True)

    records, failures = [], []
    with dist.fake_group(math.prod(sizes)):
        mesh = make(multi_pod=args.multi_pod, device="cpu", dist=True)
        for arch_name, shape_name, variant in cells:
            try:
                records.append(run_cell(arch_name, shape_name, variant,
                                        full_depth=args.full_depth,
                                        mesh=mesh, smoke=args.smoke))
            except Exception as e:  # noqa: BLE001 — a failed cell is a bug to report
                failures.append((arch_name, shape_name, variant, repr(e)))
                print(f"[FAIL] {arch_name}/{shape_name}/{variant}: {e}",
                      flush=True)
                traceback.print_exc()

    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        tag = "multipod" if args.multi_pod else "singlepod"
        (out / f"dryrun_{tag}.json").write_text(json.dumps(records,
                                                           indent=1))
        print(f"wrote {out}/dryrun_{tag}.json ({len(records)} cells)")
    if failures:
        print(f"{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print(f"all {len(records)} cells traced OK")
    return records


if __name__ == "__main__":
    main()
