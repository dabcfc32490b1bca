"""Dry run: build every (architecture × input shape) cell on ``meta`` and
count what its step costs, with no memory and no arithmetic.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--skip-paper-native] [--out DIR] [--full-depth]

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
and ``n_devices`` (one device: the port's cells carry no shardings),
``trace_s`` in place of ``lower_s`` and ``compile_s``, ``flops``,
``bytes_accessed`` (unfused), ``collectives`` and ``memory``. It runs on
the CPU and needs no card.

The reference's ``--multi-pod`` and ``--debug-mesh`` lay a cell's
shardings over a mesh; they wait for the logical-axis layer and raise.
A cell that fails fails the run (exit code 1), as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import traceback
from pathlib import Path

from ..configs import registry
from .step_costs import StepCosts, measure, storage_bytes
from .steps import COMM_MESH, build_cell

DEPTHS = (2, 3)  # the depths a deeper model's step runs at
MICRO_BATCHES = (2, 3)  # and a step of more micro-batches
MESH_WAITS = ("launch.dryrun: --multi-pod and --debug-mesh lay a cell's "
              "shardings over a mesh, which waits for the logical-axis layer "
              "with the multi-process launcher (ROADMAP queue 1, item 4)")
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
               full_depth: bool = False):
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
    ``full_depth`` traces the whole cell instead."""
    cell = build_cell(arch, shape_name, variant)
    layers = getattr(arch.model, "n_layers", None)
    accum = arch.grad_accum.get(shape_name, 1)
    deep = (layers or 0) > max(DEPTHS)
    if full_depth or (not deep and accum <= max(MICRO_BATCHES)):
        return measure(cell.fn, cell.args)[1], layers, [(layers, accum)]
    ls = DEPTHS if deep else (layers,)
    accs = MICRO_BATCHES if accum > max(MICRO_BATCHES) else (accum,)
    runs = {}
    for lay in ls:
        for acc in accs:
            c = build_cell(_scaled(arch, shape_name, lay, acc), shape_name,
                           variant)
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
             verbose: bool = True, full_depth: bool = False) -> dict:
    """Build the cell on ``meta``, count its step and return its
    record."""
    c, layers, traced = count_cell(registry.get(arch_name), shape_name,
                                   variant, full_depth)
    mesh = COMM_MESH[1] if variant == "comm" else (1, 1)
    rec = {
        "arch": arch_name,
        "shape": shape_name,
        "variant": variant,
        "mesh": "x".join(map(str, mesh)),
        "n_devices": 1,
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
    ap.add_argument("--full-depth", action="store_true",
                    help="trace every layer and micro-batch (slow at full "
                    "depth) instead of taking the counts to them")
    args = ap.parse_args(argv)
    if args.multi_pod or args.debug_mesh:
        raise NotImplementedError(MESH_WAITS)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --all, or --arch and --shape")
    print("mesh axes=('data', 'model') shape=(1, 1): one device, the cells "
          "carry no shardings", flush=True)

    if args.all:
        cells = all_cells()
        if args.skip_paper_native:
            cells = [c for c in cells if registry.get(c[0]).family != "cf"]
    else:
        cells = [(args.arch, args.shape, args.variant)]

    records, failures = [], []
    for arch_name, shape_name, variant in cells:
        try:
            records.append(run_cell(arch_name, shape_name, variant,
                                    full_depth=args.full_depth))
        except Exception as e:  # noqa: BLE001 — a failed cell is a bug to report
            failures.append((arch_name, shape_name, variant, repr(e)))
            print(f"[FAIL] {arch_name}/{shape_name}/{variant}: {e}",
                  flush=True)
            traceback.print_exc()

    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "dryrun_singlepod.json").write_text(json.dumps(records,
                                                              indent=1))
        print(f"wrote {out}/dryrun_singlepod.json ({len(records)} cells)")
    if failures:
        print(f"{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print(f"all {len(records)} cells traced OK")
    return records


if __name__ == "__main__":
    main()
