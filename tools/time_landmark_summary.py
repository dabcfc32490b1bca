#!/usr/bin/env python3
"""Time the landmark-summary kernel (kernel 7) of one checkout on the card,
both routes, at the SmolLM-360M landmark shape of ``chip_smoke.py`` phase
8b (P = 10 problems, n = 1536 queries, S = 4096 keys, D = 64).

    python3 tools/time_landmark_summary.py [TREE ...] [--reps 2]

Each TREE is the root of a checkout (default: this one); every tree runs
in a process of its own, importing only its own ``src`` and building its
own kernels under its own ``build/kernels``. Trees run in turns, ``--reps``
rounds, first to last then last to first (old, new, new, old), so two
versions of a kernel compare within one call on one card. Per run it
prints one JSON line: the tree, the route, the max |err| against the plain
version, CUDA-event ms per call over 50 calls after warm-up (host launch
cost included) and the kernel's own device ms per call from a
``torch.profiler`` trace of 20 calls, the f32 route's split passes
included (null when the trace holds no device events), and the split
passes' share of it alone. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPE = (10, 1536, 4096, 64)  # (P, n, S, D)


def _one(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops, ref

    def event_ms(fn, iters):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def device_ms(fn, iters=20):
        """(all of the route's kernels, the split passes alone), ms/call"""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [(e.name, e.time_range.end - e.time_range.start)
                 for e in prof.events() if e.device_type == DeviceType.CUDA]
        total = sum(t for name, t in spans
                    if "summary" in name or "split_terms" in name)
        split = sum(t for name, t in spans if "split_terms" in name)
        return ((total / 1e3 / iters if total else None),
                split / 1e3 / iters)

    p, n, s, d = SHAPE
    g = torch.Generator(device="cuda").manual_seed(41)
    base = [torch.randn((p, rows, d), generator=g, device="cuda")
            for rows in (n, s, s)]
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (t.to(dtype) for t in base)
        err = float((ops.landmark_summary(q, k, v)
                     - ref.landmark_summary_ref(q, k, v, d ** -0.5)
                     ).abs().max())
        run = lambda: ops.landmark_summary(q, k, v)  # noqa: E731
        dev, split = device_ms(run)
        print(json.dumps({
            "tree": tree, "route": "bf16" if dtype == torch.bfloat16
            else "f32", "shape": dict(zip("PnSD", SHAPE)),
            "max_abs_err": err, "events_ms": event_ms(run, 50),
            "device_ms": dev, "split_device_ms": split}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*",
                    default=[str(Path(__file__).resolve().parents[1])])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        _one(args.one)
        return 0
    order = []
    for r in range(args.reps):
        order += args.trees if r % 2 == 0 else args.trees[::-1]
    for tree in order:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
