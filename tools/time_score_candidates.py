#!/usr/bin/env python3
"""Time the gathered-candidate scorer (kernel 6, ``score_candidates``) of
one or more checkouts on the card, in both its forms, at n = 20, 100 and
128 landmarks:

- the per-query form at the IVF search's partial-probe block: b = 256
  queries, each against its own m = 1976 gathered rows (nprobe 19 × cap
  104 at ML-1M);
- the shared form at the back-patch's shape: the lifecycle's C = 8192-row
  bucket against a bq = 64-row fold-in batch.

    python3 tools/time_score_candidates.py [TREE ...] [--reps 2]

Each TREE is the root of a checkout (default: this one); every tree runs
in a process of its own, importing only its own ``src`` and building its
own kernels under its own ``build/kernels``. Trees run in turns, ``--reps``
rounds, first to last then last to first (old, new, new, old), so two
versions of the kernel compare within one call on one card. The inputs are
seeded normal rows (cosine). Per (tree, form, n) it prints one JSON line:
whether the scores are bitwise ``ref.gathered_sims``', CUDA-event ms per
call over 50 calls after warm-up (host launch cost included), the device
ms per call from a ``torch.profiler`` trace of 20 calls (null when the
trace holds no device events), and the bound: the larger of the bytes
(each input read once, the output written once) over 3.35 TB/s and the
operations (a 2n-term dot, its share of the norms, a 3-op epilogue) over
67 TFLOP/s. A tree whose wrapper refuses the width prints its message.
Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12  # H100 SXM, NVIDIA data sheet
WIDTHS = (20, 100, 128)
PER_QUERY = (256, 1976)  # (b, m)
SHARED = (8192, 64)  # (C, bq)


def _bound(form, n):
    if form == "per_query":
        b, m = PER_QUERY
        nbytes = 4 * (b * n + b * m * n + b * m)
        flops = b * m * (4 * n + 3) + 2 * n * b
    else:
        c, bq = SHARED
        nbytes = 4 * (c * n + bq * n + c * bq)
        flops = c * bq * (2 * n + 3) + 2 * n * (c + bq)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _one(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ref, score_candidates

    def event_ms(fn, iters=50):
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
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        return sum(spans) / 1e3 / iters if spans else None

    rng = np.random.default_rng(0)
    for form in ("per_query", "shared"):
        for n in WIDTHS:
            if form == "per_query":
                b, m = PER_QUERY
                shapes = ((b, n), (b, m, n))
            else:
                shapes = ((SHARED[0], n), (SHARED[1], n))
            q, cand = (torch.as_tensor(rng.normal(size=s).astype(np.float32),
                                       device="cuda") for s in shapes)

            def run(q=q, cand=cand):
                return score_candidates.score_candidates(q, cand, "cosine")

            bound_ms, bound_by = _bound(form, n)
            line = {"tree": tree, "form": form, "n": n,
                    "shape": [list(s) for s in shapes],
                    "bound_ms": bound_ms, "bound_by": bound_by}
            try:
                got = run()
            except ValueError as err:  # a width the tree's wrapper refuses
                print(json.dumps({**line, "refused": str(err)}), flush=True)
                continue
            want = ref.gathered_sims(q, cand, "cosine")
            torch.cuda.synchronize()
            print(json.dumps({
                **line, "bitwise": bool(torch.equal(got, want)),
                "events_ms": event_ms(run), "device_ms": device_ms(run)}),
                flush=True)


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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    order = []
    for r in range(args.reps):
        order += args.trees if r % 2 == 0 else args.trees[::-1]
    for tree in order:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
