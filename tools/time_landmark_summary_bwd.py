#!/usr/bin/env python3
"""Time the backward of the landmark-summary kernel (kernel 7) of one
checkout on the card, at the training shape of ``chip_smoke.py`` phase 16
(SmolLM-360M at B = 8: P = 40 problems, n = 1536 queries, S = 4096 keys,
D = 64), bf16 inputs (the training path's, ``tensor_core``) and f32
inputs (``f32_split`` on this tree; the FMA route before it).

    python3 tools/time_landmark_summary_bwd.py [TREE ...] [--reps 2]

Each TREE is the root of a checkout (default: this one); every tree runs
in a process of its own, importing only its own ``src`` and building its
own kernels under its own ``build/kernels``. Trees run in turns, ``--reps``
rounds, first to last then last to first (old, new, new, old), so two
versions of the backward compare within one call on one card. Per run and
dtype it prints one JSON line: the tree, the dtype, the largest error
against the plain version relative to max |plain| per gradient, whether
two calls gave the same bits, CUDA-event ms per call over 20 calls after
warm-up (host launch cost included), the call's own device ms from a
``torch.profiler`` trace of 10 calls (every kernel of the call, a split
pass of dO, and of q, k, v on f32 inputs, included; null when the
profiler lost the session's opening markers) with the ms by kernel, the
plain version's event ms, and the event ms of the backward alone of
``F.scaled_dot_product_attention`` in the same dtype on the same inputs laid
out as (B = 8, 5 kv heads, n, D), the library call for the same function
(timed only, never used by the port). Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPE = (40, 1536, 4096, 64)  # (P, n, S, D)
BATCH = 8  # P = B · 5 kv heads
MARKERS = 256  # spin kernels that open each profiler session


def _one(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref  # noqa: F401 (import order)
    from repro_torch.kernels import landmark_attention as lsum

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

    def device_ms(fn, iters=10):
        """(ms a call of every kernel but the markers, ms by kernel), or
        (None, {}) when every marker was lost"""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(MARKERS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not any("spin_kernel" in e.name for e in dev):
            return None, {}
        by_name = {}
        for e in dev:
            if "spin_kernel" in e.name:
                continue
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ")
            by_name[name] = by_name.get(name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3 / iters
        return sum(by_name.values()), by_name

    def sdpa_bwd_ms(q, k, v):
        """event ms of SDPA's backward alone on (B, P / B, rows, D)"""
        q4, k4, v4 = (t.reshape(BATCH, -1, *t.shape[1:]).detach()
                      .requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(q4, k4, v4)
        dout = torch.randn_like(out)
        return event_ms(lambda: torch.autograd.grad(
            out, (q4, k4, v4), dout, retain_graph=True), 10)

    p, n, s, d = SHAPE
    g = torch.Generator(device="cuda").manual_seed(61)
    base = [torch.randn((p, rows, d), generator=g, device="cuda")
            for rows in (n, s, s)]
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (t.to(dtype) for t in base)
        scale = d ** -0.5
        out = ref.landmark_summary_ref(q, k, v, scale)
        dout = torch.randn(out.shape, generator=g, device="cuda")
        run = lambda: lsum.landmark_summary_bwd(  # noqa: E731
            q, k, v, out, dout, scale)
        got, again = run(), run()
        want = ref.landmark_summary_bwd_ref(q, k, v, out, dout, scale)
        rel = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(got, want))
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        del got, again, want
        dev, by_kernel = device_ms(run)
        print(json.dumps({
            "tree": tree, "dtype": "bf16" if dtype == torch.bfloat16
            else "f32", "shape": dict(zip("PnSD", SHAPE)),
            "rel_err": rel, "bitwise_twice": bitwise,
            "events_ms": event_ms(run, 20), "device_ms": dev,
            "device_ms_by_kernel": by_kernel,
            "plain_ms": event_ms(lambda: ref.landmark_summary_bwd_ref(
                q, k, v, out, dout, scale), 3),
            "sdpa_bwd_ms": sdpa_bwd_ms(q, k, v)}), flush=True)


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
