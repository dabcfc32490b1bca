#!/usr/bin/env python3
"""Time the MoE FFN's routing (``moe_route``) and the whole dense-dispatch
``moe_ffn`` of one or more checkouts on the card, at DeepSeek-MoE-16B's
widths (D = 2048, E = 64 routed experts of F = 1408, top 6, capacity 1.25,
groups of 512, bf16, one layer's random weights):

- ``forward``: B = 2 rows of S = 4096 tokens, the landmark forward's
  shape in ``chip_smoke.py`` phase 15b (16 groups);
- ``decode``: B = 4 rows of one token, a decode step's groups.

    python3 tools/time_moe_ffn.py [TREE ...] [--reps 2]

Each TREE is the root of a checkout (default: this one); every tree runs
in a process of its own, importing only its own ``src``. Trees run in
turns, ``--reps`` rounds, first to last then last to first (old, new, new,
old), so two versions compare within one call on one card. TF32 is off, as
in the port's entry points. Per (tree, shape) it prints one JSON line: a
digest of the slots and of the output (equal digests: the same routing and
the same bits), CUDA-event ms per call over 20 calls after warm-up, the
device ms per call from a ``torch.profiler`` trace of 5 calls, and the
device ms of the running-count scan (kernels named ``scan``) within it.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

D, E, F, TOP_K, CAP, GROUP = 2048, 64, 1408, 6, 1.25, 512
SHAPES = {"forward": (2, 4096), "decode": (4, 1)}  # (B, S)


def _one(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import layers

    torch.backends.cuda.matmul.allow_tf32 = False

    def event_ms(fn, iters=20):
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

    def device_ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not ev:
            return None, None
        ms = [(e.name, (e.time_range.end - e.time_range.start) / 1e3 / iters)
              for e in ev]
        return (sum(t for _, t in ms),
                sum(t for n, t in ms if "scan" in n.lower()))

    def digest(t):
        return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()
                              ).hexdigest()[:16]

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(torch.bfloat16)

    router = randn(D, E, scale=D ** -0.5)
    w1, w3 = randn(E, D, F, scale=D ** -0.5), randn(E, D, F, scale=D ** -0.5)
    w2 = randn(E, F, D, scale=F ** -0.5)
    for tag, (b, s) in SHAPES.items():
        x = randn(b, s, D)

        def route(x=x):
            return layers.moe_route(x, router, TOP_K, CAP, GROUP)

        def ffn(x=x):
            return layers.moe_ffn(x, router, w1, w3, w2, TOP_K, CAP, GROUP)

        with torch.inference_mode():
            pos, out = route().pos, ffn()[0]
            line = {"tree": tree, "shape": tag, "B": b, "S": s,
                    "pos_digest": digest(pos.to(torch.int64)),
                    "out_digest": digest(out.view(torch.int16))}
            for name, fn in (("route", route), ("ffn", ffn)):
                dev, scan = device_ms(fn)
                line |= {f"{name}_events_ms": event_ms(fn),
                         f"{name}_device_ms": dev,
                         f"{name}_scan_device_ms": scan}
        print(json.dumps(line), flush=True)


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
