#!/usr/bin/env python3
"""Time the fused IVF probe (kernel 5, ``fused_probe_topk``) of one or more
checkouts on the card: at ``chip_smoke.py`` phase 6's shape (the ML-1M
graph build through the index: b = 5976 queries, nprobe = 19 of C = 77
cells, cap = 104, n = 20, k = 13) for f32, bf16 and int8 payloads, and at
the lifecycle's batch sizes on the same index (f32): a 64-row fold-in at
nprobe 19 and the 256-query recall probes at nprobe 19 and at C.

    python3 tools/time_ivf_probe.py [TREE ...] [--reps 2]

Each TREE is the root of a checkout (default: this one); every tree runs
in a process of its own, importing only its own ``src`` and building its
own kernels under its own ``build/kernels``. Trees run in turns, ``--reps``
rounds, first to last then last to first (old, new, new, old), so two
versions of the kernel compare within one call on one card. Every tree
fits the same representation (MovieLens-1M-shaped synthetic ratings,
seed 0, fold 0, the users but the last 64). Per (tree, shape, payload) it
prints one JSON line: whether the lists are bitwise the plain version's,
CUDA-event ms per call over 50 calls after warm-up (host launch cost
included), and the device ms per call of every kernel the call launches,
in all and by kernel, from a ``torch.profiler`` trace of 20 calls (null
when the trace holds no device events). Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

FOLD_IN = 64  # users held out of the fit, as in chip_smoke.py


def _one(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import retrieval as rt
    from repro_torch.configs import landmark_cf as cfg
    from repro_torch.core import RatingMatrix, fit
    from repro_torch.data import ratings as data
    from repro_torch.kernels import ivf_probe, ref

    torch.backends.cuda.matmul.allow_tf32 = False

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
        """(ms per call of all the call's kernels, ms per call by kernel)"""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = e.name.replace("(anonymous namespace)::", "")
                name = name.removeprefix("void ").split("(")[0]
                name = name.split("<")[0].split("::")[-1]
                by[name] = by.get(name, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3 / iters
        return (sum(by.values()) or None), by

    d = data.synthesize("movielens1m", seed=0)
    train_idx, _ = data.kfold_split(d, 0)
    train = d.to_matrix(train_idx, device="cuda").ratings
    u = train.shape[0] - FOLD_IN
    rep = fit(RatingMatrix(train[:u], u, train.shape[1]),
              cfg.MODEL).representation
    spec = rt.resolve_ivf(None, u)
    index = rt.build_index(rep, spec, "cosine")
    c = index.n_clusters
    sids = torch.arange(u, dtype=torch.int32, device="cuda")

    def payload_index(payload):
        if payload == "f32":
            return index
        rows = rt.dequantize_payload(index.rows, index.scale)
        stored, scale = rt.quantize_payload(rows.reshape(-1, rows.shape[-1]),
                                            payload)
        return rt.IVFIndex(index.centroids, index.lists,
                           stored.reshape(rows.shape[:2] + (-1,)).contiguous(),
                           index.fill, None if scale is None
                           else scale.reshape(index.lists.shape).contiguous())

    cases = [(u, spec.nprobe, p) for p in ("f32", "bf16", "int8")]
    cases += [(64, spec.nprobe, "f32"), (256, spec.nprobe, "f32"),
              (256, c, "f32")]
    for b, nprobe, payload in cases:
        idx = payload_index(payload)
        q = rep[:b].contiguous()
        probe = rt.probe_cells(index, q, nprobe, "cosine")
        args = (q, probe, idx.lists, idx.rows, idx.scale, idx.fill)

        def run(args=args, b=b):
            return ivf_probe.fused_probe_topk(*args, k=13, self_ids=sids[:b])

        got = run()
        want = ref.fused_probe_topk_ref(*args, k=13, self_ids=sids[:b])
        torch.cuda.synchronize()
        dev, by_kernel = device_ms(run)
        print(json.dumps({
            "tree": tree, "shape": dict(b=b, nprobe=nprobe, C=c,
                                        cap=index.capacity, n=q.shape[1],
                                        k=13),
            "payload": payload,
            "bitwise": all(torch.equal(x, y) for x, y in zip(got, want)),
            "events_ms": event_ms(run), "device_ms": dev,
            "device_ms_by_kernel": by_kernel}), flush=True)


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
