#!/usr/bin/env python3
"""Time the segment-sum kernel (``kernels/segment_sum.py``) of one or more
checkouts on the card, at every CSR that a GatedGCN training step of
``chip_smoke.py`` phase 17 launches: by destination and by source on
``full_graph_sm``, ``minibatch_lg`` and ``molecule``, and by graph id on
``molecule`` — each shape's step-0 batch from its own generator, H = 70
(GatedGCN's d_hidden), f32 and bf16.

    python3 tools/time_segment_sum.py [TREE ...] [--reps 2]

Each TREE is the root of a checkout (default: this one); every tree runs
in a process of its own, importing only its own ``src`` and building its
own kernels under its own ``build/kernels``. Trees run in turns, ``--reps``
rounds, first to last then last to first (old, new, new, old), so two
versions compare within one call on one card. Per run, CSR and dtype it
prints one JSON line: the tree, the CSR (nodes, edges, live edges, the
largest segment, segments of more than 64 members), whether the kernel
is bitwise its plain version and bitwise across two calls, CUDA-event ms
per call over 50 calls after warm-up (host launch cost included), the
kernel's own device ms from a ``torch.profiler`` trace of 20 calls (null
when the profiler lost the session's opening markers), the least time
the card could take (each live edge's row read once, the output written
once, perm and indptr read once, at 3.35 TB/s; one add per element at 67
TFLOP/s), and one ``torch.zeros(N, H).index_add_`` call on the same live
edges (CUDA atomics, not bitwise; the port never calls it). The inputs
stay in the 50 MB L2 cache where they fit: warm reads, as a training
step's are. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPES = ("full_graph_sm", "minibatch_lg", "molecule")
H = 70
MARKERS = 256  # spin kernels that open each profiler session
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12


def _one(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops, ref  # noqa: F401 (import order)
    from repro_torch.kernels import segment_sum as segsum
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.launch import train

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
        """ms a call of the segment-sum kernels, or None when every
        opening marker was lost"""
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
            return None
        return sum(e.time_range.end - e.time_range.start for e in dev
                   if "segment_sum" in e.name) / 1e3 / iters

    shapes = {s.name: s for s in GNN_SHAPES}
    gen = torch.Generator(device="cuda").manual_seed(33)
    for name in SHAPES:
        b = {k: torch.as_tensor(v, device="cuda") for k, v in
             next(train._gnn_batches(shapes[name])).items()}
        n = b["node_feats"].shape[0]
        keys = ["edge_dst", "edge_src"] + (["graph_ids"] if name == "molecule"
                                           else [])
        for key in keys:
            idx = b[key]
            mask = (b["edge_mask"] if key != "graph_ids"
                    else torch.ones(idx.shape[0], device="cuda"))
            segs = int(b["n_graphs"]) if key == "graph_ids" else n
            csr = segsum.build_csr(idx, segs, mask)
            counts = csr.indptr[1:] - csr.indptr[:-1]
            live = csr.perm.long()
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((idx.shape[0], H), generator=gen,
                                device="cuda").to(dtype)
                run = lambda: segsum.segment_sum(x, csr)  # noqa: E731
                got, again = run(), run()
                want = ref.segment_sum_ref(x, csr.perm, csr.indptr)
                idx_live, x_live = csr.index[live], x[live]
                library = lambda: torch.zeros(  # noqa: E731
                    (segs, H), dtype=dtype, device="cuda").index_add_(
                        0, idx_live, x_live)
                moved = (x.element_size() * H * (live.numel() + segs)
                         + 4 * live.numel() + 4 * (segs + 1))
                print(json.dumps({
                    "tree": tree, "shape": name, "csr": f"by {key}",
                    "dtype": "bf16" if dtype == torch.bfloat16 else "f32",
                    "nodes": segs, "edges": idx.shape[0],
                    "live": live.numel(), "max_degree": int(counts.max()),
                    "heavy_segments": int((counts > 64).sum()),
                    "bitwise_plain": bool(torch.equal(got, want)),
                    "bitwise_twice": bool(torch.equal(got, again)),
                    "events_ms": event_ms(run, 50),
                    "device_ms": device_ms(run),
                    "bound_ms": max(moved / HBM_BYTES_PER_S,
                                    live.numel() * H / F32_FLOPS) * 1e3,
                    "index_add_ms": event_ms(library, 50)}), flush=True)


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
