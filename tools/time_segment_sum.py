#!/usr/bin/env python3
"""Time the segment-sum kernel (``kernels/segment_sum.py``) of one or more
checkouts on the card, at every CSR that a GatedGCN training step of
``chip_smoke.py`` phase 17 launches: by destination and by source on
``full_graph_sm``, ``minibatch_lg`` and ``molecule``, and by graph id on
``molecule`` — each shape's step-0 batch from its own generator, H = 70
(GatedGCN's d_hidden), f32 and bf16 — and at the two recsys CSRs of
phase 18a, f32: FM's by field id at train_batch (65,536 rows of 39 ids;
H = 10, its ``v`` table, and 1, its ``w``) and BERT4Rec's by item id at
16,384 histories of 200 (H = 64, the Zipf head of 1,850,927 ids).

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
edges (CUDA atomics, not bitwise; the port never calls it; its index and
rows gathered before the timing). At the recsys CSRs it also prints the
heavy/light split: CUDA-event ms of the launch with every heavy slot
unused (the light walk alone) and with no chunk (the heavy route alone).
The inputs stay in the 50 MB L2 cache where they fit: warm reads, as a
training step's are. Needs a CUDA card and ``nvcc``.

``chip_smoke.py`` phase 18a, ``tools/segment_sum_variants.py`` and the card
tests take their recsys CSRs, the heavy/light split and the recsys-like
cases from here (:func:`recsys_inputs`, :func:`split`,
:func:`rec_like_case`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

SHAPES = ("full_graph_sm", "minibatch_lg", "molecule")
H = 70
MARKERS = 256  # spin kernels that open each profiler session
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12


def recsys_inputs(device, b4r_rows=16384):
    """The ids of the two recsys lookup CSRs (``chip_smoke.py`` phase 18a):
    ``[(tag, ids, table rows, widths)]`` — FM's field ids at train_batch
    (its ``v`` at H = 10, its ``w`` at H = 1) and BERT4Rec's item ids at
    ``b4r_rows`` histories (H = its embed_dim)."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.data import synthetic

    fm, b4r = registry.get("fm"), registry.get("bert4rec").model
    rows = fm.shape("train_batch").dims["batch"]
    fm_ids = synthetic.fm_train_batch(
        0, 0, rows, fm.model.field_vocabs)["field_ids"]
    b4r_ids = synthetic.seq_rec_batch(
        0, 0, b4r_rows, b4r.seq_len, b4r.n_items)["item_ids"]
    return [(f"fm train_batch by field id (B={rows})",
             torch.as_tensor(fm_ids, device=device), fm.model.table_rows,
             (10, 1)),
            (f"bert4rec by item id (B={b4r_rows})",
             torch.as_tensor(b4r_ids, device=device), b4r.table_rows,
             (b4r.embed_dim,))]


def split(csr):
    """The heavy/light split of a CSR: ``(light, heavy)``, the same CSR
    with every heavy slot unused (the light walk alone) and with no chunk
    (the heavy units alone)."""
    import torch

    unused = dict(heavy_rows=torch.full_like(csr.heavy_rows, csr.n))
    if hasattr(csr, "n_huge"):  # (a tree before the heavy units has none)
        unused["n_huge"] = torch.zeros_like(csr.n_huge)
    return (dataclasses.replace(csr, **unused),
            dataclasses.replace(csr, chunk_rows=csr.chunk_rows[:1]))


def rec_like_case(kind, device):
    """(index, N, H) of the card tests' recsys-like CSRs: "fm_like_h1" and
    "fm_like_h10", 3000 heavy segments of 65-800 members and 200,000 light
    ids among 4,000,000 mostly empty rows at H = 1 and 10; "zipf_head",
    1,000,000 ids of BERT4Rec's generator over 100,000 rows (the head
    564,967 of them) at H = 64."""
    import numpy as np
    import torch

    if kind.startswith("fm_like"):
        rng = np.random.default_rng(36)
        n = 4_000_000
        hot = rng.choice(n, 3000, replace=False)
        idx = np.concatenate([np.repeat(hot, rng.integers(65, 801, 3000)),
                              rng.integers(0, n, 200_000)])
        idx, h = rng.permutation(idx), int(kind.removeprefix("fm_like_h"))
    else:
        rng = np.random.default_rng(37)
        n, h = 100_000, 64
        idx = np.minimum(rng.random(1_000_000) ** (-1.0 / 1.2) - 1.0, n - 1)
    return torch.as_tensor(idx.astype(np.int32), device=device), n, h


def event_ms(fn, iters):
    """CUDA-event ms of one call of ``fn``, over ``iters`` calls after
    three warm-up calls."""
    import torch

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


def _one(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops, ref  # noqa: F401 (import order)
    from repro_torch.kernels import segment_sum as segsum
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.distributed import embedding
    from repro_torch.launch import train

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

    def line(name, key, csr, x, segs, extra=None):
        run = lambda: segsum.segment_sum(x, csr)  # noqa: E731
        got, again = run(), run()
        want = ref.segment_sum_ref(x, csr.perm, csr.indptr)
        counts = csr.indptr[1:] - csr.indptr[:-1]
        live = csr.perm.long()
        h, dtype = x.shape[1], x.dtype
        idx_live, x_live = csr.index[live], x[live]
        library = lambda: torch.zeros(  # noqa: E731
            (segs, h), dtype=dtype, device="cuda").index_add_(
                0, idx_live, x_live)
        moved = (x.element_size() * h * (live.numel() + segs)
                 + 4 * live.numel() + 4 * (segs + 1))
        print(json.dumps({
            "tree": tree, "shape": name, "csr": f"by {key}",
            "dtype": "bf16" if dtype == torch.bfloat16 else "f32", "H": h,
            "nodes": segs, "edges": csr.n_edges,
            "live": live.numel(), "max_degree": int(counts.max()),
            "heavy_segments": int((counts > 64).sum()),
            "bitwise_plain": bool(torch.equal(got, want)),
            "bitwise_twice": bool(torch.equal(got, again)),
            "events_ms": event_ms(run, 50),
            "device_ms": device_ms(run),
            "bound_ms": max(moved / HBM_BYTES_PER_S,
                            live.numel() * h / F32_FLOPS) * 1e3,
            "index_add_ms": event_ms(library, 50), **(extra or {})}),
            flush=True)

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
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((idx.shape[0], H), generator=gen,
                                device="cuda").to(dtype)
                line(name, key, csr, x, segs)
    for name, ids, rows, widths in recsys_inputs("cuda"):
        csr = embedding.lookup_csr(ids, rows)
        light, heavy = split(csr)
        tag, key = name.split(" by ")
        for h in widths:
            x = torch.randn((csr.n_edges, h), generator=gen, device="cuda")
            line(tag, key, csr, x, rows, dict(
                light_alone_ms=event_ms(
                    lambda: segsum.segment_sum(x, light), 20),
                heavy_alone_ms=event_ms(
                    lambda: segsum.segment_sum(x, heavy), 20)))
            del x


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
