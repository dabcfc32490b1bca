#!/usr/bin/env python3
"""Time the d2 top-k kernels (kernel 2 ``topk_sim``, kernel 3
``foldin_topk``) of one or more checkouts on the card, on the cosine,
pearson and euclidean rows of the MovieLens-1M representation (synthetic
ratings, seed 0, fold 0, 20 popularity landmarks): the graph build of the
fit (U = C = 5976, n = 20, k = 13, self excluded), the fold-in search (the
last 64 users against all 6040) and a ragged build (1001 rows, n_valid =
990).

    python3 tools/time_topk_sim.py [TREE ...] [--reps 2] [--ab]

Each TREE is the root of a checkout (default: this one); every tree runs in
a process of its own, importing only its own ``src`` and building its own
kernels under its own ``build/kernels``. Trees run in turns, ``--reps``
rounds, first to last then last to first (old, new, new, old), so two
versions compare within one call on one card. Per (tree, shape, measure)
it prints one JSON line: CUDA-event ms per call over 50 calls after
warm-up (host launch cost included), and the device ms per call of every
kernel the call launches, in all and by kernel, from a ``torch.profiler``
trace of 20 calls (null when the trace holds no device events). Every
tree writes its outputs under ``build/time_topk_sim/``; the last line says
whether every tree's outputs are bitwise the first tree's.

Beside them each tree times a yardstick that is not the same function and
that the port never calls: ``torch.topk`` of the masked f32
``torch.mm(rep, cand.T)`` (TF32 off), which fuses no epilogue, keeps no
canonical tie order and writes the score matrix.

``--ab`` also times, in each tree whose wrapper has ``SCAN_VARIANTS``,
every scan tile variant at the fit shape (cosine and euclidean), each
with 1, 2 and 4 tiles a split at the least, and at the fold-in shape
(cosine) with at most 4, 8 and 16 splits, and says whether each gives the
default's lists bitwise. Needs a CUDA card
and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

FOLD_IN = 64  # users held out of the fit, as in chip_smoke.py
K = 13
MEASURES = ("cosine", "pearson", "euclidean")
OUT = Path(__file__).resolve().parents[1] / "build" / "time_topk_sim"


def _one(tree: str, tag: str, ab: bool) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import landmark_cf as cfg
    from repro_torch.core import similarity as sim
    from repro_torch.core.graph import kernel_rows
    from repro_torch.core.selection import popularity_landmarks
    from repro_torch.data import ratings as data
    from repro_torch.kernels import knn_topk

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
                name = name.split("<")[0].split("::")[-1].strip()
                by[name] = by.get(name, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3 / iters
        return (sum(by.values()) or None), by

    def yardstick(q, cand, self_offset, n_valid):
        c = cand.shape[0]
        col = torch.arange(c, device=q.device)
        mask = col[None, :] >= n_valid
        if self_offset is not None:
            row = self_offset + torch.arange(q.shape[0], device=q.device)
            mask = mask | (col[None, :] == row[:, None])
        return lambda: torch.topk(
            torch.mm(q, cand.T).masked_fill_(mask, float("-inf")), K)

    d = data.synthesize("movielens1m", seed=0)
    train_idx, _ = data.kfold_split(d, 0)
    train = d.to_matrix(train_idx, device="cuda").ratings
    u = train.shape[0] - FOLD_IN
    lm = train[:u][popularity_landmarks(train[:u], cfg.MODEL.n_landmarks)]
    rep = sim.masked_similarity(train, lm)  # plain torch on the card
    OUT.mkdir(parents=True, exist_ok=True)
    outputs = {}
    for measure in MEASURES:
        rows = kernel_rows(rep, measure)
        fit_rows = rows[:u].contiguous()
        rag = rows[:1001].contiguous()
        shapes = {
            "fit": (knn_topk.topk_sim, fit_rows, fit_rows,
                    dict(exclude_self=True, n_valid=u), 0, u),
            "fold-in": (knn_topk.foldin_topk, rows[u:].contiguous(), rows,
                        dict(self_offset=u), u, rows.shape[0]),
            "ragged": (knn_topk.topk_sim, rag, rag,
                       dict(exclude_self=True, n_valid=990), 0, 990),
        }
        for shape, (fn, q, cand, kw, self_offset, n_valid) in shapes.items():
            def run(fn=fn, q=q, cand=cand, kw=kw):
                return fn(q, cand, K, measure=measure, **kw)

            outputs[f"{shape}/{measure}"] = [x.cpu() for x in run()]
            dev, by_kernel = device_ms(run)
            print(json.dumps({
                "tree": tree, "shape": shape, "measure": measure,
                "rows": q.shape[0], "C": cand.shape[0], "n": q.shape[1],
                "k": K, "plan": _plan(knn_topk, q.shape[0], cand.shape[0],
                                      q.shape[1], measure),
                "events_ms": event_ms(run), "device_ms": dev,
                "device_ms_by_kernel": by_kernel}), flush=True)
            if measure == "cosine":
                ys = yardstick(q, cand, self_offset, n_valid)
                print(json.dumps({
                    "tree": tree, "shape": shape,
                    "yardstick": "torch.topk(masked f32 torch.mm)",
                    "events_ms": event_ms(ys),
                    "device_ms": device_ms(ys)[0]}), flush=True)
            if ab and hasattr(knn_topk, "SCAN_VARIANTS") and (
                    (shape == "fit" and measure != "pearson")
                    or (shape == "fold-in" and measure == "cosine")):
                _ab(knn_topk, run, outputs[f"{shape}/{measure}"], shape,
                    measure, tree, event_ms, device_ms, q.shape[0],
                    cand.shape[0], q.shape[1])
    torch.save(outputs, OUT / f"{tag}.pt")


def _plan(knn_topk, rows, c, n, measure):
    """The scan's variant, SMs, resident blocks an SM and (splits, tiles a
    split) for
    a call (None where the wrapper has no plan)."""
    if not hasattr(knn_topk, "plan_scan"):
        return None
    import torch

    variant = (knn_topk.LARGE_VARIANT if rows > knn_topk.SMALL_ROWS
               else knn_topk.SMALL_VARIANT)
    sms, per_sm = knn_topk._occupancy(torch.cuda.current_device(), variant,
                                      n, measure)
    return {"variant": variant, "qt_ct": knn_topk.SCAN_VARIANTS[variant],
            "sms": sms, "per_sm": per_sm, "splits_tps": knn_topk.plan_scan(
                rows, c, variant, sms, per_sm, knn_topk.MIN_TILES,
                knn_topk.MAX_SPLITS)}


def _ab(knn_topk, run, default, shape, measure, tree, event_ms, device_ms,
        rows, c, n):
    """Every scan variant and least split length at one shape."""
    import torch

    saved = (knn_topk.LARGE_VARIANT, knn_topk.SMALL_VARIANT,
             knn_topk.MIN_TILES, knn_topk.MAX_SPLITS)
    limits = ([(1, 4), (1, 8), (1, 16)] if shape == "fold-in"
              else [(1, 16), (2, 16), (4, 16)])
    try:
        for variant in range(len(knn_topk.SCAN_VARIANTS)):
            for min_tiles, max_splits in limits:
                knn_topk.LARGE_VARIANT = knn_topk.SMALL_VARIANT = variant
                knn_topk.MIN_TILES = min_tiles
                knn_topk.MAX_SPLITS = max_splits
                got = run()
                same = all(torch.equal(g.cpu(), w)
                           for g, w in zip(got, default))
                print(json.dumps({
                    "tree": tree, "ab": shape, "measure": measure,
                    "min_tiles": min_tiles, "max_splits": max_splits,
                    "plan": _plan(knn_topk, rows, c, n, measure),
                    "events_ms": event_ms(run),
                    "device_ms": device_ms(run)[0],
                    "bitwise_default": same}), flush=True)
    finally:
        (knn_topk.LARGE_VARIANT, knn_topk.SMALL_VARIANT, knn_topk.MIN_TILES,
         knn_topk.MAX_SPLITS) = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*",
                    default=[str(Path(__file__).resolve().parents[1])])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--ab", action="store_true")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--tag", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        _one(args.one, args.tag, args.ab)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    order = []
    for r in range(args.reps):
        order += args.trees if r % 2 == 0 else args.trees[::-1]
    tags = []
    for i, tree in enumerate(order):
        tags.append(f"run{i}-tree{args.trees.index(tree)}")
        subprocess.run([sys.executable, __file__, "--one", tree, "--tag",
                        tags[-1]] + (["--ab"] if args.ab else []),
                       check=True)
    import torch

    base = torch.load(OUT / f"{tags[0]}.pt")
    diff = []
    for tag in tags:
        for key, val in torch.load(OUT / f"{tag}.pt").items():
            if not all(torch.equal(a, b) for a, b in zip(val, base[key])):
                diff.append(f"{tag}:{key}")
    print(json.dumps({"outputs_bitwise_equal": not diff,
                      "differ": diff[:20]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
