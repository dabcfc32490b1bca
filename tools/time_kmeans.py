#!/usr/bin/env python3
"""Time k-means (kernel 4, ``retrieval.kmeans`` on the card) and the IVF
index build of one or more checkouts on the card, on the MovieLens-1M
representation (synthetic ratings, seed 0, fold 0, 20 popularity
landmarks, d1 in plain torch): the IVF build's shape (the 5976 fitted
rows, C = 77, 8 Lloyd steps) for the three measures, and the lifecycle's
capacity bucket (all 6040 rows padded with zeros to 8192, n_valid = 6040,
C = 78, cosine).

    python3 tools/time_kmeans.py [TREE ...] [--reps 2]

Each TREE is the root of a checkout (default: this one); every tree runs in
a process of its own, importing only its own ``src`` and building its own
kernels under its own ``build/kernels``. Trees run in turns, ``--reps``
rounds, first to last then last to first (old, new, new, old), so two
versions compare within one call on one card. Per (tree, call) it prints
one JSON line: CUDA-event ms per call over 50 calls after warm-up (host
launch cost included); from a ``torch.profiler`` trace of 20 calls, the
device ms per call of every kernel and copy the call runs, in all and by
kernel, and their number per call (``launches``). The calls: ``kmeans``
from given centroids (the Lloyd loop alone), ``kmeans`` drawing them
(``init_centroids`` too), ``build_index`` (k-means, then the posting
lists), and one standalone assignment (``kernels.assign_clusters`` on
normalized rows, as before the whole loop was one kernel). Every tree
writes its outputs under ``build/time_kmeans/``; the last lines say, per
tree, whether its runs gave bitwise the same outputs (a build is
reproducible) and whether every tree's outputs are bitwise the first
tree's. Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

FOLD_IN = 64  # users held out of the fit, as in chip_smoke.py
CAPACITY = 8192  # the lifecycle's bucket for 6040 rows
MEASURES = ("cosine", "pearson", "euclidean")
OUT = Path(__file__).resolve().parents[1] / "build" / "time_kmeans"


def _one(tree: str, tag: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import retrieval as rt
    from repro_torch.configs import landmark_cf as cfg
    from repro_torch.core import similarity as sim
    from repro_torch.core.graph import kernel_rows
    from repro_torch.core.selection import popularity_landmarks
    from repro_torch.data import ratings as data
    from repro_torch.kernels import assign_clusters as kac

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
        """(ms per call of everything the call runs on the card, its
        launches per call, ms per call by kernel)"""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        by, count = {}, 0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                count += 1
                name = e.name.replace("(anonymous namespace)::", "")
                name = name.removeprefix("void ").split("(")[0]
                name = name.split("<")[0].split("::")[-1].strip()[:60]
                by[name] = by.get(name, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3 / iters
        return (sum(by.values()) or None), count / iters, by

    def report(**row):
        fn = row.pop("fn")
        dev, launches, by = device_ms(fn)
        print(json.dumps(dict(tree=tree, **row, events_ms=event_ms(fn),
                              device_ms=dev, launches=launches,
                              device_ms_by_kernel=by)), flush=True)

    d = data.synthesize("movielens1m", seed=0)
    train_idx, _ = data.kfold_split(d, 0)
    train = d.to_matrix(train_idx, device="cuda").ratings
    u = train.shape[0] - FOLD_IN
    lm = train[:u][popularity_landmarks(train[:u], cfg.MODEL.n_landmarks)]
    rep = sim.masked_similarity(train, lm)  # plain torch on the card
    rows = rep[:u].contiguous()
    spec = rt.resolve_ivf(None, u)
    c = spec.n_clusters
    init = rt.init_centroids(torch.Generator().manual_seed(spec.seed), rows,
                             c)
    padded = torch.zeros((CAPACITY, rep.shape[1]), device="cuda")
    padded[:rep.shape[0]] = rep
    nv = rep.shape[0]
    c_life = rt.resolve_ivf(None, nv).n_clusters
    init_life = rt.init_centroids(torch.Generator().manual_seed(0), padded,
                                  c_life, nv)
    shape = f"U={u} C={c} n={rows.shape[1]} iters={spec.iters}"
    shape_life = f"U={CAPACITY} n_valid={nv} C={c_life} n={rep.shape[1]}"
    OUT.mkdir(parents=True, exist_ok=True)
    outputs = {}
    for measure in MEASURES:
        def lloyd(m=measure):
            return rt.kmeans(rows, c, m, iters=spec.iters, init=init)

        outputs[f"kmeans/{measure}"] = [x.cpu() for x in lloyd()]
        report(call="kmeans from init", shape=shape, measure=measure,
               fn=lloyd)
    report(call="kmeans drawing init", shape=shape, measure="cosine",
           fn=lambda: rt.kmeans(rows, c, "cosine", iters=spec.iters,
                                generator=torch.Generator().manual_seed(0)))

    def life():
        return rt.kmeans(padded, c_life, "cosine", iters=spec.iters,
                         n_valid=nv, init=init_life)

    outputs["kmeans/lifecycle"] = [x.cpu() for x in life()]
    report(call="kmeans from init", shape=shape_life, measure="cosine",
           fn=life)

    def index():
        return rt.build_index(rows, spec, "cosine")

    idx = index()
    outputs["build_index"] = [x.cpu() for x in (
        idx.centroids, idx.lists, idx.rows, idx.fill)]
    report(call="build_index", shape=f"U={u} C={c} cap={idx.capacity}",
           measure="cosine", fn=index)
    xr, cr = kernel_rows(rows, "cosine"), kernel_rows(init, "cosine")
    report(call="assign_clusters alone", shape=f"U={u} C={c}",
           measure="cosine", fn=lambda: kac.assign_clusters(xr, cr))
    torch.save(outputs, OUT / f"{tag}.pt")


def _bitwise(a, b):
    import torch

    return all(torch.equal(x.view(torch.int32) if x.is_floating_point()
                           else x, y.view(torch.int32)
                           if y.is_floating_point() else y)
               for x, y in zip(a, b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*",
                    default=[str(Path(__file__).resolve().parents[1])])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--tag", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        _one(args.one, args.tag)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    order = []
    for r in range(args.reps):
        order += args.trees if r % 2 == 0 else args.trees[::-1]
    runs = []
    for i, tree in enumerate(order):
        tag = f"run{i}-tree{args.trees.index(tree)}"
        runs.append((args.trees.index(tree), tag))
        subprocess.run([sys.executable, __file__, "--one", tree, "--tag",
                        tag], check=True)
    import torch

    loaded = [(t, torch.load(OUT / f"{tag}.pt")) for t, tag in runs]
    base = loaded[0][1]
    for t, tree in enumerate(args.trees):
        mine = [out for tt, out in loaded if tt == t]
        print(json.dumps({
            "tree": tree, "runs": len(mine),
            "reproducible": {key: all(_bitwise(out[key], mine[0][key])
                                      for out in mine)
                             for key in mine[0]},
            "bitwise_first_tree": {key: _bitwise(mine[0][key], base[key])
                                   for key in base}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
