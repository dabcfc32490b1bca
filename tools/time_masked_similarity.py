#!/usr/bin/env python3
"""Time d1 (kernel 1, ``masked_similarity``) of one or more checkouts on the
card, at three shapes of MovieLens-1M-shaped synthetic ratings (seed 0,
fold 0) against their 20 popularity landmarks: the fit (A = 5976 users
but the last 64, B = 20, P = 3952), the fold-in (the last 64 users), and a
lifecycle coresets round (all 6040 users against 2 candidates); the fit
against 128 popularity landmarks (``chip_smoke.py`` phase 14a's wide
path); and web_fit's (A = U users, B = 128 popularity landmarks,
P = 65,536 items; ratings and U from ``tools/profile_web_fit.py``, the
generator and the cut of phases 14c and 19a, U worked out once with this
checkout's dry run).

    python3 tools/time_masked_similarity.py [TREE ...] [--reps 2] [--no-web]

Each TREE is the root of a checkout (default: this one); every tree runs in
a process of its own, importing only its own ``src`` and building its own
kernels under its own ``build/kernels``. Trees run in turns, ``--reps``
rounds, first to last then last to first (old, new, new, old), so two
versions compare within one call on one card. Per (tree, shape, route) it
prints one JSON line: CUDA-event ms per call over 50 calls after warm-up
(host launch cost included), and the device ms per call of every kernel
the call launches (a memset included), in all and by kernel, from a
``torch.profiler`` trace of 20 calls (null when the trace holds no device
events); at web_fit's shape 3 and 2 calls. The route is the tree's
default, and ``f32`` too where the wrapper takes a ``route``. Every tree
writes a SHA-256 of each output (all three measures) under
``build/time_masked_similarity/``; the last line says whether every
tree's and route's outputs are bitwise the first tree's.

Beside them each tree times a yardstick that is not the same function: the
tensor-core route's three bf16 products (a² against [b≠0], a against
[b≠0 ; b], [a≠0] against [b≠0 ; b ; b²]) through ``torch.matmul`` on
operands converted beforehand — no masks built, no guard, no epilogue
(not at web_fit's shape: its bf16 operands would take 96 GB). Needs a
CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from profile_web_fit import main_users, web_ratings

FOLD_IN = 64  # users held out of the fit, as in chip_smoke.py
OUT = Path(__file__).resolve().parents[1] / "build" / "time_masked_similarity"


def _digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _one(tree: str, tag: str, web_users) -> None:
    """One tree's lines; web_fit's shape at ``web_users`` users, left out
    when None."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import inspect

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import landmark_cf as cfg
    from repro_torch.core.selection import popularity_landmarks
    from repro_torch.data import ratings as data
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False

    def event_ms(fn, iters=50, warm=3):
        for _ in range(warm):
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

    def matmul_yardstick(r_a, r_b):
        planes = [(r_b != 0).bfloat16(), r_b.bfloat16(),
                  (r_b * r_b).bfloat16()]
        pairs = [((r_a * r_a).bfloat16(), planes[0].T.contiguous()),
                 (r_a.bfloat16(), torch.cat(planes[:2]).T.contiguous()),
                 ((r_a != 0).bfloat16(), torch.cat(planes).T.contiguous())]
        return lambda: [torch.matmul(x, y) for x, y in pairs]

    d = data.synthesize("movielens1m", seed=0)
    train_idx, _ = data.kfold_split(d, 0)
    train = d.to_matrix(train_idx, device="cuda").ratings
    u = train.shape[0] - FOLD_IN
    lm = train[:u][popularity_landmarks(train[:u], cfg.MODEL.n_landmarks)]
    cand = train[torch.randperm(train.shape[0], device="cpu",
                                generator=torch.Generator().manual_seed(0))[
        :2].to(train.device)]
    lm128 = train[:u][popularity_landmarks(train[:u], cfg.WEB_FIT[
        "n_landmarks"])]
    shapes = {"fit": lambda: (train[:u], lm),
              "fold-in": lambda: (train[u:], lm),
              "coresets": lambda: (train, cand),
              "fit n=128": lambda: (train[:u], lm128)}
    if web_users is not None:
        def web():
            r = web_ratings(web_users, cfg.WEB_FIT["n_items"])
            return r, r[popularity_landmarks(r, cfg.WEB_FIT["n_landmarks"])]
        shapes["web_fit"] = web
    routes = [None]
    if "route" in inspect.signature(ops.masked_similarity).parameters:
        routes.append("f32")
    OUT.mkdir(parents=True, exist_ok=True)
    outputs = {}
    for shape, make in shapes.items():
        r_a, r_b = make()
        big = shape == "web_fit"
        for route in routes:
            kw = {} if route is None else {"route": route}

            def run(r_a=r_a, r_b=r_b, kw=kw):
                return ops.masked_similarity(r_a, r_b, "cosine", **kw)

            for measure in ("cosine", "pearson", "euclidean"):
                outputs[f"{shape}/{route or 'default'}/{measure}"] = (
                    _digest(ops.masked_similarity(r_a, r_b, measure, **kw)))
            dev, by_kernel = device_ms(run, 2 if big else 20)
            print(json.dumps({
                "tree": tree, "shape": shape,
                "A": r_a.shape[0], "B": r_b.shape[0], "P": r_a.shape[1],
                "route": route or "default",
                "events_ms": event_ms(run, *((3, 1) if big else ())),
                "device_ms": dev, "device_ms_by_kernel": by_kernel}),
                flush=True)
        if not big:
            mm = matmul_yardstick(r_a, r_b)
            print(json.dumps({"tree": tree, "shape": shape,
                              "yardstick": "three bf16 torch.matmul",
                              "events_ms": event_ms(mm),
                              "device_ms": device_ms(mm)[0]}), flush=True)
        del r_a, r_b
    (OUT / f"{tag}.json").write_text(json.dumps(outputs))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*",
                    default=[str(Path(__file__).resolve().parents[1])])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--no-web", action="store_true",
                    help="leave web_fit's shape out")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--tag", help=argparse.SUPPRESS)
    ap.add_argument("--users", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        _one(args.one, args.tag, None if args.no_web else args.users)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    web = ["--no-web"] if args.no_web else ["--users", str(main_users())]
    order = []
    for r in range(args.reps):
        order += args.trees if r % 2 == 0 else args.trees[::-1]
    tags = []
    for i, tree in enumerate(order):
        tags.append(f"run{i}-tree{args.trees.index(tree)}")
        subprocess.run([sys.executable, __file__, "--one", tree, "--tag",
                        tags[-1], *web], check=True)
    first = json.loads((OUT / f"{tags[0]}.json").read_text())
    base = {k.rsplit("/", 2)[0] + "/" + k.rsplit("/", 1)[1]: v
            for k, v in first.items() if "/default/" in k}
    diff = []
    for tag in tags:
        for key, val in json.loads((OUT / f"{tag}.json").read_text()).items():
            shape, _, measure = key.split("/")
            if val != base[f"{shape}/{measure}"]:
                diff.append(f"{tag}:{key}")
    print(json.dumps({"outputs_bitwise_equal": not diff,
                      "differ": diff[:20]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
