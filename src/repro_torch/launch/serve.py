"""Serving launcher — the landmark-CF serve loop on one device.

``python -m repro_torch.launch.serve --workload cf [--smoke]`` fits landmark
CF in process on synthetic ratings, then runs waves of Eq. (1) pair
predictions and top-N recommendations, folding a batch of new users into
the fitted state between waves (``core.fold_in``: no refit).

It runs on the card unless ``--device cpu`` is given; asking for ``cuda``
on a machine without one raises. TF32 is switched off for matmuls and
cuDNN at start: the reference scores in full f32 (``Precision.HIGHEST``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import landmark_cf as cfg
from ..core import RatingMatrix, fit, fold_in, knn
from ..serving.stats import latency_stats


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _synth_ratings(rng, users, items, device, density=0.08):
    """Uniform ratings 1..5 at ``density`` — the reference's generator, so
    one seed gives the same matrix in both packages."""
    r = rng.integers(1, 6, (users, items)).astype(np.float32)
    r *= rng.random((users, items)) < density
    return torch.as_tensor(r, device=device)


def _cf_wave(state, rng, args, wave, device):
    """One request wave: batched pair predictions + top-N recommendations,
    each warmed once, then timed per call to the end of its device work."""
    u, p = state.ratings.shape

    def ids(n, size):
        return torch.as_tensor(rng.integers(0, n, size).astype(np.int32),
                               device=device)

    knn.predict_pairs_graph(state.graph, state.ratings, ids(u, args.batch),
                            ids(p, args.batch))  # warm
    _sync(device)
    pair_ts = []
    for _ in range(args.requests):
        users, items = ids(u, args.batch), ids(p, args.batch)
        t0 = time.perf_counter()
        out = knn.predict_pairs_graph(state.graph, state.ratings, users, items)
        _sync(device)
        pair_ts.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("non-finite predictions in serve wave")

    knn.recommend_topn_graph(state.graph, state.ratings, ids(u, args.batch),
                             n=args.topn)  # warm
    _sync(device)
    topn_ts = []
    for _ in range(max(1, args.requests // 4)):
        users = ids(u, args.batch)
        t0 = time.perf_counter()
        knn.recommend_topn_graph(state.graph, state.ratings, users, n=args.topn)
        _sync(device)
        topn_ts.append(time.perf_counter() - t0)

    ps, ts = latency_stats(pair_ts), latency_stats(topn_ts)
    print(f"wave {wave}: U={u} predict {args.requests}x{args.batch} pairs "
          f"{ps.brief()} | top-{args.topn} x{args.batch} users {ts.brief()}")


def _serve_cf(args):
    device = torch.device(args.device)
    spec = cfg.SMOKE if args.smoke else cfg.MODEL
    if args.smoke:
        args.users, args.items = min(args.users, 512), min(args.items, 128)
        args.requests = min(args.requests, 8)
        args.foldin = min(args.foldin, 16)
        args.waves = min(args.waves, 2)
    rng = np.random.default_rng(0)

    r = _synth_ratings(rng, args.users, args.items, device)
    t0 = time.perf_counter()
    state = fit(RatingMatrix(r, args.users, args.items), spec,
                backend=args.graph_backend)
    _sync(device)
    t_fit = time.perf_counter() - t0
    print(f"fit U={args.users} P={args.items} n={spec.n_landmarks} "
          f"k={state.graph.k} on {device}: {t_fit*1e3:.0f}ms (in process)")

    fold_stream = _synth_ratings(rng, args.foldin * max(args.waves - 1, 0),
                                 args.items, device)
    for wave in range(args.waves):
        _cf_wave(state, rng, args, wave, device)
        if wave == args.waves - 1:
            break
        batch = fold_stream[wave * args.foldin:(wave + 1) * args.foldin]
        t0 = time.perf_counter()
        state = fold_in(state, batch, spec, backend=args.graph_backend)
        _sync(device)
        dt = time.perf_counter() - t0
        print(f"fold-in +{args.foldin} users: {dt*1e3:.1f}ms "
              f"(U {state.ratings.shape[0] - args.foldin}"
              f"->{state.ratings.shape[0]}, no refit)")
    print("cf serve: done")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Landmark-CF serve loop: fit in process, then waves of "
        "pair predictions and top-N recommendations with fold-ins between "
        "them. The state is fitted in process each run; saving and "
        "reloading it waits for the checkpoint slice of the port.")
    ap.add_argument("--workload", choices=("cf",), default="cf")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke spec and sizes (U<=512, P<=128, 2 waves)")
    ap.add_argument("--batch", type=int, default=256,
                    help="pairs/users per request")
    ap.add_argument("--users", type=int, default=8192)
    ap.add_argument("--items", type=int, default=512)
    ap.add_argument("--waves", type=int, default=3)
    ap.add_argument("--requests", type=int, default=32,
                    help="timed predict calls per wave")
    ap.add_argument("--foldin", type=int, default=64,
                    help="new users folded in between waves")
    ap.add_argument("--topn", type=int, default=10)
    ap.add_argument("--graph-backend", default="auto",
                    choices=("auto", "dense", "streaming", "kernel"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; the CPU "
                    "only when asked for)")
    args = ap.parse_args(argv)
    args.requests = max(1, args.requests)  # the wave loop times at least one
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmul and cuDNN (full f32, as the reference's "
          "Precision.HIGHEST)")
    _serve_cf(args)


if __name__ == "__main__":
    main()
