#!/usr/bin/env python3
"""Run the reference's and the port's lifecycle serve CLI with the same
arguments on the CPU and print their IVF retrieval health side by side.

    PYTHONPATH=src python tools/lifecycle_parity.py \\
        --users 1024 --items 512 --waves 8 [--selection popularity]

Each package runs in its own process (``repro.launch.serve`` with
``JAX_PLATFORMS=cpu``; ``repro_torch.launch.serve --device cpu``) with
``--workload cf --lifecycle --retrieval ivf --early-exit``; this script
imports neither. Per wave it prints the generation, the nprobe escalation
steps, the settled nprobe, recall@k of the serving search against the
exact search by id (both) and by score (the port only: the reference
prints none), and the early-exit recall and probes per query. The parsed
waves go to ``--json`` as well.

The two runs share the drifting stream and the request sample (numpy,
seeded alike) but not the random draws of ``jax.random`` against
``torch.Generator``: the k-means initialisation and, under ``coresets``,
the landmarks differ. ``--selection popularity`` removes the second.

``--controlled`` holds the first fixed instead: on the wave-0 population's
representation (the reference's fit, ``--users`` x ``--items``, no bucket
padding) it builds the reference's index for ``--seeds`` k-means keys and,
over the same rows, the port's index (a) around the reference's final
centroids, (b) by the port's k-means from the reference's initial
centroids and (c) from the port's own generator seeds, and prints recall@k
by id of each against the reference's exact search at a few nprobe. For
the first seed and index (a) it then says where the two packages part:
rows placed in another cell, probe tables at the first nprobe, and the
exact searches' per-pair scores (the reference's GEMM against the port's
left-to-right sums) with the ids tied at each query's k-th score. Each
package runs in a process of its own, handing arrays over in an ``.npz``.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

WAVE = re.compile(
    r"^wave (\d+): gen (\d+) .*\| ivf recall@\d+=([\d.]+)"
    r"(?: \(by score ([\d.]+)\))? nprobe=(\d+) skew=([\d.]+)"
    r"(?: probed/q=([\d.]+)/\d+ \(early-exit recall ([\d.]+)"
    r"(?:, by score ([\d.]+))?\))?")
ESC = re.compile(r"^wave (\d+): ivf recall below SLO -> nprobe escalated to "
                 r"(\d+)/(\d+) \(recall ([\d.]+)\)")
REBAL = re.compile(r"^wave (\d+): ivf lists rebalanced .* -> C=(\d+)")
START = re.compile(r"^retrieval: ivf C=(\d+) cap=(\d+) nprobe=(\d+)")


def _f(x):
    return None if x is None else float(x)


def parse(text: str) -> dict:
    out = {"start": None, "waves": {}}
    cells = None
    for ln in text.splitlines():
        if m := START.match(ln):
            cells = int(m[1])
            out["start"] = {"clusters": cells, "cap": int(m[2]),
                            "nprobe": int(m[3])}
        elif m := REBAL.match(ln):
            cells = int(m[2])
            out["waves"].setdefault(int(m[1]), {})["rebalanced_to"] = cells
        elif m := ESC.match(ln):
            w = out["waves"].setdefault(int(m[1]), {})
            w.setdefault("escalations", []).append(
                [int(m[2]), float(m[4])])
            cells = int(m[3])
        elif m := WAVE.match(ln):
            w = out["waves"].setdefault(int(m[1]), {})
            w.update(gen=int(m[2]), recall_id=float(m[3]),
                     recall_score=_f(m[4]), nprobe=int(m[5]),
                     clusters=cells, skew=float(m[6]), probed=_f(m[7]),
                     ee_recall_id=_f(m[8]), ee_recall_score=_f(m[9]))
    out["waves"] = [dict(wave=k, **v) for k, v in sorted(out["waves"].items())]
    return out


def run(package: str, flags: list, ckpt: str) -> tuple:
    argv = [sys.executable, "-m", f"{package}.launch.serve", "--workload",
            "cf", "--lifecycle", "--retrieval", "ivf", "--early-exit",
            "--ckpt", ckpt] + flags
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    if package == "repro_torch":
        argv += ["--device", "cpu"]
    t0 = time.perf_counter()
    res = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                         text=True, check=False)
    if res.returncode:
        raise SystemExit(f"{package} failed ({res.returncode}):\n"
                         f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    return parse(res.stdout), time.perf_counter() - t0


def _fmt(w: dict) -> str:
    if not w:
        return "-"
    esc = ",".join(f"{n}:{r:.3f}" for n, r in w.get("escalations", []))
    score = ("" if w.get("recall_score") is None
             else f"/{w['recall_score']:.3f}")
    ee = ("" if w.get("ee_recall_id") is None
          else f" ee {w['ee_recall_id']:.3f}"
          + ("" if w.get("ee_recall_score") is None
             else f"/{w['ee_recall_score']:.3f}")
          + f" p/q {w['probed']:.1f}")
    return (f"g{w.get('gen')} np {w.get('nprobe')}/{w.get('clusters')} "
            f"r {w.get('recall_id', float('nan')):.3f}{score}{ee}"
            + (f" esc[{esc}]" if esc else ""))


NPROBES = (0.25, 0.375, 0.5625, 0.84375)  # the CLI's escalation steps / C
K = 13


def _ref_side(args, d: dict) -> dict:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro import retrieval as rt
    from repro.configs import registry
    from repro.core import RatingMatrix, fit
    from repro.core.similarity import dense_similarity
    from repro.data.synthetic import drifting_ratings
    from repro.retrieval.kmeans import init_centroids

    spec = dataclasses.replace(registry.get("landmark_cf").model,
                               selection=args.selection)
    r0 = drifting_ratings(0, 0, args.users, args.items, n_waves=args.waves,
                          drift=1.0)
    st = fit(jax.random.PRNGKey(0),
             RatingMatrix(jnp.asarray(r0), args.users, args.items), spec)
    rep = st.representation
    cfg = rt.resolve_ivf(None, args.users)
    c = cfg.n_clusters
    qids = np.random.default_rng(1).choice(args.users, 256, replace=False)
    q, sids = rep[qids], jnp.asarray(qids, jnp.int32)
    out = {"rep": np.asarray(rep), "qids": qids, "r0": r0}
    for seed in range(args.seeds):
        key = jax.random.PRNGKey(seed)
        index = rt.build_index(rep, cfg, spec.d2, key=key)
        out[f"init{seed}"] = np.asarray(init_centroids(key, rep, c))
        out[f"cent{seed}"] = np.asarray(index.centroids)
        for nprobe in _nprobes(c) + [c]:
            v, i = rt.search(index, q, K, nprobe, spec.d2, self_ids=sids)
            out[f"ref/{seed}/{nprobe}"] = np.stack(
                [np.asarray(v), np.asarray(i).astype(np.float32)])
        if seed == 0:  # where the packages part, for the first index
            csims = dense_similarity(q, index.centroids, spec.d2)
            out["ref_probe"] = np.asarray(
                jax.lax.top_k(csims, _nprobes(c)[0])[1])
            out["ref_csims"] = np.asarray(csims)
            out.update(_exact_inputs("ref", index))
            out["ref_exact"] = np.asarray(dense_similarity(
                q, jnp.asarray(out["ref_cand"]), spec.d2))
    return out


def _exact_inputs(side: str, index) -> dict:
    """The index's placement and its live payload rows sorted by id (the
    candidate matrix of the exact search), as numpy."""
    lists, fill = np.asarray(index.lists), np.asarray(index.fill)
    rows = np.asarray(index.rows).reshape(-1, index.rows.shape[-1])
    live = (np.arange(lists.shape[1])[None, :] < fill[:, None]).reshape(-1)
    flat = lists.reshape(-1)
    order = np.argsort(np.where(live, flat, 2 ** 31 - 1), kind="stable")
    order = order[:int(live.sum())]
    return {f"{side}_lists": lists, f"{side}_fill": fill,
            f"{side}_ids": flat[order], f"{side}_cand": rows[order]}


def _port_side(args, d: dict) -> dict:
    import dataclasses

    import torch

    from repro_torch import retrieval as rt
    from repro_torch.configs import landmark_cf as cfgs
    from repro_torch.core import RatingMatrix, fit
    from repro_torch.kernels import ref
    from repro_torch.retrieval.kmeans import kmeans

    spec = dataclasses.replace(cfgs.MODEL, selection=args.selection)
    rep = torch.as_tensor(d["rep"])
    own = fit(RatingMatrix(torch.as_tensor(d["r0"]), args.users, args.items),
              spec, generator=torch.Generator().manual_seed(0))
    cfg = rt.resolve_ivf(None, args.users)
    c = cfg.n_clusters
    qids = torch.as_tensor(d["qids"])
    q, sids = rep[qids], qids.to(torch.int32)
    out = {"rep_diff": np.float32(
        (own.representation - rep).abs().max()), "cent_diff": np.float32(0)}
    for seed in range(args.seeds):
        cent, _ = kmeans(rep, c, spec.d2, iters=cfg.iters,
                         init=torch.as_tensor(d[f"init{seed}"]))
        out["cent_diff"] = max(out["cent_diff"], np.float32(
            (cent - torch.as_tensor(d[f"cent{seed}"])).abs().max()))
        builds = {
            "port_ref_centroids": dict(
                centroids=torch.as_tensor(d[f"cent{seed}"])),
            "port_kmeans_ref_init": dict(centroids=cent),
            "port_own_init": dict(
                generator=torch.Generator().manual_seed(seed))}
        for name, kw in builds.items():
            index = rt.build_index(rep, cfg, spec.d2, **kw)
            for nprobe in _nprobes(c) + [c]:
                v, i = rt.search(index, q, K, nprobe, spec.d2, self_ids=sids)
                out[f"{name}/{seed}/{nprobe}"] = np.stack(
                    [v.numpy(), i.numpy().astype(np.float32)])
            if seed == 0 and name == "port_ref_centroids":
                out["port_probe"] = rt.probe_cells(
                    index, q, _nprobes(c)[0], spec.d2).numpy()
                out.update(_exact_inputs("port", index))
                out["port_exact"] = ref.gathered_sims(
                    q, torch.as_tensor(out["port_cand"]), spec.d2).numpy()
    return out


def _nprobes(c: int) -> list:
    return [max(1, int(c * f)) for f in NPROBES]


def _recall_id(got, want) -> float:
    """recall@k by id, empty (-inf) slots masked on both sides."""
    gv, gi = got
    wv, wi = want
    hit = (gi[:, :, None] == wi[:, None, :]) & np.isfinite(gv)[:, :, None]
    ok = np.isfinite(wv)
    hit &= ok[:, None, :]
    return float((hit.any(2).sum(1) / np.maximum(ok.sum(1), 1)).mean())


def _recall_score(got, want) -> float:
    """recall@k by score: a slot counts when it reaches the exact k-th
    score, so an exact tie swapped for another is no miss."""
    gv, wv = got[0], want[0]
    ok = np.isfinite(wv)
    cut = np.where(ok, wv, np.inf).min(1, keepdims=True)
    hit = (np.isfinite(gv) & (gv >= cut)).sum(1)
    n = ok.sum(1)
    return float((np.minimum(hit, n) / np.maximum(n, 1)).mean())


def _where_they_part(d: dict, nprobe: int) -> dict:
    """Placement, probe tables and exact per-pair scores of the reference's
    first index against the port's index around its centroids."""
    def cells(side):
        lists, fill = d[f"{side}_lists"], d[f"{side}_fill"]
        return {int(i): j for j in range(len(fill)) for i in lists[j, :fill[j]]}
    rc, pc = cells("ref"), cells("port")
    cs = -np.sort(-d["ref_csims"], axis=1)
    same_ids = bool(np.array_equal(d["ref_ids"], d["port_ids"]))
    rs, ps = d["ref_exact"], d["port_exact"]
    out = {"rows": len(rc), "rows_in_another_cell": sum(
        rc[i] != pc.get(i) for i in rc),
        "probe_nprobe": nprobe, "probe_same_cells": float(np.mean(
            [set(a) == set(b) for a, b in zip(d["ref_probe"],
                                              d["port_probe"])])),
        "probe_score_span": float((cs[:, 0] - cs[:, nprobe - 1]).mean()),
        "exact_candidates_equal": same_ids}
    if same_ids:
        ids, qids = d["ref_ids"], d["qids"]
        other = ids[None, :] != qids[:, None]  # the query's own row is out
        diff = np.abs(rs - ps)[other]
        c = int(d["cent0"].shape[0])
        rv, ri = d[f"ref/0/{c}"]
        pv, pi = d[f"port_ref_centroids/0/{c}"]
        out.update(
            exact_pair_max_abs_diff=float(diff.max()),
            exact_pair_share_equal=float((diff == 0).mean()),
            ids_at_kth_score_ref=float(np.mean(
                [(rs[b][other[b]] == rv[b, K - 1]).sum()
                 for b in range(len(qids))])),
            ids_at_kth_score_port=float(np.mean(
                [(ps[b][other[b]] == pv[b, K - 1]).sum()
                 for b in range(len(qids))])),
            queries_with_other_ids=int(sum(
                set(a.astype(int)) != set(b.astype(int))
                for a, b in zip(ri, pi))))
    return out


def _part_lines(p: dict) -> list:
    lines = [f"where they part (seed 0, port index around the reference's "
             f"centroids): {p['rows_in_another_cell']} of {p['rows']} rows "
             f"in another cell; probe tables at nprobe {p['probe_nprobe']} "
             f"hold the same cells for {p['probe_same_cells']:.3f} of the "
             f"queries, whose {p['probe_nprobe']} nearest centroids' "
             f"scores span {p['probe_score_span']:.3g} on average"]
    if p["exact_candidates_equal"]:
        lines.append(
            f"exact searches: the same candidates; per-pair scores "
            f"(reference GEMM vs port left-to-right sums) differ by up to "
            f"{p['exact_pair_max_abs_diff']:.3g}, equal for "
            f"{p['exact_pair_share_equal']:.3f} of pairs; ids tied at the "
            f"k-th score per query: reference "
            f"{p['ids_at_kth_score_ref']:.1f}, port "
            f"{p['ids_at_kth_score_port']:.1f}; "
            f"{p['queries_with_other_ids']} queries with other top-{K} ids")
    else:
        lines.append("exact searches: the candidate ids differ")
    return lines


def controlled(args, argv: list) -> int:
    (ROOT / "build").mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        files = {}
        for side in ("ref", "port"):
            files[side] = Path(tmp) / f"{side}.npz"
            res = subprocess.run(
                [sys.executable, __file__, "--side", side, "--npz",
                 str(Path(tmp) / "ref.npz")] + argv, cwd=ROOT,
                env=env, check=False)
            if res.returncode:
                return res.returncode
        d = dict(np.load(files["ref"]))
        d.update(np.load(files["port"]))
    c = int(d["cent0"].shape[0])
    nps = _nprobes(c)
    exact = {"ref": {s: d[f"ref/{s}/{c}"] for s in range(args.seeds)}}
    exact["port"] = {s: d[f"port_ref_centroids/{s}/{c}"]
                     for s in range(args.seeds)}
    ev = exact["ref"][0][0]
    spread = float((ev[:, 0] - ev[:, K - 1]).mean())
    print(f"controlled: U={args.users} P={args.items} C={c} selection="
          f"{args.selection}, {args.seeds} k-means seeds, 256 queries; the "
          f"exact top-{K} scores span {spread:.3g} on average (first minus "
          f"k-th)")
    print(f"  port fit vs reference representation: max |diff| "
          f"{float(d['rep_diff']):.3g}; port k-means from the reference's "
          f"init vs its centroids: max |diff| {float(d['cent_diff']):.3g}")
    table = {}
    for name in ("ref", "port_ref_centroids", "port_kmeans_ref_init",
                 "port_own_init"):
        for against in ("ref", "port"):
            for metric, fn in (("id", _recall_id), ("score", _recall_score)):
                a = np.asarray([[fn(d[f"{name}/{s}/{n}"], exact[against][s])
                                 for n in nps] for s in range(args.seeds)])
                table[f"{name} vs {against} exact, by {metric}"] = a.tolist()
                cols = "  ".join(
                    f"np{n}: {m:.3f} [{lo:.3f}, {hi:.3f}]" for n, m, lo, hi
                    in zip(nps, a.mean(0), a.min(0), a.max(0)))
                print(f"  {name:20s} vs {against:4s} exact, by {metric:5s}"
                      f" — {cols}")
    print("  (mean [min, max] over seeds; 'vs port exact' is the port's "
          "full-probe search around the reference's centroids)")
    parts = _where_they_part(d, nps[0])
    for line in _part_lines(parts):
        print("  " + line)
    table["where_they_part"] = parts
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"nprobe": nps, "clusters": c, "exact_spread": spread,
             "rep_diff": float(d["rep_diff"]),
             "cent_diff": float(d["cent_diff"]), "recall": table}, indent=1))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--users", type=int, default=1024)
    ap.add_argument("--items", type=int, default=512)
    ap.add_argument("--waves", type=int, default=8)
    ap.add_argument("--arrivals", type=int, default=64)
    ap.add_argument("--foldin", type=int, default=64)
    ap.add_argument("--selection", default="coresets")
    ap.add_argument("--json", default=None,
                    help="write both runs' parsed waves here")
    ap.add_argument("--controlled", action="store_true",
                    help="compare the index builds on one representation")
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--side", choices=("ref", "port"), default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--npz", default=None, help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.side:  # one half of --controlled, in a process of its own
        npz = Path(args.npz)
        d = {} if args.side == "ref" else dict(np.load(npz))
        fn = _ref_side if args.side == "ref" else _port_side
        np.savez(npz.with_name(f"{args.side}.npz"), **fn(args, d))
        return 0
    if args.controlled:
        return controlled(args, argv)
    flags = ["--users", str(args.users), "--items", str(args.items),
             "--waves", str(args.waves), "--arrivals", str(args.arrivals),
             "--foldin", str(args.foldin), "--selection", args.selection]
    runs = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for pkg in ("repro", "repro_torch"):
            runs[pkg], secs = run(pkg, flags, str(Path(tmp) / pkg))
            print(f"{pkg}: {secs:.1f}s, start {runs[pkg]['start']}")
    print("per wave — reference | port  (np settled nprobe/C; r recall@k by "
          "id[/by score]; ee early-exit recall; esc nprobe:recall steps)")
    ref = {w["wave"]: w for w in runs["repro"]["waves"]}
    port = {w["wave"]: w for w in runs["repro_torch"]["waves"]}
    for wave in sorted(set(ref) | set(port)):
        print(f"wave {wave}: {_fmt(ref.get(wave))} | {_fmt(port.get(wave))}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"flags": flags, "runs": runs}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
