#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and hold every CUDA
kernel against its plain PyTorch version.

Run from the root of the checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc`` (``$CUDA_HOME``, default ``/usr/local/cuda``), builds
the kernels from ``src/repro_torch/kernels/csrc`` into ``build/kernels/``,
and never falls back: without a card, or outside a checkout, it exits
non-zero and prints no result. Phases, one line each:

1. device — the card's name, count, and ``nvidia-smi`` name and power limit;
2. build — nvcc's seconds and its ``-Xptxas -v`` register/spill lines;
3. kernels — each kernel against its plain version on the card, at the
   main-path shapes, at ragged shapes and on duplicated rows, all three
   measures;
4. main path — MovieLens-1M-shaped synthetic ratings (seed 0), fold 0:
   fit on all users but the last 64, predict the test pairs, top-10 for
   256 users, fold in the last 64 users and predict theirs; run (a) with
   the kernels and (b) with the plain d1 and the streaming graph, and
   compared;
5. serve CLI — ``repro_torch.launch.serve`` at U=6040, P=3952, two waves;
6. times — each kernel and its plain version (CUDA events), its launches
   on the main path and its bound; a profiler breakdown of one fit →
   fold-in → predict (device time by kernel, idle share); wall times of
   fit, fold-in and a 256-pair predict, and peak device memory.

The last two lines are the kernel table and
``{"ok": true, "device": {"platform": "gpu", ...}}``. TF32 is off for
matmul and cuDNN throughout: the reference scores in full f32.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import landmark_cf as cfg  # noqa: E402
from repro_torch.core import (RatingMatrix, fit, fold_in, knn,  # noqa: E402
                              predict)
from repro_torch.core import similarity as sim  # noqa: E402
from repro_torch.core.graph import kernel_rows  # noqa: E402
from repro_torch.core.selection import popularity_landmarks  # noqa: E402
from repro_torch.core.topk import list_mismatches  # noqa: E402
from repro_torch.data import ratings as data  # noqa: E402
from repro_torch.kernels import build, knn_topk, ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

DEVICE = "cuda"
RTOL, ATOL = 1e-5, 1e-6
FOLD_IN = 64  # users held out of the fit and folded in
TOPN_USERS = 256
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

KERNELS = {
    "masked_similarity": dict(
        source="src/repro_torch/kernels/csrc/masked_similarity.cu",
        replaces="src/repro/kernels/masked_similarity.py:72"),
    "topk_sim": dict(
        source="src/repro_torch/kernels/csrc/knn_topk.cu",
        replaces="src/repro/kernels/knn_topk.py:114"),
    "foldin_topk": dict(
        source="src/repro_torch/kernels/csrc/knn_topk.cu",
        replaces="src/repro/kernels/knn_topk.py:235"),
}


def sync():
    torch.cuda.synchronize()


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"phase 1 device: {torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} "
          f"capability={torch.cuda.get_device_capability(0)} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    print(f"nvidia-smi: {card}")
    return card


def phase_build():
    _, log, seconds = build.build()
    build.library()
    keep = [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print(f"phase 2 build: {seconds:.1f}s -> {build.BUILD_DIR / build.LIB_NAME}"
          f" | ptxas: " + " ; ".join(keep))


def _topk_err(want, got):
    """Largest |Δ| over slots that hold a value in both (0 when none)."""
    wv, gv = want[0], got[0]
    finite = torch.isfinite(wv)
    if not torch.equal(finite, torch.isfinite(gv)):
        raise AssertionError("empty slots differ")
    return float((gv[finite] - wv[finite]).abs().max()) if finite.any() else 0.0


def _check_topk(name, want, got, strict=False):
    """Kernel lists against the plain version's: ids equal up to ties at the
    cut within rtol=1e-5/atol=1e-6, weights of matched ids within that
    tolerance; ``strict`` demands bitwise equality. Returns (max |Δ|,
    bitwise)."""
    sync()
    bitwise = torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    if strict and not bitwise:
        raise AssertionError(f"{name}: not bitwise equal to its plain version")
    bad = list_mismatches(want[0], want[1], got[0], got[1], RTOL, ATOL)
    if bad.size:
        raise AssertionError(f"{name}: rows {bad[:8].tolist()} disagree with "
                             f"the plain version beyond the tie rule")
    return _topk_err(want, got), bitwise


def _ratings(u, p, seed, density=0.08):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    return torch.as_tensor(r * (rng.random((u, p)) < density), device=DEVICE)


def phase_kernels(train):
    """Each kernel against its plain version. Returns the largest error at
    the main-path shapes per kernel."""
    fit_r, new_r = train[:-FOLD_IN], train[-FOLD_IN:]
    lm = fit_r[popularity_landmarks(fit_r, cfg.MODEL.n_landmarks)]
    ra = _ratings(1130, 777, seed=11)
    err = {name: 0.0 for name in KERNELS}
    notes = []

    def d1(tag, a, b, main):
        for measure in sim.MEASURES:
            got = ops.masked_similarity(a, b, measure)
            want = ref.masked_similarity_ref(a, b, measure)
            sync()
            if measure == "cosine" and not torch.equal(got, want):
                raise AssertionError(f"masked_similarity {tag}: cosine on "
                                     f"integer ratings is not bitwise equal")
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            e = float((got - want).abs().max())
            if main:
                err["masked_similarity"] = max(err["masked_similarity"], e)
        notes.append(f"d1 {tag} {tuple(a.shape)}x{tuple(b.shape)} ok")

    d1("fit", fit_r, lm, True)
    d1("fold-in", new_r, lm, True)
    d1("ragged", ra[:1000], ra[1000:], False)

    rep = sim.masked_similarity(train, lm)  # (U, n) as the main path makes it
    rag = sim.masked_similarity(ra[:1001], ra[:20])
    dup = rep[:300].repeat_interleave(3, dim=0)
    ints = torch.as_tensor(np.random.default_rng(12).integers(
        0, 4, (150, 20)).astype(np.float32), device=DEVICE)
    ints = ints.repeat_interleave(3, dim=0)
    exact = []
    for measure in sim.MEASURES:
        rows = kernel_rows(rep, measure)
        u = rows.shape[0] - FOLD_IN
        cases = [
            ("topk_sim", "fit", True, lambda f: f(rows[:u], rows[:u], 13,
                                                  exclude_self=True, n_valid=u,
                                                  measure=measure)),
            ("foldin_topk", "fold-in", True,
             lambda f: f(rows[u:].contiguous(), rows, 13, self_offset=u,
                         measure=measure)),
        ]
        rg = kernel_rows(rag, measure)
        cases += [
            ("topk_sim", "ragged", False, lambda f: f(
                rg, rg, 13, exclude_self=True, n_valid=990, measure=measure)),
            ("foldin_topk", "ragged", False, lambda f: f(
                rg[-37:].contiguous(), rg, 13, self_offset=1001 - 37,
                measure=measure)),
        ]
        dp = kernel_rows(dup, measure)
        cases.append(("topk_sim", "duplicated", False, lambda f: f(
            dp, dp, 13, exclude_self=True, measure=measure)))
        for name, tag, main, call in cases:
            plain = ref.topk_sim_ref if name == "topk_sim" else \
                ref.foldin_topk_ref
            kern = getattr(knn_topk, name)
            e, bitwise = _check_topk(f"{name} {tag} {measure}", call(plain),
                                     call(kern))
            exact.append(bitwise)
            if main:
                err[name] = max(err[name], e)
        if measure != "pearson":  # integer rows: every score exact
            _check_topk(f"topk_sim integer duplicates {measure}",
                        ref.topk_sim_ref(ints, ints, 13, exclude_self=True,
                                         measure=measure),
                        knn_topk.topk_sim(ints, ints, 13, exclude_self=True,
                                          measure=measure), strict=True)
    notes.append(f"top-k cases bitwise equal {sum(exact)}/{len(exact)}")
    print("phase 3 kernels: " + "; ".join(notes) + " | max |err| at main-path "
          "shapes " + json.dumps(err))
    return err


def _pairs(test_idx, d, lo, hi):
    keep = (d.users[test_idx] >= lo) & (d.users[test_idx] < hi)
    sel = test_idx[keep]
    return (torch.as_tensor(d.users[sel].astype(np.int64), device=DEVICE),
            torch.as_tensor(d.items[sel].astype(np.int64), device=DEVICE),
            d.ratings[sel])


def run_main_path(train, d, test_idx, kernels):
    """fit → predict → top-N → fold-in → predict, on the card. ``kernels``
    False forces the plain d1 and the streaming graph. Returns the outputs,
    the launch counts of this run, and its wall times."""
    spec = cfg.MODEL
    u_fit = train.shape[0] - FOLD_IN
    sim_fn = None if kernels else sim.masked_similarity
    backend = "auto" if kernels else "streaming"
    fit_pairs = _pairs(test_idx, d, 0, u_fit)
    new_pairs = _pairs(test_idx, d, u_fit, train.shape[0])
    rec_users = torch.arange(0, u_fit, u_fit // TOPN_USERS,
                             device=DEVICE)[:TOPN_USERS]
    sync()
    ops.reset_launches()
    t0 = time.perf_counter()
    st = fit(RatingMatrix(train[:u_fit], u_fit, train.shape[1]), spec, sim_fn,
             backend=backend)
    sync()
    t_fit = time.perf_counter() - t0
    pred_fit = predict(st, fit_pairs[0], fit_pairs[1], spec)
    top_i, top_s = knn.recommend_topn_graph(st.graph, st.ratings, rec_users,
                                            n=10)
    sync()
    t0 = time.perf_counter()
    st2 = fold_in(st, train[u_fit:], spec, sim_fn, backend=backend)
    sync()
    t_fold = time.perf_counter() - t0
    pred_new = predict(st2, new_pairs[0], new_pairs[1], spec)
    sync()
    counts = ops.launch_counts()
    return dict(state=st, folded=st2, pred_fit=pred_fit, pred_new=pred_new,
                top=(top_i, top_s), rec_users=rec_users, fit_pairs=fit_pairs,
                new_pairs=new_pairs, counts=counts, t_fit=t_fit,
                t_fold=t_fold)


def _same_sets(ga, gb):
    return (torch.sort(ga.indices, dim=1).values
            == torch.sort(gb.indices, dim=1).values).all(dim=1)


def phase_main_path(train, d, test_idx):
    torch.cuda.reset_peak_memory_stats()
    a = run_main_path(train, d, test_idx, kernels=True)
    peak = torch.cuda.max_memory_allocated()
    b = run_main_path(train, d, test_idx, kernels=False)
    if not all(v > 0 for v in a["counts"].values()):
        raise AssertionError(f"a kernel did not launch on the main path: "
                             f"{a['counts']}")
    if any(b["counts"].values()):
        raise AssertionError(f"plain run launched kernels: {b['counts']}")
    sa, sb = a["state"], b["state"]
    if not torch.equal(sa.landmark_idx, sb.landmark_idx):
        raise AssertionError("landmark ids differ")
    for x, y in ((sa, sb), (a["folded"], b["folded"])):
        if not torch.equal(x.representation, y.representation):
            raise AssertionError("cosine d1 representation not bitwise equal")
        bad = list_mismatches(y.graph.weights, y.graph.indices,
                              x.graph.weights, x.graph.indices, RTOL, ATOL)
        if bad.size:
            raise AssertionError(f"graph rows {bad[:8].tolist()} disagree "
                                 f"beyond the tie rule")
    out = {}
    for key, pairs, ga, gb in (
            ("fit", a["fit_pairs"], sa.graph, sb.graph),
            ("fold-in", a["new_pairs"], a["folded"].graph,
             b["folded"].graph)):
        pa = a["pred_fit" if key == "fit" else "pred_new"]
        pb = b["pred_fit" if key == "fit" else "pred_new"]
        same = _same_sets(ga, gb)
        keep = same[pairs[0]]
        torch.testing.assert_close(pa[keep], pb[keep], rtol=RTOL, atol=ATOL)
        keep_np = keep.cpu().numpy()
        truth = pairs[2]
        mae_a = data.mae(pa.cpu().numpy(), truth)
        mae_b = data.mae(pb.cpu().numpy(), truth)
        mae_same = abs(data.mae(pa.cpu().numpy()[keep_np], truth[keep_np])
                       - data.mae(pb.cpu().numpy()[keep_np], truth[keep_np]))
        if mae_same > RTOL:
            raise AssertionError(f"{key}: MAE differs by {mae_same} on rows "
                                 f"with equal neighbor sets")
        if not (torch.isfinite(pa).all() and pa.shape == (len(truth),)):
            raise AssertionError(f"{key}: predictions not finite / shaped")
        out[key] = dict(pairs=len(truth), mae_kernels=mae_a, mae_plain=mae_b,
                        rows_tie_swapped=int((~same).sum()),
                        pairs_on_swapped_rows=int((~keep_np).sum()))
    same = _same_sets(sa.graph, sb.graph)[a["rec_users"]]
    ia, sa_ = a["top"]
    ib, sb_ = b["top"]
    if ia.shape != (TOPN_USERS, 10) or (ia < 0).any():
        raise AssertionError("top-N shape or sentinel")
    bad = list_mismatches(sb_[same], ib[same], sa_[same], ia[same], RTOL, ATOL)
    if bad.size:
        raise AssertionError(f"top-N rows {bad[:8].tolist()} disagree")
    print(f"phase 4 main path: U={train.shape[0]} P={train.shape[1]} "
          f"n={cfg.MODEL.n_landmarks} k={cfg.MODEL.k_neighbors} "
          f"launches(a)={a['counts']} launches(b)={b['counts']} "
          f"fit(a)={a['t_fit']:.3f}s fold-in(a)={a['t_fold']:.4f}s | "
          + json.dumps(out))
    return a, peak


def phase_serve():
    t0 = time.perf_counter()
    serve.main(["--workload", "cf", "--users", "6040", "--items", "3952",
                "--waves", "2", "--foldin", "64"])
    print(f"phase 5 serve CLI: {time.perf_counter() - t0:.1f}s")


def _event_ms(fn, iters):
    for _ in range(3):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def _wall_s(fn, reps=5):
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _profile(run):
    """Device time by kernel and the device's busy share over one run of
    ``run`` under ``torch.profiler`` (CUPTI). The share is the union of
    kernel intervals over the span from the first kernel's start to the
    last one's end; the profiler's own host cost widens the gaps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        sync()
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.split("(")[0].removeprefix("void ")[:72]
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e3
    if not spans:
        return {"device_time": "not measured (no device events)"}
    spans.sort()
    busy, end = 0.0, spans[0][0]
    for t0, t1 in spans:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    window = end - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"kernels_launched": len(spans), "device_busy_ms": busy / 1e3,
            "window_ms": window / 1e3, "idle_share": 1 - busy / window,
            "top_ms": dict(top)}


def _bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_times(train, a, err, peak):
    st = a["state"]
    u_fit, p = st.ratings.shape
    n, k = st.representation.shape[1], st.graph.k
    lm = st.ratings[st.landmark_idx]
    rows = kernel_rows(st.representation, "cosine")
    new = kernel_rows(a["folded"].representation[u_fit:], "cosine")
    cand = torch.cat([rows, new])
    b = new.shape[0]
    c = cand.shape[0]
    calls = {
        "masked_similarity": (
            lambda: ops.masked_similarity(st.ratings, lm),
            lambda: ref.masked_similarity_ref(st.ratings, lm),
            4 * (u_fit * p + n * p + u_fit * n), 12 * u_fit * n * p,
            f"A={u_fit} B={n} P={p} (fit; fold-in A={b})"),
        "topk_sim": (
            lambda: knn_topk.topk_sim(rows, rows, k, exclude_self=True),
            lambda: ref.topk_sim_ref(rows, rows, k, exclude_self=True),
            4 * (2 * u_fit * n + 2 * u_fit * k), 2 * u_fit * u_fit * n,
            f"U=C={u_fit} n={n} k={k}"),
        "foldin_topk": (
            lambda: knn_topk.foldin_topk(new, cand, k, self_offset=u_fit),
            lambda: ref.foldin_topk_ref(new, cand, k, self_offset=u_fit),
            4 * (b * n + c * n + 2 * b * k), 2 * b * c * n,
            f"b={b} C={c} n={n} k={k}"),
    }
    launches = a["counts"]
    table = []
    for name, (kern, plain, nbytes, flops, shape) in calls.items():
        bound_ms, bound_by = _bound(nbytes, flops)
        ms = _event_ms(kern, 50)
        table.append(dict(
            name=name, route="cuda", **KERNELS[name], shape=shape,
            launches=launches[name], max_abs_err=err[name],
            max_err=err[name], ms=ms, plain_ms=_event_ms(plain, 10),
            bound_ms=bound_ms, bound_us=bound_ms * 1e3, bound_by=bound_by,
            library_ms=None))
    spec = cfg.MODEL
    users, items = (x[:256] for x in a["fit_pairs"][:2])
    print("phase 6 profile: " + json.dumps(_profile(
        lambda: predict(fold_in(fit(RatingMatrix(train[:u_fit], u_fit, p),
                                    spec), train[u_fit:], spec),
                        users, items, spec))))
    walls = dict(
        fit_s=_wall_s(lambda: fit(RatingMatrix(train[:u_fit], u_fit, p),
                                  spec)),
        fold_in_s=_wall_s(lambda: fold_in(st, train[u_fit:], spec)),
        predict_256_pairs_s=_wall_s(lambda: predict(st, users, items, spec)),
        peak_device_bytes_main_path=peak)
    print("phase 6 times: " + json.dumps(walls))
    return table


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port never falls back to the "
              "CPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmul and cuDNN (full f32, as the reference's "
          "Precision.HIGHEST)")
    card = phase_device()
    phase_build()
    t0 = time.perf_counter()
    d = data.synthesize("movielens1m", seed=0)
    train_idx, test_idx = data.kfold_split(d, 0)
    train = d.to_matrix(train_idx, device=DEVICE).ratings
    print(f"data: movielens1m-shaped synthetic, {d.n_ratings} ratings, "
          f"{time.perf_counter() - t0:.1f}s")
    err = phase_kernels(train)
    a, peak = phase_main_path(train, d, test_idx)
    phase_serve()
    table = phase_times(train, a, err, peak)
    print(f"card: {card}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
