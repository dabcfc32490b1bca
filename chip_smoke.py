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
   for the tensor-core landmark-summary kernel, per route (bf16, f32) and
   head dim, and for d1's tensor-core moments kernel, per load width:
   registers, static shared memory, spills, and the HGMMA (wgmma)
   instructions that ``cuobjdump -sass`` counts in it
   (``wgmma.mma_async`` in its PTX where the toolkit has no
   ``cuobjdump``) — none is a failure; for the fused IVF probe kernel, per
   padded row width, for the top-k scan kernel, per tile variant and
   measure, and for the Lloyd kernel, per register row width, its
   registers, static shared memory and spills;
3. kernels — each kernel against its plain version on the card, at the
   main-path shapes, at ragged shapes, on duplicated rows and (the top-k
   scan) at the paper tables' widest representation, 100 landmarks, all
   three measures; the top-k kernels bitwise (values and ids), or the run fails; d1 on both routes, the tensor-core route bitwise the f32
   route, also at the guard's limits (|v| = 8, P = 65535), and off the
   guard (1.1-star steps) the f32 route's result;
4. main path — MovieLens-1M-shaped synthetic ratings (seed 0), fold 0:
   fit on all users but the last 64, predict the test pairs, top-10 for
   256 users, fold in the last 64 users and predict theirs; run (a) with
   the kernels and (b) with the plain d1 and the streaming graph, and
   compared; d1's result by route for each call of (a) (each must be the
   tensor-core route's), and (c) (a) again with d1 on its f32 route, every
   output bitwise (a)'s;
5. serve CLI — ``repro_torch.launch.serve`` at U=6040, P=3952, two waves;
6. times — each kernel and its plain version (CUDA events, which include
   the host's launch cost), the kernel's own device time (profiler), its
   launches on its path and its bound (d1's tensor-core route and the
   fused IVF probe count every kernel of their call: the workspace memset,
   planes, moments and finalize; the order, then the probe); d1 as two
   rows, the tensor-core route and the f32 route forced, each also at the
   fold-in shape; the fused
   probe again at the lifecycle's batch sizes (64 and 256 queries), with
   the groups of the graph build's call (queries a block, union cells,
   rows staged against rows probed); kernel 4 as the whole ``kmeans()``
   call (one launch) for each measure at the IVF shape and, cosine, at the
   lifecycle's capacity bucket, beside the assignment alone and
   ``build_index``; a profiler breakdown of one fit →
   fold-in → predict (device time by kernel, idle share); wall times of
   fit, fold-in and a 256-pair predict, and peak device memory.

The IVF retrieval slice adds, each with its own time:

7a. IVF kernels — the Lloyd kernel (the assignment alone, and a whole
    k-means: 0, 1 and 8 steps at the IVF shape, (1001, 13, 64), (37, 300, 33), (9, 1, 1) and (300, 7,
    25), so every register width, the lifecycle's capacity bucket with
    n_valid < U, and with an empty cell; two launches bitwise equal), the
    fused IVF probe and the
    gathered-candidate scorer against their plain versions, bitwise, at the
    IVF path's shapes (the index over the fitted ML-1M representation:
    C=77 cells, cap=104, nprobe=19, k=13) and on edge cases (empty cells,
    k above the live candidates, self ids, probe masks, bf16 and int8
    payloads, C not a multiple of 8, all three measures), and at a 64-row
    batch and on the graph build's queries shuffled (whose lists must be
    the unshuffled ones moved);
7b. IVF path — the same data: ``fit(..., backend="ivf")`` at the default
    nprobe (recall@13 against the kernel graph), at nprobe == C (equal to
    the streaming backend under the tie rule), a 64-user ivf fold-in, and
    ``search(scorer="kernel")`` against ``scorer="fused"``; the index
    that ``fit`` built and the one built again from the same seed bitwise
    equal (centroids, lists, rows, fill); kernels 4–6 must launch, and
    every d1 call must keep the tensor-core route's result;
7c. lifecycle CLI — ``serve --lifecycle --retrieval ivf --early-exit``,
    once at smoke size (a refresh fires, gen 1 swaps in oracle-exact, the
    geometries stay within the buckets, mean recall >= 0.95) and once at
    full width (U=6040, P=3952, 64 arrivals and a 64-row fold-in batch per
    wave, 8 waves); every kernel must launch in each run, and every d1
    call must keep the tensor-core route's result.

The LM slice adds, each with its own time:

8a. landmark summary kernels — both routes (bf16 inputs on the tensor-core
    loop as they are, f32 inputs split into bf16 terms first and run
    through the same loop) against the plain version (dense f32 softmax) at
    the reference tests' shapes (n, S, D) = (64, 1024, 64),
    (128, 2048, 128), (32, 512, 256), a ragged (16, 777, 32), ragged S and
    n with P > 1 at D = 128 and 256, S below one key tile, and the
    SmolLM-360M landmark shape: 10 problems (B=2 × 5 kv heads) of
    G·n = 1536 landmark queries against S = 4096, D = 64; rtol=1e-4,
    atol=1e-5 (the reference's kernel-vs-oracle tolerance); and the f32
    route's split pass bitwise against the same rounding in torch there;
8b. landmark-attention forward — SmolLM-360M at full width (32 layers,
    random weights from seed 0), ``attn_backend="landmark"``, B = 2,
    S = 4096, tokens ``lm_batch(0, 0, 2, 4096, 49152)``: once through the
    kernel (which must launch 32 times, one per layer, all on the
    tensor-core route) and once with the plain B̃V; logits within 5% of
    the largest logit (bf16), both CE losses printed; then the same forward
    in f32 with the depth cut to 2 layers, through the f32_split route (2
    launches, 6 split passes) and the plain B̃V, held to the same bounds;
8c. LM serve CLI — ``serve --workload lm --arch smollm-360m`` with the
    exact KV cache and with ``--landmark``, full width; and one exact
    decode step's logits against ``lm_forward``'s last position within
    0.15, the reference's bf16 bound.

The engine slice adds:

9.  engine CLI — ``serve --workload cf --engine``, once ``--smoke`` and once
    at full width (U=6040, P=3952, 128-row batches, 64-row folds, 8 s of
    open-loop load, ``--retrieval ivf --early-exit``) with ``--trace-dir``,
    ``--metrics-json`` and ``--torch-profile`` under ``build/phase9/``:
    each run's bitwise-vs-solo audit must re-run N > 0 requests with 0
    mismatches, with no non-finite prediction, at least one fold, the read
    geometries within |batch shapes| x |capacities|, every d1 call on the
    tensor-core route; at full width also d1, the fold-in scan and kernels
    4-6 launched, the exports through ``benchmarks/check_obs.py``
    (read/fold overlap required), and, in the profiler trace of the load
    window, the fold lane's d1 and scan kernels on a stream no read batch
    ran on, launched by the fold lane's thread. Prints sustained QPS, read
    p50/p95/p99, shed and pad fractions, fold p50/p99 and the device's
    busy and idle share of the load window; the kernel table gains each
    row's launches in the full run (``launches_engine``).

The mutation slice adds:

10. mutation — at the main-path fit (users 0..5975, MODEL), for all three
    d2 measures, after an 8-user update (no tombstone) and an 8-user
    removal: the repair rescan on the scan kernel (live rows gathered,
    top-(k+1), ids mapped back, self dropped) bitwise the same pipeline
    with the kernel's plain version, and within the tie rule of the
    streaming rescan (euclidean at B3's 2e-3); the drop-row scatters with
    ineffective ids; the IVF-backed repair at partial probe (the gathered
    scorer) bitwise the plain scorer's lists; then the full-width oracle: 8 updates (one a landmark
    user) and 8 removals drained, against the port's own kernel build over
    the mutated matrix with the frozen basis (ratings and representation
    bitwise, the graph under the tie rule, the weights differing in any bit
    counted), and again after ``compact_tombstones`` over the survivors, no
    live row citing a dead one; the device time of a drain of 8 dirty
    rows. Then ``serve --engine --mutations``, ``--smoke`` and at full
    width (obs exports and a profiler capture under ``build/phase10/``):
    audit N > 0 with 0 mismatches, no non-finite prediction, at least one
    update and one removal, the pre-compaction bar, repair rescans on the
    scan kernel, the smoke's compacting swap, and at full width every
    write-lane kernel on a stream no read batch ran on. Prints QPS, read
    p50/p95/p99, write-lane p50/p99 per kind, mutated and repaired rows
    and the tombstone fraction; the kernel table gains each row's launches
    in the full run (``launches_mutations``).

The paper-comparison slice adds:

11. paper comparison — (a) each MF baseline (RSVD, IRSVD, PMF, SVD++), one
    epoch at the ML-1M fold-0 shape, on the card and on the CPU from the
    same initial parameters and permutation: the largest parameter
    difference and the MAE difference, held to ``MF_PARAM_ATOL`` and
    ``MF_MAE_ATOL``; (b) one BPMF Gibbs sweep there, card against CPU on
    the same draws, held to ``BPMF_ATOL``; (c) Table 15
    (``tools/paper_tables_torch.py::tab15_comparative``) on the card, every
    row (algorithm, MAE, seconds, ×-slower than landmarks), held to the
    reference's bars (landmark MAE < 1.1, every other row < 1.2, landmark
    within 0.02 of cosine kNN), d1 and the d2 scan launched; (d) compact
    serving: the main-path fit's uint16/bf16 graph read against the
    widened graph within 2e-2 (the uint16 gather bitwise), then ``serve
    --compact`` at ML-1M width (stored compact) and ``serve --lifecycle
    --retrieval ivf --smoke --compact-serving`` (a compacted wave, an
    oracle-exact swap), with d1, the fold-in scan, the Lloyd kernel and
    the fused probe launched. The kernel table gains each row's launches
    in (c) and (d) (``launches_paper``).

The last two lines are the kernel table and
``{"ok": true, "device": {"platform": "gpu", ...}}``. TF32 is off for
matmul and cuDNN throughout: the reference scores in full f32.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import landmark_cf as cfg  # noqa: E402
from repro_torch.core import (RatingMatrix, fit, fold_in, knn,  # noqa: E402
                              predict)
from repro_torch.core import similarity as sim  # noqa: E402
from repro_torch.core.graph import (build_neighbor_graph,  # noqa: E402
                                    filter_self_from_topk, kernel_rows)
from repro_torch.core.selection import popularity_landmarks  # noqa: E402
from repro_torch.core.topk import canonical_topk, list_mismatches  # noqa: E402
from repro_torch.data import ratings as data  # noqa: E402
from repro_torch import retrieval as rt  # noqa: E402
from repro_torch.core.graph import finalize_topk  # noqa: E402
from repro_torch.kernels import (assign_clusters, build, ivf_probe,  # noqa: E402
                                 knn_topk, ops, ref, score_candidates)
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import landmark_attention as lsum  # noqa: E402
from repro_torch.kernels import masked_similarity as ms  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.lifecycle import buckets  # noqa: E402
from repro_torch import mutation  # noqa: E402
from repro_torch.baselines import bpmf, mf  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402

sys.path.insert(0, str(ROOT / "tools"))
import paper_tables_torch as paper  # noqa: E402

DEVICE = "cuda"
RTOL, ATOL = 1e-5, 1e-6
FOLD_IN = 64  # users held out of the fit and folded in
TOPN_USERS = 256
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
# exp2 results/s of the special-function units: 132 SMs x 16 a clock
# (compute capability 9.0) x 1.83 GHz, the clock behind the 989 TFLOP/s
SFU_PER_S = 132 * 16 * 1.83e9

KERNELS = {
    # d1's two routes: bf16 wgmma moments (exact on ratings, guarded), and
    # f32 FMAs on the CUDA cores
    "masked_similarity": dict(
        source="src/repro_torch/kernels/csrc/masked_similarity.cu",
        replaces="src/repro/kernels/masked_similarity.py:72"),
    "masked_similarity_f32": dict(
        source="src/repro_torch/kernels/csrc/masked_similarity.cu",
        replaces="src/repro/kernels/masked_similarity.py:72"),
    "topk_sim": dict(
        source="src/repro_torch/kernels/csrc/knn_topk.cu",
        replaces="src/repro/kernels/knn_topk.py:114"),
    "foldin_topk": dict(
        source="src/repro_torch/kernels/csrc/knn_topk.cu",
        replaces="src/repro/kernels/knn_topk.py:235"),
    "assign_clusters": dict(
        source="src/repro_torch/kernels/csrc/assign_clusters.cu",
        replaces="src/repro/retrieval/kmeans.py:74"),
    "fused_probe_topk": dict(
        source="src/repro_torch/kernels/csrc/ivf_probe.cu",
        replaces="src/repro/kernels/ivf_probe.py:135"),
    "score_candidates": dict(
        source="src/repro_torch/kernels/csrc/score_candidates.cu",
        replaces="src/repro/retrieval/index.py:519"),
    # kernel 7's two routes, both on the tensor cores: bf16 inputs as they
    # are, f32 inputs split into bf16 terms first
    "landmark_summary": dict(
        source="src/repro_torch/kernels/csrc/landmark_summary.cu",
        replaces="src/repro/kernels/landmark_attention.py:51"),
    "landmark_summary_f32": dict(
        source="src/repro_torch/kernels/csrc/landmark_summary.cu",
        replaces="src/repro/kernels/landmark_attention.py:51"),
}
GRAPH_KERNELS = ("masked_similarity", "topk_sim", "foldin_topk")
IVF_KERNELS = ("assign_clusters", "fused_probe_topk", "score_candidates")
CF_KERNELS = GRAPH_KERNELS + IVF_KERNELS
# the landmark-attention forward of phase 8b: SmolLM-360M at full width
LM_ARCH, LM_BATCH, LM_SEQ = "smollm-360m", 2, 4096
LM_RTOL, LM_ATOL = 1e-4, 1e-5  # kernel 7 vs its plain version
LM_LOGIT_REL = 0.05  # bf16 forward, kernel vs plain B̃V, of max |logit|
DECODE_ATOL = 0.15  # bf16 decode step vs forward (tests/test_archs_smoke.py)


def sync():
    torch.cuda.synchronize()


def _counts():
    """Every wrapper's launches since the last reset, with d1's f32-route
    launches as ``masked_similarity_f32``."""
    counts = ops.launch_counts()
    counts["masked_similarity_f32"] = ms.masked_similarity.route_launches[
        "f32"]
    return counts


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
    print("phase 2 tensor-core kernel: " + json.dumps(_wgmma_report(
        log, "landmark_summary", _wgmma_name, 8,
        "2 routes x 4 head dims")))
    print("phase 2 d1 tensor-core kernel: " + json.dumps(_wgmma_report(
        log, "masked_similarity", _d1_name, 2,
        "16-byte and 4-byte loads")))
    print("phase 2 fused probe kernel: " + json.dumps(_ptxas(log, _probe_name)))
    print("phase 2 top-k scan kernel: " + json.dumps(_ptxas(log, _scan_name)))
    print("phase 2 Lloyd kernel: " + json.dumps(_ptxas(log, _lloyd_name)))


def _wgmma_name(line):
    """'bf16 D=64' / 'f32 D=64' for a line naming an instantiation of the
    tensor-core summary kernel (template <int D, bool F32>), else None."""
    import re

    m = re.search(r"summary_wgmma_kernelILi(\d+)ELb([01])E", line)
    return f"{('bf16', 'f32')[int(m.group(2))]} D={m.group(1)}" if m else None


def _d1_name(line):
    """'16-byte loads' / '4-byte loads' for a line naming an instantiation
    of d1's tensor-core moments kernel (template <bool VEC>), else None."""
    import re

    m = re.search(r"moments_wgmma_kernelILb([01])E", line)
    return f"{(4, 16)[int(m.group(1))]}-byte loads" if m else None


def _probe_name(line):
    """'n<=20' for a line naming an instantiation of the fused probe
    kernel (template <int NV4>: rows padded to 4·NV4), else None."""
    import re

    m = re.search(r"probe_group_kernelILi(\d+)E", line)
    return f"n<={4 * int(m.group(1))}" if m else None


def _lloyd_name(line):
    """'n<=20' for a line naming an instantiation of the Lloyd kernel
    (template <int NMAX>: a register row of NMAX floats), else None."""
    import re

    m = re.search(r"lloyd_kernelILi(\d+)E", line)
    return f"n<={m.group(1)}" if m else None


def _scan_name(line):
    """'R=2 S=4 W=8 stages=4 cosine' for a line naming an instantiation of
    the top-k scan kernel (template <class T, int M>: T a Tile<R, S, W,
    STAGES, MINB>, M the measure), else None."""
    import re

    m = re.search(r"topk_scan_kernelI\w*?TileILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)"
                  r"ELi\d+EEELi(\d)E", line)
    if not m:
        return None
    r, s, w, stages, measure = m.groups()
    return (f"R={r} S={s} W={w} stages={stages} "
            f"{sim.MEASURES[int(measure)]}")


def _ptxas(log, name_of):
    """The ``-Xptxas -v`` registers, static shared memory and spill bytes
    of each kernel instantiation that ``name_of`` names."""
    import re

    report, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = name_of(ln)
        elif name and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
            report.setdefault(name, {})["spill_bytes"] = [int(m.group(1)),
                                                          int(m.group(2))]
        elif name and "Used" in ln and "registers" in ln:
            entry = report.setdefault(name, {})
            entry["registers"] = int(re.search(r"Used (\d+) registers",
                                               ln).group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            entry["static_smem_bytes"] = int(sm.group(1)) if sm else 0
    return report


def _wgmma_report(log, stem, name_of, want, what):
    """Per instantiation of a tensor-core kernel in ``csrc/<stem>.cu`` that
    ``name_of`` names: the ``-Xptxas -v`` registers, static shared memory
    and spill bytes, and the wgmma instructions in its machine code. Raises
    unless ``want`` instantiations (``what``) each have some."""
    report = _ptxas(log, name_of)
    obj = build.BUILD_DIR / f"{stem}.o"
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    if cuobjdump.exists():
        sass = subprocess.run([str(cuobjdump), "-sass", str(obj)],
                              capture_output=True, text=True,
                              check=True).stdout
        count, name = {}, None
        for ln in sass.splitlines():
            if "Function :" in ln:
                name = name_of(ln)
            elif name and "HGMMA" in ln:
                count[name] = count.get(name, 0) + 1
        how = "HGMMA in cuobjdump -sass"
    else:
        ptx = subprocess.run(
            [build.nvcc(), build.ARCH, "-std=c++17", "-O3", "-ptx", "-o", "-",
             str(build.CSRC / f"{stem}.cu")],
            capture_output=True, text=True, check=True).stdout
        count = {"all": ptx.count("wgmma.mma_async")}
        how = "wgmma.mma_async in the PTX"
    if not count or min(count.values()) == 0 or (
            "all" not in count and len(count) != want):
        raise AssertionError(f"{stem}: not {want} instantiations ({what}) "
                             f"each with wgmma ({how}: {count})")
    return {"instructions": how, "count": count, "ptxas": report}


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
    err = {name: 0.0 for name in GRAPH_KERNELS}
    notes = []

    def d1(tag, a, b, main):
        """Both routes against the plain version; the tensor-core route
        (guard on) bitwise the f32 route for every measure."""
        for measure in sim.MEASURES:
            want = ref.masked_similarity_ref(a, b, measure)
            f32 = ops.masked_similarity(a, b, measure, route="f32")
            for route, got in (("tensor_core", ops.masked_similarity(
                    a, b, measure)), ("f32", f32)):
                sync()
                if measure == "cosine" and not torch.equal(got, want):
                    raise AssertionError(f"masked_similarity {tag} {route}: "
                                         f"cosine on integer ratings is not "
                                         f"bitwise equal")
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
                if not torch.equal(got, f32):
                    raise AssertionError(f"masked_similarity {tag} "
                                         f"{measure}: the tensor-core route "
                                         f"is not bitwise the f32 route")
                e = float((got - want).abs().max())
                if main:
                    key = "masked_similarity" + (
                        "_f32" if route == "f32" else "")
                    err[key] = max(err[key], e)
        notes.append(f"d1 {tag} {tuple(a.shape)}x{tuple(b.shape)} ok")

    err["masked_similarity_f32"] = 0.0
    ops.reset_launches()
    d1("fit", fit_r, lm, True)
    d1("fold-in", new_r, lm, True)
    d1("ragged", ra[:1000], ra[1000:], False)
    # the guard's limits: ±8, ±7.5 and ½ at the largest P the route takes
    # (every x and y up to 64·P, just under 2^22), bitwise the f32 route
    rng = np.random.default_rng(13)
    big = rng.choice([-8.0, -7.5, 0.5, 7.5, 8.0], (155, ref.D1_MAX_ITEMS))
    big *= rng.random(big.shape) < 0.7
    big[:3] = 8.0
    big = torch.as_tensor(big.astype(np.float32), device=DEVICE)
    d1("guard limits", big[:130], big[130:], False)
    results = ms.route_results()
    if results != {"tensor_core": 12, "f32_fallback": 0}:
        raise AssertionError(f"d1 on ratings: results {results}, not 12 "
                             f"tensor-core results")
    # off the guard (1.1-star steps): the f32 route's result, bitwise
    off = ra[:1000] * 1.1
    for measure in sim.MEASURES:
        got = ops.masked_similarity(off, ra[1000:], measure)
        want = ops.masked_similarity(off, ra[1000:], measure, route="f32")
        sync()
        if not torch.equal(got, want):
            raise AssertionError("d1 off the guard: not the f32 route's "
                                 "result")
    results = ms.route_results()
    if results != {"tensor_core": 12, "f32_fallback": 3}:
        raise AssertionError(f"d1 off the guard: results {results}")
    notes.append(f"d1 guard: P={ref.D1_MAX_ITEMS} at |v| <= 8 bitwise; "
                 f"1.1-steps take the f32 result ({results})")

    rep = sim.masked_similarity(train, lm)  # (U, n) as the main path makes it
    rag = sim.masked_similarity(ra[:1001], ra[:20])
    # the paper tables' widest representation: 100 landmarks
    wide = sim.masked_similarity(train[:2000], train[:100])
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
        wd = kernel_rows(wide, measure)
        cases += [
            ("topk_sim", "n=100", False, lambda f: f(
                wd, wd, 13, exclude_self=True, measure=measure)),
            ("foldin_topk", "n=100", False, lambda f: f(
                wd[-64:].contiguous(), wd, 13, self_offset=2000 - 64,
                measure=measure)),
        ]
        for name, tag, main, call in cases:
            plain = ref.topk_sim_ref if name == "topk_sim" else \
                ref.foldin_topk_ref
            kern = getattr(knn_topk, name)
            e, bitwise = _check_topk(f"{name} {tag} {measure}", call(plain),
                                     call(kern), strict=True)
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


def _d1_f32(r_a, r_b, measure="cosine"):
    """d1 forced onto its f32 route (the kernel before the tensor-core
    route existed)."""
    return ops.masked_similarity(r_a, r_b, measure, route="f32")


def run_main_path(train, d, test_idx, kernels, sim_fn=None):
    """fit → predict → top-N → fold-in → predict, on the card. ``kernels``
    False forces the plain d1 and the streaming graph; ``sim_fn`` replaces
    the default d1. Returns the outputs, the launch counts of this run (d1's
    f32-route launches as ``masked_similarity_f32``), d1's results by route
    after fit and after fold-in, and its wall times."""
    spec = cfg.MODEL
    u_fit = train.shape[0] - FOLD_IN
    sim_fn = sim_fn if kernels else sim.masked_similarity
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
    d1_fit = ms.route_results()
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
    counts = _counts()
    d1_all = ms.route_results()
    d1 = {"fit": d1_fit, "fold-in": {k: d1_all[k] - d1_fit[k]
                                     for k in d1_all}}
    return dict(state=st, folded=st2, pred_fit=pred_fit, pred_new=pred_new,
                top=(top_i, top_s), rec_users=rec_users, fit_pairs=fit_pairs,
                new_pairs=new_pairs, counts=counts, d1=d1, t_fit=t_fit,
                t_fold=t_fold)


def _check_d1_routes(where, counts, results):
    """Every d1 call of a run took the tensor-core route and kept its
    result: none went to the f32 route, none had its result replaced."""
    n = counts["masked_similarity"]
    if not (n > 0 and counts["masked_similarity_f32"] == 0
            and results == {"tensor_core": n, "f32_fallback": 0}):
        raise AssertionError(f"{where}: d1 calls {n}, f32-route launches "
                             f"{counts['masked_similarity_f32']}, results "
                             f"{results}: not every call took the "
                             f"tensor-core route's result")


def _same_sets(ga, gb):
    return (torch.sort(ga.indices, dim=1).values
            == torch.sort(gb.indices, dim=1).values).all(dim=1)


def phase_main_path(train, d, test_idx):
    torch.cuda.reset_peak_memory_stats()
    a = run_main_path(train, d, test_idx, kernels=True)
    peak = torch.cuda.max_memory_allocated()
    b = run_main_path(train, d, test_idx, kernels=False)
    if not all(a["counts"][name] > 0 for name in GRAPH_KERNELS):
        raise AssertionError(f"a kernel did not launch on the main path: "
                             f"{a['counts']}")
    if any(b["counts"].values()):
        raise AssertionError(f"plain run launched kernels: {b['counts']}")
    for step, results in a["d1"].items():
        if results != {"tensor_core": 1, "f32_fallback": 0}:
            raise AssertionError(f"main path {step}: d1 results {results}, "
                                 f"not one tensor-core result")
    _check_d1_routes("main path", a["counts"], {
        k: a["d1"]["fit"][k] + a["d1"]["fold-in"][k]
        for k in a["d1"]["fit"]})
    # (c): the same run with d1 on its f32 route, the kernel the tensor-core
    # route replaced on this path: every output bitwise equal
    c = run_main_path(train, d, test_idx, kernels=True, sim_fn=_d1_f32)
    same_c = {
        "representation": torch.equal(a["state"].representation,
                                       c["state"].representation),
        "folded representation": torch.equal(
            a["folded"].representation, c["folded"].representation),
        "graph": all(torch.equal(x, y) for x, y in (
            (a["state"].graph.weights, c["state"].graph.weights),
            (a["state"].graph.indices, c["state"].graph.indices),
            (a["folded"].graph.weights, c["folded"].graph.weights),
            (a["folded"].graph.indices, c["folded"].graph.indices))),
        "predictions": torch.equal(a["pred_fit"], c["pred_fit"])
        and torch.equal(a["pred_new"], c["pred_new"]),
        "top-N": all(torch.equal(x, y) for x, y in zip(a["top"], c["top"]))}
    if not all(same_c.values()) or c["counts"]["masked_similarity_f32"] != 2:
        raise AssertionError(f"main path, d1 tensor-core vs f32 route: "
                             f"bitwise {same_c}, f32 launches "
                             f"{c['counts']['masked_similarity_f32']}")
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
          f"d1 results by call (a) {json.dumps(a['d1'])}; (c) d1 on the "
          f"f32 route: every output bitwise (a)'s ({', '.join(same_c)}) | "
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


# the device functions of each wrapper, as the profiler names them
DEVICE_FUNCS = {
    # the tensor-core route: every kernel of the call (the workspace memset,
    # the planes, the moments, the finalize launch)
    "masked_similarity": None,
    "masked_similarity_f32": ("masked_similarity_kernel",),
    # the prep pass, the scan, and the merge of the candidate splits
    "topk_sim": ("topk_prep_kernel", "topk_scan_kernel", "topk_merge_kernel"),
    "foldin_topk": ("topk_prep_kernel", "topk_scan_kernel",
                    "topk_merge_kernel"),
    "assign_clusters": ("lloyd_kernel",),
    # None: every kernel of the call (the argsort that groups the queries,
    # then the probe kernel)
    "fused_probe_topk": None,
    "score_candidates": ("score_kernel",),
    "landmark_summary": ("summary_wgmma_kernel",),
    "landmark_summary_f32": ("summary_wgmma_kernel", "split_terms_kernel"),
    "split_terms": ("split_terms_kernel",),  # the f32 route's split pass
    "repair_drain": None,  # every kernel of a drain (phase 10)
}


def _device_ms(fn, name, iters=20):
    """Device time per call of ``name``'s own kernels, from a
    ``torch.profiler`` trace of ``iters`` calls (the event time of
    ``_event_ms`` includes the host's launch cost whenever the kernel is
    shorter than it); None when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()
    funcs = DEVICE_FUNCS[name]
    total = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and (funcs is None or any(f in e.name for f in funcs)))
    return total / 1e3 / iters if total else None


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


def _d1_bound(a, b, p, tensor_core):
    """(least ms, what sets it) for d1 on (a, p) against (b, p): r_a and
    r_b read once, the (a, b) output written once; the tensor-core route's
    bf16 products, 2·a·p·(24 + 48 + 64) per N tile of 21 landmarks, at the
    tensor cores' rate, or the f32 route's 12·a·b·p FMA work at the f32
    rate."""
    nbytes = 4 * (a * p + b * p + a * b)
    if not tensor_core:
        return _bound(nbytes, 12 * a * b * p)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * a * p * 136 * -(-b // 21) / BF16_TC_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _bound(bytes_moved, flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _ivf_rows(ivf, ivf_counts, life_counts, err):
    """Rows 4–6 of the kernel table at the IVF path's shapes.

    Row 4 is the whole ``kmeans()`` call of the IVF build (one launch of
    the Lloyd kernel), bounded by its nine assignments' products (the
    update's adds are U·n a step) or by its rows and centroids read once
    and its outputs written once. The other operation counts are the least
    work each function needs on these inputs: a dot product (2n) and a
    3-op epilogue (multiply, max, divide) per scored pair, and a squared
    norm (2n) once per distinct row."""
    import torch.nn.functional as F

    index, probe = ivf["index"], ivf["probe"]
    rows_all = ivf["all_rows"]
    u, n = rows_all.shape
    c, cap = index.lists.shape
    spec = rt.resolve_ivf(None, u)
    init = rt.init_centroids(torch.Generator().manual_seed(spec.seed),
                             rows_all, c)
    steps = spec.iters + 1  # assignments a k-means
    live = int(index.fill[probe.long()].sum())  # (query, live slot) pairs
    stored = int(index.fill.sum())  # live rows in the index
    b, nprobe = probe.shape
    q, cand = ivf["q"], ivf["cand"]
    qb, m = cand.shape[:2]
    args = (rows_all, probe, index.lists, index.rows, index.scale, index.fill)
    kw = dict(k=13, self_ids=ivf["self_ids"])
    calls = {
        "assign_clusters": (
            lambda: rt.kmeans(rows_all, c, "cosine", iters=spec.iters,
                              init=init),
            lambda: ref.kmeans_lloyd_ref(rows_all, init, spec.iters),
            None, 4 * (u * n + 2 * c * n + u), steps * 2 * u * c * n,
            f"kmeans() U={u} C={c} n={n} {spec.iters} steps, cosine, from "
            f"given centroids: the whole call"),
        "fused_probe_topk": (
            lambda: ivf_probe.fused_probe_topk(*args, **kw),
            lambda: ref.fused_probe_topk_ref(*args, **kw),
            None,
            4 * (b * n + b * nprobe + c * cap + c * cap * n + c + b)
            + 8 * b * 13, live * (2 * n + 3) + 2 * n * (stored + b),
            f"b={b} nprobe={nprobe} C={c} cap={cap} n={n} k=13 f32, "
            f"{live} live (query, slot) pairs"),
        "score_candidates": (
            lambda: score_candidates.score_candidates(q, cand),
            lambda: ref.score_candidates_ref(q, cand),
            lambda: F.cosine_similarity(q[:, None, :], cand, dim=-1),
            # every gathered candidate is a row of its own: its norm too
            4 * (qb * n + qb * m * n + qb * m),
            qb * m * (4 * n + 3) + 2 * n * qb,
            f"b={qb} m={m} n={n}"),
    }
    table = []
    for name, (kern, plain, lib, nbytes, flops, shape) in calls.items():
        bound_ms, bound_by = _bound(nbytes, flops)
        table.append(dict(
            name=name, route="cuda", **KERNELS[name], shape=shape,
            launches=ivf_counts[name], launches_lifecycle=life_counts[name],
            max_abs_err=err[name], max_err=err[name], ms=_event_ms(kern, 50),
            plain_ms=_event_ms(plain, 3), bound_ms=bound_ms,
            bound_us=bound_ms * 1e3, bound_by=bound_by,
            library_ms=None if lib is None else _event_ms(lib, 50),
            device_ms=_device_ms(kern, name)))
    table[0].update(_kmeans_times(ivf, init, spec))
    print("phase 6 fused probe: " + json.dumps(_probe_shapes(ivf)))
    return table


def _device_calls(fn, iters=20):
    """(device ms, device operations) per call of ``fn``: every kernel and
    copy it runs, from a ``torch.profiler`` trace of ``iters`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return (sum(spans) / 1e3 / iters if spans else None), len(spans) / iters


def _kmeans_times(ivf, init, spec):
    """Row 4's other numbers: the launches per ``kmeans()`` call, the
    Lloyd kernel's time for each measure at the IVF shape and, cosine, at
    the lifecycle's capacity bucket; the assignment alone (the earlier row
    4); ``build_index`` at the IVF shape."""
    rows_all, index = ivf["all_rows"], ivf["index"]
    c = index.n_clusters
    _, launches = _device_calls(
        lambda: rt.kmeans(rows_all, c, "cosine", iters=spec.iters, init=init))
    cap, nv = ivf["capacity"]
    c_life = rt.resolve_ivf(None, nv).n_clusters
    init_life = rt.init_centroids(torch.Generator().manual_seed(0), cap,
                                  c_life, nv)
    cells = {}
    for measure in sim.MEASURES:
        call = lambda m=measure: assign_clusters.kmeans_lloyd(
            rows_all, init, spec.iters, None, m)
        cells[measure] = dict(ms=_event_ms(call, 50),
                              device_ms=_device_calls(call)[0])
    call = lambda: assign_clusters.kmeans_lloyd(cap, init_life, spec.iters,
                                                nv, "cosine")
    cells[f"capacity U={cap.shape[0]} n_valid={nv} C={c_life}"] = dict(
        ms=_event_ms(call, 50), device_ms=_device_calls(call)[0])
    xr, cr = kernel_rows(rows_all, "cosine"), kernel_rows(init, "cosine")
    alone = lambda: assign_clusters.assign_clusters(xr, cr)
    build = lambda: rt.build_index(rows_all, spec, "cosine")
    build_dev, build_ops = _device_calls(build)
    out = dict(launches_per_call=launches, lloyd_kernel=cells,
               assign_alone=dict(ms=_event_ms(alone, 50),
                                 device_ms=_device_ms(alone,
                                                      "assign_clusters")),
               build_index=dict(ms=_event_ms(build, 20),
                                device_ms=build_dev,
                                device_ops_per_call=build_ops))
    print("phase 6 kmeans: " + json.dumps(out))
    return out


def _probe_shapes(ivf):
    """Row 5 at the lifecycle's batch sizes on phase 6's index (a 64-row
    fold-in and the 256-query recall probes at nprobe 19 and C), and the
    groups the graph build's call runs in: queries a block, union cells a
    group, and rows staged against rows probed."""
    index, probe, u_ids = ivf["index"], ivf["probe"], ivf["self_ids"]
    rows_all = ivf["all_rows"]
    c, cap = index.lists.shape
    nprobe = probe.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for bq, npr in ((64, nprobe), (256, nprobe), (256, c)):
        q = rows_all[:bq].contiguous()
        pr = rt.probe_cells(index, q, npr, "cosine")
        sid = u_ids[:bq]

        def call(q=q, pr=pr, sid=sid):
            return ivf_probe.fused_probe_topk(
                q, pr, index.lists, index.rows, index.scale, index.fill,
                k=13, self_ids=sid)

        out[f"b={bq} nprobe={npr}"] = dict(
            group=ivf_probe.plan_group(bq, sms, c), ms=_event_ms(call, 50),
            device_ms=_device_ms(call, "fused_probe_topk"))
    b = probe.shape[0]
    group = ivf_probe.plan_group(b, sms, c)
    order = ivf_probe.group_order(probe, group)
    live = index.fill.clamp(max=cap)
    pad = -b % group
    cells = torch.cat([probe[order], probe[order[-1:].expand(pad)]]).long()
    cells = torch.sort(cells.reshape(-1, group * nprobe), dim=1).values
    first = torch.ones_like(cells, dtype=torch.bool)
    first[:, 1:] = cells[:, 1:] != cells[:, :-1]
    union = first.sum(1)
    staged = int((live[cells] * first).sum())
    out[f"b={b} nprobe={nprobe} groups"] = dict(
        group=group, union_cells_mean=float(union.float().mean()),
        union_cells_max=int(union.max()), rows_staged=staged,
        rows_probed=int(live[probe.long()].sum()))
    return out


def phase_times(train, a, err, peak, life_counts):
    st = a["state"]
    u_fit, p = st.ratings.shape
    n, k = st.representation.shape[1], st.graph.k
    lm = st.ratings[st.landmark_idx]
    rows = kernel_rows(st.representation, "cosine")
    new = kernel_rows(a["folded"].representation[u_fit:], "cosine")
    cand = torch.cat([rows, new])
    b = new.shape[0]
    c = cand.shape[0]
    new_r = train[u_fit:]
    calls = {
        "masked_similarity": (
            lambda: ops.masked_similarity(st.ratings, lm),
            lambda: ref.masked_similarity_ref(st.ratings, lm),
            *_d1_bound(u_fit, n, p, True),
            f"A={u_fit} B={n} P={p} (fit), tensor-core route; every kernel "
            f"of the call (workspace memset, planes, moments, finalize)"),
        "masked_similarity_f32": (
            lambda: _d1_f32(st.ratings, lm),
            lambda: ref.masked_similarity_ref(st.ratings, lm),
            *_d1_bound(u_fit, n, p, False),
            f"A={u_fit} B={n} P={p} (fit), f32 route forced"),
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
        if name.startswith("masked_similarity"):
            bound_ms, bound_by = nbytes, flops
        else:
            bound_ms, bound_by = _bound(nbytes, flops)
        table.append(dict(
            name=name, route="cuda", **KERNELS[name], shape=shape,
            launches=launches[name], launches_lifecycle=life_counts[name],
            max_abs_err=err[name], max_err=err[name],
            ms=_event_ms(kern, 50), plain_ms=_event_ms(plain, 10),
            bound_ms=bound_ms, bound_us=bound_ms * 1e3, bound_by=bound_by,
            library_ms=None, device_ms=_device_ms(kern, name)))
    # rows 2 and 3 also beside their no-FMA floor: every product and sum
    # rounded on its own (bitwise the plain version), 2n instructions a
    # pair at one instruction a lane a clock
    for row, pairs in zip(table[2:4], (u_fit * u_fit, b * c)):
        row["no_fma_floor_ms"] = pairs * 2 * n / (F32_FLOPS / 2) * 1e3
    # d1 at the fold-in shape, both routes, beside rows 1 and 1′
    for row, fn in zip(table[:2], (ops.masked_similarity, _d1_f32)):
        call = lambda fn=fn: fn(new_r, lm)
        row.update(foldin_shape=f"A={b} B={n} P={p}",
                   foldin_ms=_event_ms(call, 50),
                   foldin_device_ms=_device_ms(call, row["name"]),
                   foldin_bound_ms=_d1_bound(b, n, p, row["name"] ==
                                             "masked_similarity")[0])
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


# ----------------------------------------------------------- IVF retrieval
def _bitwise(name, got, want):
    sync()
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: not bitwise equal to its plain "
                                 f"version")


def _quantized(index, payload):
    """The index's payload stored as ``payload`` (same lists and fills)."""
    rows = rt.dequantize_payload(index.rows, index.scale)
    stored, scale = rt.quantize_payload(rows.reshape(-1, rows.shape[-1]),
                                        payload)
    return rt.IVFIndex(index.centroids, index.lists,
                       stored.reshape(rows.shape[:2] + (-1,)).contiguous(),
                       index.fill, None if scale is None
                       else scale.reshape(index.lists.shape).contiguous())


def _edge_index(c, cap, n, seed):
    """Ragged fills with empty cells, ids a permutation."""
    rng = np.random.default_rng(seed)
    fill = rng.integers(1, cap + 1, c)
    fill[::4] = 0
    ids = rng.permutation(int(fill.sum()))
    lists = np.zeros((c, cap), np.int32)
    rows = np.zeros((c, cap, n), np.float32)
    o = 0
    for j in range(c):
        lists[j, :fill[j]] = ids[o:o + fill[j]]
        rows[j, :fill[j]] = rng.normal(size=(fill[j], n))
        o += fill[j]
    return rt.IVFIndex(torch.as_tensor(rng.normal(size=(c, n)).astype(
        np.float32), device=DEVICE), torch.as_tensor(lists, device=DEVICE),
        torch.as_tensor(rows, device=DEVICE),
        torch.as_tensor(fill.astype(np.int32), device=DEVICE))


def phase_ivf_kernels(a):
    """7a: kernels 4–6 against their plain versions, bitwise. Returns the
    main-path inputs (for the times) and the largest error per kernel."""
    t0 = time.perf_counter()
    rep = a["state"].representation  # (5976, 20) as the main path made it
    u = rep.shape[0]
    spec = rt.resolve_ivf(None, u)
    index = rt.build_index(rep, spec, "cosine")
    notes = []
    # kernel 4: the Lloyd assignment at the k-means shape, every measure,
    # plus a tiled (C > 256) and a wide (n = 64) case
    wide = torch.as_tensor(np.random.default_rng(21).normal(
        size=(3001, 64)).astype(np.float32), device=DEVICE)
    for measure in sim.MEASURES:
        for tag, x, cent in (("main", rep, index.centroids),
                             ("C=300", rep, rep[::19][:300]),
                             ("n=64", wide, wide[7::11][:77])):
            xr, cr = kernel_rows(x, measure), kernel_rows(cent, measure)
            _bitwise(f"assign_clusters {tag} {measure}",
                     [assign_clusters.assign_clusters(xr, cr, measure)],
                     [ref.assign_clusters_ref(xr, cr, measure)])
    notes.append("assign 9/9 bitwise")
    capacity = _capacity_rows(a["folded"].representation)
    notes.append(_check_lloyd(rep, capacity))
    # kernel 5: the graph-build search through the index (every row a
    # query, its own id excluded), all payloads and measures
    probe = rt.probe_cells(index, rep, spec.nprobe, "cosine")
    self_ids = torch.arange(u, dtype=torch.int32, device=DEVICE)
    n_ok = 0
    for payload in rt.PAYLOAD_DTYPES:
        idx = index if payload == "f32" else _quantized(index, payload)
        for measure in sim.MEASURES:
            args = (rep, probe, idx.lists, idx.rows, idx.scale, idx.fill)
            kw = dict(k=13, measure=measure, self_ids=self_ids)
            _bitwise(f"fused_probe_topk main {payload} {measure}",
                     ivf_probe.fused_probe_topk(*args, **kw),
                     ref.fused_probe_topk_ref(*args, **kw))
            n_ok += 1
    # edge cases: empty cells, k above the live candidates, masked probes,
    # C = 13 and n = 64, self ids that sit in the probed cells
    g = torch.Generator().manual_seed(22)
    for c, cap, n, k, nprobe in ((13, 40, 64, 32, 5), (6, 3, 7, 13, 4)):
        e = _edge_index(c, cap, n, seed=c)
        q = torch.randn((300, n), generator=g).to(DEVICE)
        pr = torch.stack([torch.randperm(c, generator=g)[:nprobe]
                          for _ in range(300)]).to(torch.int32).to(DEVICE)
        sid = e.lists[pr[:, 0].long(), 0].contiguous()
        ok = (torch.rand((300, nprobe), generator=g) > 0.3).to(
            torch.int32).to(DEVICE)
        for payload in rt.PAYLOAD_DTYPES:
            ee = e if payload == "f32" else _quantized(e, payload)
            for measure in sim.MEASURES:
                args = (q, pr, ee.lists, ee.rows, ee.scale, ee.fill)
                kw = dict(k=k, measure=measure, self_ids=sid, probe_ok=ok)
                got = ivf_probe.fused_probe_topk(*args, **kw)
                _bitwise(f"fused_probe_topk C={c} {payload} {measure}", got,
                         ref.fused_probe_topk_ref(*args, **kw))
                if nprobe * cap < k and not torch.isinf(got[0][:, -1]).all():
                    raise AssertionError("k above the live candidates: "
                                         "the tail must be empty")
                n_ok += 1
    # the lifecycle's batch sizes (one query a block, its rows split over
    # the block's warps) and the graph build's queries shuffled (other
    # groups, other unions): bitwise the plain version, and the shuffled
    # lists the unshuffled ones moved
    perm = torch.randperm(u, generator=g).to(DEVICE)
    full = (rep, probe, index.lists, index.rows, index.scale, index.fill)
    base = ivf_probe.fused_probe_topk(*full, k=13, self_ids=self_ids)
    for tag, sel in (("b=64", torch.arange(u - 64, u, device=DEVICE)),
                     ("permuted", perm)):
        for payload in rt.PAYLOAD_DTYPES:
            idx = index if payload == "f32" else _quantized(index, payload)
            for measure in sim.MEASURES:
                args = (rep[sel], probe[sel], idx.lists, idx.rows, idx.scale,
                        idx.fill)
                kw = dict(k=13, measure=measure, self_ids=self_ids[sel])
                got = ivf_probe.fused_probe_topk(*args, **kw)
                _bitwise(f"fused_probe_topk {tag} {payload} {measure}", got,
                         ref.fused_probe_topk_ref(*args, **kw))
                if payload == "f32" and measure == "cosine":
                    _bitwise(f"fused_probe_topk {tag}: moved lists", got,
                             [x[sel] for x in base])
                n_ok += 1
    notes.append(f"fused probe {n_ok}/{n_ok} bitwise (b=64 and permuted "
                 f"queries among them)")
    # kernel 6: one partial-probe query block of the scorer
    qb = 256
    m = spec.nprobe * index.capacity
    cand = index.rows[probe[:qb].long()].reshape(qb, m, -1).contiguous()
    q = rep[:qb].contiguous()
    for measure in sim.MEASURES:
        _bitwise(f"score_candidates {measure}",
                 [score_candidates.score_candidates(q, cand, measure)],
                 [ref.score_candidates_ref(q, cand, measure)])
    notes.append("scorer 3/3 bitwise")
    print(f"phase 7a IVF kernels: index C={index.n_clusters} "
          f"cap={index.capacity} nprobe={spec.nprobe} over U={u} n="
          f"{rep.shape[1]}; " + "; ".join(notes)
          + f" | {time.perf_counter() - t0:.1f}s")
    return dict(index=index, probe=probe, self_ids=self_ids, cand=cand, q=q,
                all_rows=rep, capacity=capacity)


LIFECYCLE_CAPACITY = 8192  # the lifecycle's bucket for 6040 rows


def _capacity_rows(rep):
    """``rep`` padded with zero rows to the lifecycle's capacity bucket, and
    its live-row count."""
    rows = torch.zeros((LIFECYCLE_CAPACITY, rep.shape[1]), device=DEVICE)
    rows[:rep.shape[0]] = rep
    return rows, rep.shape[0]


def _bits(t):
    """A tensor compared bit for bit (f32 as its int32 pattern)."""
    return t.contiguous().view(torch.int32) if t.is_floating_point() else t


def _check_lloyd(rep, capacity):
    """Kernel 4 as a whole k-means against its plain version, bitwise, and
    a second launch against the first: 0, 1 and 8 steps, every measure."""
    rng = np.random.default_rng(23)

    def rows(u, n):
        return torch.as_tensor(rng.normal(size=(u, n)).astype(np.float32),
                               device=DEVICE)

    def first(x, c, nv):
        return (x[torch.as_tensor(rng.permutation(nv)[:c], device=DEVICE)]
                if c <= nv else x[:1].repeat(c, 1)).contiguous()

    cap, nv = capacity
    x500 = rows(500, 20)
    cases = [("IVF", rep, 77, None), ("n=64", rows(1001, 64), 13, None),
             ("C>U", rows(37, 33), 300, None), ("tiny", rows(9, 1), 1, None),
             ("n=25", rows(300, 25), 7, None),
             ("capacity", cap, 78, nv),
             ("empty cell", x500, None, None)]
    n_ok = 0
    for tag, x, c, n_valid in cases:
        if c is None:  # a far centroid no row is nearest to (euclidean)
            init = torch.cat([x[:5], torch.full((1, 20), 50.0,
                                                device=DEVICE)])
        else:
            init = first(x, c, x.shape[0] if n_valid is None else n_valid)
        for measure in sim.MEASURES:
            for iters in (0, 1, 8):
                want = ref.kmeans_lloyd_ref(x, init, iters, n_valid, measure)
                for _ in range(2):  # a second launch: the same bits
                    got = assign_clusters.kmeans_lloyd(x, init, iters,
                                                       n_valid, measure)
                    sync()
                    if not all(torch.equal(_bits(g), _bits(w))
                               for g, w in zip(got, want)):
                        raise AssertionError(
                            f"kmeans_lloyd {tag} {measure} iters={iters}: "
                            f"not bitwise its plain version")
                    n_ok += 1
                if c is None and measure == "euclidean" and iters == 8 and (
                        (want[1] == 5).any()
                        or not torch.equal(want[0][5], init[5])):
                    raise AssertionError("empty cell: not kept")
    return f"Lloyd {n_ok}/{n_ok} bitwise (two launches each)"


def phase_ivf_path(train, a):
    """7b: the IVF path at the ML-1M shape through the user's entry points.
    Returns this path's launch counts."""
    t0 = time.perf_counter()
    spec = cfg.MODEL
    u_fit = train.shape[0] - FOLD_IN
    matrix = RatingMatrix(train[:u_fit], u_fit, train.shape[1])
    kernel_graph = a["state"].graph
    c = rt.resolve_ivf(None, u_fit).n_clusters
    sync()
    ops.reset_launches()
    built, real_build = [], rt.build_index

    def keep(*args, **kw):  # the index fit builds, kept
        built.append(real_build(*args, **kw))
        return built[-1]

    with mock.patch.object(rt, "build_index", keep):
        st = fit(matrix, spec, backend="ivf")
    rec_fit = rt.recall_at_k(st.graph.indices, kernel_graph.indices)
    index = rt.build_index(st.representation, rt.resolve_ivf(None, u_fit),
                           spec.d2)
    if len(built) != 1 or not all(
            torch.equal(_bits(x), _bits(y)) for x, y in zip(
                (built[0].centroids, built[0].lists, built[0].rows,
                 built[0].fill),
                (index.centroids, index.lists, index.rows, index.fill))):
        raise AssertionError("IVF path: the index fit built and the one "
                             "built again from the same seed differ")
    folded = fold_in(st, train[u_fit:], spec, backend="ivf",
                     ivf_index=index)
    rec_fold = rt.recall_at_k(folded.graph.indices[u_fit:],
                              a["folded"].graph.indices[u_fit:])
    rep = st.representation
    sids = torch.arange(u_fit, dtype=torch.int32, device=DEVICE)
    nprobe = rt.resolve_ivf(None, u_fit).nprobe
    kv, ki = rt.search(index, rep, 13, nprobe, spec.d2, self_ids=sids,
                       scorer="kernel")
    fv, fi = rt.search(index, rep, 13, nprobe, spec.d2, self_ids=sids,
                       scorer="fused")
    sync()
    counts = _counts()
    d1 = ms.route_results()
    if not all(counts[name] > 0 for name in IVF_KERNELS):
        raise AssertionError(f"an IVF kernel did not launch: {counts}")
    _check_d1_routes("IVF path", counts, d1)
    if not torch.equal(st.representation, a["state"].representation):
        raise AssertionError("IVF path: the fit's representation differs "
                             "from the main path's")
    # the two scorers score with one algebra in one order: equal values
    # slot by slot; ids differ only in the order of exact ties
    if not torch.equal(kv, fv):
        raise AssertionError("kernel and fused scorers: values differ")
    bad = list_mismatches(kv, ki, fv, fi, RTOL, ATOL)
    if bad.size:
        raise AssertionError(f"kernel vs fused scorer rows {bad[:8]}")
    # full probe: exact — the streaming backend under the tie rule, and the
    # fused kernel bitwise equal to its plain version there too
    full = rt.IVFSpec(nprobe=c)
    g_full = fit(matrix, spec, backend="ivf", ivf=full).graph
    g_str = fit(matrix, spec, backend="streaming").graph
    bad = list_mismatches(g_str.weights, g_str.indices, g_full.weights,
                          g_full.indices, RTOL, ATOL)
    if bad.size:
        raise AssertionError(f"full-probe ivf vs streaming rows {bad[:8]}")
    pr = rt.probe_cells(index, rep, c, spec.d2)
    args = (rep, pr, index.lists, index.rows, index.scale, index.fill)
    _bitwise("fused_probe_topk full probe",
             ivf_probe.fused_probe_topk(*args, k=13, self_ids=sids),
             ref.fused_probe_topk_ref(*args, k=13, self_ids=sids))
    swapped = int((g_full.indices != g_str.indices).any(dim=1).sum())
    print(f"phase 7b IVF path: fit(backend=ivf) C={c} nprobe={nprobe} "
          f"recall@13 vs kernel graph {rec_fit:.4f}; the index fit built "
          f"and build_index again from its seed bitwise equal; 64-user ivf "
          f"fold-in "
          f"recall@13 {rec_fold:.4f}; nprobe=C equals streaming under the "
          f"tie rule ({swapped} of {u_fit} rows with a tie swapped at the "
          f"cut); kernel vs fused "
          f"scorer equal; launches {counts}; d1 results {d1}, the "
          f"representation bitwise the main path's | "
          f"{time.perf_counter() - t0:.1f}s")
    return counts


def phase_lifecycle():
    """7c: the lifecycle serve CLI with IVF retrieval, smoke and full
    width. Every kernel must launch in each run. Returns the full-width
    run's launch counts."""
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    out = {}
    for tag, argv in (
            ("smoke", ["--smoke", "--users", "128", "--items", "64",
                       "--waves", "6", "--arrivals", "32", "--requests",
                       "2", "--batch", "32", "--min-bucket", "128"]),
            ("full", ["--users", "6040", "--items", "3952", "--arrivals",
                      "64", "--foldin", "64", "--waves", "8"])):
        shutil.rmtree(ckpt, ignore_errors=True)
        buf = io.StringIO()
        t0 = time.perf_counter()
        ops.reset_launches()
        with contextlib.redirect_stdout(buf):
            serve.main(["--workload", "cf", "--lifecycle", "--retrieval",
                        "ivf", "--early-exit", "--ckpt", str(ckpt)] + argv)
        sync()
        counts = _counts()
        d1 = ms.route_results()
        text = buf.getvalue()
        print(text, end="")
        idle = [name for name in CF_KERNELS if not counts[name] > 0]
        if idle:
            raise AssertionError(f"lifecycle {tag}: {idle} never launched "
                                 f"({counts})")
        _check_d1_routes(f"lifecycle {tag}", counts, d1)
        for want in ("cf lifecycle: done", "geometries per request-path"):
            if want not in text:
                raise AssertionError(f"lifecycle {tag}: missing {want!r}")
        if tag == "smoke":
            for want in ("refresh -> gen 1 launched in background",
                         "swapped in gen 1",
                         "swap oracle-exact vs from-scratch fit (gen 1): "
                         "True", "wave 5: gen 1"):
                if want not in text:
                    raise AssertionError(f"lifecycle smoke: missing {want!r}")
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("ivf retrieval: recall@k per wave"))
        mean = float(line.split("(mean ")[1].split(",")[0])
        if tag == "smoke" and mean < serve.IVF_RECALL_SLO:
            raise AssertionError(f"lifecycle smoke recall {mean}")
        out[tag] = counts
        print(f"phase 7c lifecycle CLI ({tag}): mean recall {mean:.3f}, "
              f"launches {counts}, d1 results {d1} | "
              f"{time.perf_counter() - t0:.1f}s")
    shutil.rmtree(ckpt, ignore_errors=True)
    return out["full"]


# ------------------------------------------------------------- LM slice
def _lm_inputs(p, n, s, d, dtype, seed):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return tuple(torch.randn((p, rows, d), generator=g, device=DEVICE).to(
        dtype) for rows in (n, s, s))


def _lm_model_shape():
    """(P, n, S, D) of phase 8b's summary launches: one problem per
    (batch, kv head), G·n_landmarks landmark queries each."""
    cfg = registry.get(LM_ARCH).model
    g = cfg.n_heads // cfg.n_kv_heads
    return (LM_BATCH * cfg.n_kv_heads, g * cfg.n_landmarks, LM_SEQ,
            cfg.head_dim)


def phase_lm_kernel():
    """8a: both routes of kernel 7 against the plain version, and the f32
    route's split pass bitwise against its plain version at the model
    shape. Returns the model-shape inputs and the largest error there, per
    dtype."""
    t0 = time.perf_counter()
    notes, model_in, model_err = [], {}, {}
    shapes = [(1, 64, 1024, 64), (1, 128, 2048, 128), (1, 32, 512, 256),
              (1, 16, 777, 32), (2, 130, 300, 128), (2, 200, 777, 256),
              (1, 100, 60, 256), _lm_model_shape()]
    ops.reset_launches()
    for i, (p, n, s_, d) in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = _lm_inputs(p, n, s_, d, dtype, seed=30 + i)
            got = ops.landmark_summary(q, k, v)
            want = ref.landmark_summary_ref(q, k, v, 1.0 / np.sqrt(d))
            sync()
            torch.testing.assert_close(got, want, rtol=LM_RTOL, atol=LM_ATOL)
            e = float((got - want).abs().max())
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            notes.append(f"P={p} n={n} S={s_} D={d} {tag} max|err| {e:.3g}")
            if i == len(shapes) - 1:
                model_err[dtype], model_in[dtype] = e, (q, k, v)
    routes = dict(lsum.landmark_summary.route_launches)
    if routes != {"tensor_core": len(shapes), "f32_split": len(shapes)}:
        raise AssertionError(f"8a: launches by route {routes}, not "
                             f"{len(shapes)} each")
    for t, terms in zip(model_in[torch.float32],
                        (lsum.QK_TERMS, lsum.QK_TERMS, lsum.V_TERMS)):
        got, want = lsum.bf16_terms(t, terms), ref.bf16_terms(t, terms)
        sync()
        if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
            raise AssertionError(f"8a: split pass of {tuple(t.shape)} into "
                                 f"{terms} terms differs from its plain "
                                 f"version")
    print(f"phase 8a landmark summary kernels (rtol={LM_RTOL}, "
          f"atol={LM_ATOL}; launches by route {routes}): " + "; ".join(notes)
          + f"; split pass at the model shape bitwise equal | "
          f"{time.perf_counter() - t0:.1f}s")
    return model_in, model_err


def _smollm(**over):
    cfg = dataclasses.replace(registry.get(LM_ARCH).model, **over)
    return lm.init_lm(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                      DEVICE)


def _forward_variants(model, batch, variants):
    """One landmark forward per (tag, summary function): the model's B̃V
    calls ops.landmark_summary, swapped for each function in turn. The
    counts are read from the timed run alone."""
    out = {}
    with torch.inference_mode():
        for tag, fn in variants:
            with mock.patch.object(ops, "landmark_summary", fn):
                lm.lm_forward(model, batch["tokens"][
                    :, :2 * model.cfg.n_landmarks])
                sync()  # warm
                ops.reset_launches()
                lsum.bf16_terms.launches = 0
                t1 = time.perf_counter()
                logits, _ = lm.lm_forward(model, batch["tokens"])
                sync()
                wall = time.perf_counter() - t1
                counts = ops.launch_counts()
                routes = dict(lsum.landmark_summary.route_launches)
                splits = lsum.bf16_terms.launches
                loss = float(lm.lm_loss(model, batch))
            out[tag] = dict(logits=logits, counts=counts, routes=routes,
                            splits=splits, wall=wall, loss=loss)
    return out


def _check_forward(out, cfg, route, batch_size, tag_dtype):
    """The kernel forward launched kernel 7 once per layer, all on `route`
    (with three split passes each on the f32_split route); the plain one
    launched nothing; logits finite, shaped, within
    LM_LOGIT_REL of the plain forward's; both CE near ln V. Returns the
    relative logit difference."""
    ka, pa = out["kernel"], out["plain"]
    want_routes = {r: cfg.n_layers if r == route else 0
                   for r in lsum.landmark_summary.route_launches}
    want_splits = 3 * cfg.n_layers if route == "f32_split" else 0
    if (ka["counts"]["landmark_summary"] != cfg.n_layers
            or ka["routes"] != want_routes or ka["splits"] != want_splits):
        raise AssertionError(f"{tag_dtype} landmark forward: kernel 7 "
                             f"launched {ka['counts']['landmark_summary']} "
                             f"times by route {ka['routes']} with "
                             f"{ka['splits']} split passes, not once per "
                             f"layer ({cfg.n_layers}) on {route}")
    if any(pa["counts"].values()) or pa["splits"]:
        raise AssertionError(f"plain forward launched kernels: "
                             f"{pa['counts']}")
    logits, want = ka["logits"], pa["logits"]
    if logits.shape != (batch_size, LM_SEQ, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{tag_dtype} landmark forward: logits not "
                             f"finite / shaped")
    rel = float((logits - want).abs().max() / want.abs().max())
    if rel > LM_LOGIT_REL:
        raise AssertionError(f"{tag_dtype} landmark forward: kernel vs plain "
                             f"logits differ by {rel:.4f} of max |logit|")
    for tag in ("kernel", "plain"):
        if not abs(out[tag]["loss"] - np.log(cfg.vocab)) < 2.0:
            raise AssertionError(f"{tag_dtype} {tag} CE {out[tag]['loss']} "
                                 f"is not near uniform "
                                 f"({np.log(cfg.vocab):.3f})")
    return rel


def phase_lm_forward():
    """8b: the landmark-attention forward at full SmolLM-360M width, with
    the kernel and with the plain B̃V, in bf16 (the tensor-core route), then
    in f32 at 2 layers (the f32_split route). Returns the launches of each
    route's kernel forward."""
    t0 = time.perf_counter()
    model = _smollm(attn_backend="landmark")
    cfg = model.cfg
    batch = {key: torch.as_tensor(val, device=DEVICE) for key, val in
             synthetic.lm_batch(0, 0, LM_BATCH, LM_SEQ, cfg.vocab).items()}

    def reversed_keys(q, k, v, scale):  # the same sum, in reverse key order
        return ref.landmark_summary_ref(q, k.flip(-2), v.flip(-2), scale)

    out = _forward_variants(model, batch, (
        ("kernel", ops.landmark_summary), ("plain", ref.landmark_summary_ref),
        ("reversed", reversed_keys)))
    rel = _check_forward(out, cfg, "tensor_core", LM_BATCH, "bf16")
    ka, pa = out["kernel"], out["plain"]
    want = pa["logits"]
    floor = float((out["reversed"]["logits"] - want).abs().max()
                  / want.abs().max())
    print(f"phase 8b landmark forward: {LM_ARCH} L={cfg.n_layers} "
          f"d={cfg.d_model} B={LM_BATCH} S={LM_SEQ} n={cfg.n_landmarks} "
          f"bf16, launches {ka['counts']} by route {ka['routes']} | CE "
          f"kernel {ka['loss']:.6f} plain {pa['loss']:.6f} (uniform "
          f"{np.log(cfg.vocab):.6f}); logits max|Δ|/max|logit| {rel:.5f} "
          f"(limit {LM_LOGIT_REL}; plain vs plain over reversed keys, the "
          f"bf16 floor: {floor:.5f}); forward wall kernel "
          f"{ka['wall'] * 1e3:.1f} ms, plain {pa['wall'] * 1e3:.1f} ms | "
          f"{time.perf_counter() - t0:.1f}s")
    launches = {"tensor_core": ka["routes"]["tensor_core"]}
    del out, want
    with torch.inference_mode():
        print("phase 8b profile (one landmark forward, kernel path): "
              + json.dumps(_profile(lambda: lm.lm_forward(
                  model, batch["tokens"]))))
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = _smollm(attn_backend="landmark", dtype=torch.float32, n_layers=2)
    cfg = model.cfg
    out = _forward_variants(model, batch, (
        ("kernel", ops.landmark_summary), ("plain", ref.landmark_summary_ref)))
    rel = _check_forward(out, cfg, "f32_split", LM_BATCH, "f32")
    ka, pa = out["kernel"], out["plain"]
    print(f"phase 8b f32 landmark forward: {LM_ARCH} full width, L cut to "
          f"{cfg.n_layers}, B={LM_BATCH} S={LM_SEQ}, f32, launches by route "
          f"{ka['routes']}, split passes {ka['splits']} | CE kernel {ka['loss']:.6f} plain "
          f"{pa['loss']:.6f}; logits max|Δ|/max|logit| {rel:.3g} (limit "
          f"{LM_LOGIT_REL}); forward wall kernel {ka['wall'] * 1e3:.1f} ms, "
          f"plain {pa['wall'] * 1e3:.1f} ms | "
          f"{time.perf_counter() - t0:.1f}s")
    launches["f32_split"] = ka["routes"]["f32_split"]
    del out, model
    torch.cuda.empty_cache()
    return launches


def phase_lm_serve():
    """8c: the LM serve CLI at full width, exact and landmark decode, and
    one exact decode step against the forward pass."""
    t0 = time.perf_counter()
    for extra in ([], ["--landmark"]):
        buf = io.StringIO()
        t1 = time.perf_counter()
        ops.reset_launches()
        with contextlib.redirect_stdout(buf):
            serve.main(["--workload", "lm", "--arch", LM_ARCH] + extra)
        sync()
        lines = buf.getvalue().strip().splitlines()
        print("\n".join(lines))
        if not (lines[-3].startswith("prefill 4x32: ")
                and lines[-2].startswith("decode 16 tokens (")
                and lines[-1].startswith("sample ids: [")):
            raise AssertionError(f"lm serve {extra}: unexpected output")
        print(f"phase 8c lm serve CLI {' '.join(extra) or '(exact KV)'}: "
              f"{lines[-3]} | {lines[-2]} | launches {ops.launch_counts()} "
              f"| {time.perf_counter() - t1:.1f}s")
    model = _smollm()
    toks = torch.as_tensor(synthetic.lm_batch(0, 0, 2, 16, model.cfg.vocab)[
        "tokens"], device=DEVICE)
    with torch.inference_mode():
        logits_pre, cache = lm.lm_prefill(model, toks[:, :8], max_seq=16)
        dec, cache = lm.lm_decode_step(model, cache, toks[:, 8:9])
        full, _ = lm.lm_forward(model, toks[:, :9])
        served = lm.make_cache(model.cfg, 4, 48, DEVICE)
        served["length"].fill_(32)
        tok = toks[:, :1].repeat(2, 1)
        print("phase 8c profile (one exact decode step, B=4, cache 33/48): "
              + json.dumps(_profile(lambda: lm.lm_decode_step(
                  model, dict(served, length=served["length"].clone()),
                  tok))))
    err = float((dec[:, 0] - full[:, -1]).abs().max())
    if logits_pre.shape != (2, 1, model.cfg.vocab) or int(
            cache["length"]) != 9 or not err < DECODE_ATOL:
        raise AssertionError(f"exact decode vs forward: max|Δ| {err}, "
                             f"length {int(cache['length'])}")
    print(f"phase 8c decode vs forward: {LM_ARCH} full width, one exact "
          f"decode step after an 8-token prefill, max|Δ logits| {err:.4f} "
          f"(limit {DECODE_ATOL}) | {time.perf_counter() - t0:.1f}s")
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------------ engine slice
# the kernels the engine CLI must launch at full width: d1 and the fold-in
# scan on the fold lane, the IVF sidecar's build (kernel 4), fused probe and
# candidate scorer
ENGINE_KERNELS = ("masked_similarity", "foldin_topk", "assign_clusters",
                  "fused_probe_topk", "score_candidates")
# the fold lane's device functions, as the profiler names them: d1 (planes,
# moments, finalize) and the fold-in top-k scan (prep, scan, merge)
FOLD_FUNCS = {"d1": ("planes_kernel", "moments_wgmma_kernel",
                     "masked_similarity_kernel"),
              "scan": ("topk_prep_kernel", "topk_scan_kernel",
                       "topk_merge_kernel")}
ENGINE_DIR = ROOT / "build" / "phase9"


def _thread_ids(lane):
    """The ids a profiler trace may give a lane's thread: its OS thread id
    (threads the profiler knows), or the low 32 bits of its pthread handle
    (CUPTI's default thread id), as unsigned, signed, or the magnitude of
    the signed value — the last is what torch 2.11's trace writes."""
    low = lane["ident"] & 0xFFFFFFFF
    signed = low - (1 << 32) if low >= 1 << 31 else low
    return {lane["native_id"], low, signed, abs(signed)}


def _lane_streams(path, lanes):
    """Read the ``torch.profiler`` Chrome trace of the engine's load window:
    the streams of the fold lane's d1 and scan kernels and of the kernels
    the read lane's thread launched (each kernel's launch, by correlation
    id, names its thread), the launching threads of the fold lane's
    kernels, kernel counts by (lane, stream), and the device's busy share of
    the window (the union of kernel, copy and memset intervals over the
    trace's span)."""
    doc = json.loads(Path(path).read_text())
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    launcher = {e["args"]["correlation"]: e["tid"] for e in evs
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    lane_of = {tid: name for name, lane in lanes.items()
               for tid in _thread_ids(lane)}
    fold = {lane: set() for lane in FOLD_FUNCS}
    lanes_by_kind = {kind: set() for kind in FOLD_FUNCS}
    fold_lanes, by_lane, spans = set(), {}, []
    for e in evs:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        spans.append((e["ts"], e["ts"] + e["dur"]))
        if e["cat"] != "kernel":
            continue
        stream = e["args"].get("stream")
        lane = lane_of.get(launcher.get(e["args"].get("correlation")),
                           "other")
        key = f"{lane}@{stream}"
        by_lane[key] = by_lane.get(key, 0) + 1
        for kind, funcs in FOLD_FUNCS.items():
            if any(f in e["name"] for f in funcs):
                fold[kind].add(stream)
                fold_lanes.add(lane)
                lanes_by_kind[kind].add(lane)
    t0 = min(e["ts"] for e in evs)
    t1 = max(e["ts"] + e["dur"] for e in evs)
    spans.sort()
    busy, end = 0.0, t0
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    read_streams = sorted({int(k.split("@")[1]) for k in by_lane
                           if k.startswith("engine-reads@")})
    write_streams = sorted({int(k.split("@")[1]) for k in by_lane
                            if k.startswith("engine-folds@")})
    return dict(fold_streams={k: sorted(v) for k, v in fold.items()},
                fold_lanes=sorted(fold_lanes), read_streams=read_streams,
                write_streams=write_streams,
                lanes_by_kind={k: sorted(v) for k, v in
                               lanes_by_kind.items()},
                kernels_by_lane_stream=by_lane, window_ms=(t1 - t0) / 1e3,
                busy_share=busy / (t1 - t0), idle_share=1 - busy / (t1 - t0),
                device_ops=len(spans),
                trace_mb=Path(path).stat().st_size / 2 ** 20)


def phase_engine():
    """9: the engine serve CLI, ``--smoke`` and at full width with the IVF
    sidecar, the obs exports and a torch.profiler capture of the load
    window. Each run: a bitwise-vs-solo audit with N > 0 re-runs and 0
    mismatches, no non-finite prediction, at least one fold, the read
    geometries within budget, every d1 call on the tensor-core route; at
    full width also every engine kernel launched, the exports through
    ``benchmarks/check_obs.py`` (read/fold overlap required), and the fold
    lane's d1 and scan kernels on a stream no read batch used. Returns the
    full run's launch counts."""
    from benchmarks import check_obs

    shutil.rmtree(ENGINE_DIR, ignore_errors=True)
    trace, metrics, prof = (ENGINE_DIR / "trace", ENGINE_DIR / "metrics.json",
                            ENGINE_DIR / "profile")
    out = {}
    for tag, argv in (
            ("smoke", ["--smoke"]),
            ("full", ["--users", "6040", "--items", "3952", "--batch", "128",
                      "--foldin", "64", "--duration", "8", "--retrieval",
                      "ivf", "--early-exit", "--trace-dir", str(trace),
                      "--metrics-json", str(metrics), "--torch-profile",
                      str(prof)])):
        buf = io.StringIO()
        t0 = time.perf_counter()
        ops.reset_launches()
        with contextlib.redirect_stdout(buf):
            res = serve.main(["--workload", "cf", "--engine"] + argv)
        sync()
        counts = _counts()
        d1 = ms.route_results()
        text = buf.getvalue()
        print(text, end="")
        want = (f"bitwise vs solo replay: {res['checked']} requests re-run, "
                f"0 mismatches | non-finite predictions: 0")
        if not (res["checked"] > 0 and res["mismatches"] == 0
                and want in text and res["nonfinite"] == 0):
            raise AssertionError(f"engine {tag}: audit {res['checked']} "
                                 f"re-run, {res['mismatches']} mismatches, "
                                 f"{res['nonfinite']} non-finite")
        if res["completed"]["fold"] < 1:
            raise AssertionError(f"engine {tag}: no fold batch completed")
        if max(res["geometries"].values()) > res["geometry_budget"]:
            raise AssertionError(f"engine {tag}: geometries "
                                 f"{res['geometries']} over budget "
                                 f"{res['geometry_budget']}")
        if not text.rstrip().endswith("cf engine: done"):
            raise AssertionError(f"engine {tag}: missing 'cf engine: done'")
        _check_d1_routes(f"engine {tag}", counts, d1)
        lanes = {}
        if tag == "full":
            idle = [k for k in ENGINE_KERNELS if not counts[k] > 0]
            if idle:
                raise AssertionError(f"engine full: {idle} never launched "
                                     f"({counts})")
            check_obs.check_trace(str(trace / "trace.json"),
                                  require_overlap=True)
            check_obs.check_metrics(str(metrics))
            lanes = _lane_streams(prof / "torch_trace.json", res["lane_ids"])
            fold = set().union(*lanes["fold_streams"].values())
            if not (all(lanes["fold_streams"].values())
                    and lanes["read_streams"]
                    and not fold & set(lanes["read_streams"])
                    and lanes["fold_lanes"] == ["engine-folds"]):
                raise AssertionError(f"engine full: the fold lane's kernels "
                                     f"do not run on a stream of their own: "
                                     f"{lanes}, lane ids {res['lane_ids']}")
        rl, fl = res["read_latency"], res["fold_latency"]
        print(f"phase 9 engine CLI ({tag}): sustained {res['qps']:.1f} QPS, "
              f"read p50/p95/p99 {rl.p50_ms:.3f}/{rl.p95_ms:.3f}/"
              f"{rl.p99_ms:.3f} ms ({rl.count} reads), shed_frac "
              f"{res['shed_frac']:.4f}, pad_frac {res['pad_frac']:.4f}, fold "
              f"p50/p99 {fl.p50_ms:.3f}/{fl.p99_ms:.3f} ms "
              f"({res['completed']['fold']} folds), audit {res['checked']} "
              f"re-run 0 mismatches, geometries {res['geometries']} (budget "
              f"{res['geometry_budget']}), launches {counts}, d1 results "
              f"{d1}" + (f", load window {json.dumps(lanes)}" if lanes else "")
              + f" | {time.perf_counter() - t0:.1f}s")
        out[tag] = counts
    return out["full"]


# ---------------------------------------------------------- mutation slice
MUTATION_DIR = ROOT / "build" / "phase10"
# the streaming rescan's euclidean epilogue |u|² − 2z + |v|² cancels between
# close rows, where the scan kernel sums (u − v)² in one fixed order: B3's
# bound of ROADMAP.md, as tests/test_torch_graph.py holds exact copies
EUCLID_ATOL = 2e-3
DEAD_ROWS = (100, 250, 999, 1500, 2000, 3001, 4500, 5975)
UPDATED_ROWS = (7, 300, 1234, 2500, 3999, 5000, 5900)  # + a landmark user


def _mutable(state, measure):
    """A MutableState over the main-path fit, its graph built under d2
    ``measure`` by the kernel backend (the fit's own graph for cosine)."""
    if measure != "cosine":
        state = dataclasses.replace(state, graph=build_neighbor_graph(
            state.representation, measure, cfg.MODEL.k_neighbors, "kernel"))
    return mutation.from_bucketed(buckets.from_state(state))


def _dirty_rows(mst):
    return torch.nonzero(mst.dirty & ~mst.tomb & (torch.arange(
        mst.capacity, device=mst.tomb.device) < mst.n_valid)).flatten()


def _rescan_plain(mst, measure):
    """The kernel rescan's pipeline — live rows gathered, top-(k+1), ids
    mapped back, self dropped — with the scan kernel's plain version on the
    same tensors: the graph rows the repair must write, bitwise."""
    rep, tomb = mst.bstate.state.representation, mst.tomb
    k = mst.bstate.state.graph.k
    sel = _dirty_rows(mst)
    live = torch.nonzero(~tomb[:mst.n_valid]).flatten()
    v, i = ref.foldin_topk_ref(kernel_rows(rep[sel], measure),
                               kernel_rows(rep[live], measure), k + 1, None,
                               live.numel(), measure)
    ids = torch.where(torch.isfinite(v), live[i.long()],
                      torch.zeros_like(live[i.long()])).to(torch.int32)
    return sel, finalize_topk(*filter_self_from_topk(v, ids, sel, k))


def _cites_dead(mst):
    """Citations of tombstoned rows in live rows' lists (inert slots
    excepted)."""
    g = mst.bstate.state.graph
    live = (torch.arange(mst.capacity, device=mst.tomb.device) < mst.n_valid
            ) & ~mst.tomb
    cited = mst.tomb[g.indices.long()] & ~((g.indices == 0) & (g.weights == 0))
    return int(cited[live].sum())


def _update_batch(state, p):
    ids = np.array((int(state.landmark_idx[0]),) + UPDATED_ROWS, np.int64)
    rows = _ratings(8, p, seed=31).cpu().numpy()
    return ids, rows


def _phase10_rescans(state):
    """10 (1): the kernel rescan bitwise its plain pipeline, and within the
    tie rule of the streaming rescan, for all three measures, after an
    8-user update (no tombstone) and after an 8-user removal; the drop-row
    scatters on the card with filler, out-of-range, negative and
    tombstoned ids. Returns notes."""
    p = state.ratings.shape[1]
    ids, rows = _update_batch(state, p)
    dead = np.array(DEAD_ROWS, np.int64)
    notes = []
    for measure in sim.MEASURES:
        spec = dataclasses.replace(cfg.MODEL, d2=measure)
        base = _mutable(state, measure)
        for tag, mst in (
                ("no tomb", mutation.update_ratings(base, ids, rows, 8, spec)),
                ("8 dead", mutation.remove_users(base, dead, 8))):
            sel, want = _rescan_plain(mst, measure)
            n0 = knn_topk.foldin_topk.launches
            kern, done = mutation.repair(mst, sel.numel(), spec,
                                         backend="kernel")
            sync()
            if knn_topk.foldin_topk.launches != n0 + 1 or done != sel.numel():
                raise AssertionError(f"rescan {measure} {tag}: launches "
                                     f"{knn_topk.foldin_topk.launches - n0}")
            stream, _ = mutation.repair(mst, sel.numel(), spec,
                                        backend="streaming")
            gk, gs = kern.bstate.state.graph, stream.bstate.state.graph
            if not (torch.equal(gk.indices[sel], want.indices)
                    and torch.equal(gk.weights[sel], want.weights)):
                raise AssertionError(f"rescan {measure} {tag}: not bitwise "
                                     f"its plain pipeline")
            atol = EUCLID_ATOL if measure == "euclidean" else ATOL
            bad = list_mismatches(gs.weights[sel], gs.indices[sel],
                                  gk.weights[sel], gk.indices[sel], RTOL, atol)
            if bad.size:
                raise AssertionError(f"rescan {measure} {tag}: rows "
                                     f"{sel[bad[:8]].tolist()} disagree with "
                                     f"the streaming rescan")
            diff = float((gk.weights[sel] - gs.weights[sel]).abs().max())
            notes.append(f"{measure} {tag}: {sel.numel()} rows bitwise, "
                         f"max |Δw| vs streaming {diff:.3g}")
    # the drop-row scatters: a noisy batch is bitwise its one effective row
    spec = cfg.MODEL
    base = mutation.remove_users(_mutable(state, "cosine"), dead, 8)
    noisy = np.array([DEAD_ROWS[0], 10 ** 6, -3, 7, DEAD_ROWS[1], 0, 0, 0])
    clean = np.array([7, -1, -1, -1, -1, -1, -1, -1])
    row = np.repeat(rows[:1], 8, axis=0)
    for tag, a_, b_ in (
            ("update", mutation.update_ratings(base, noisy, row, 5, spec),
             mutation.update_ratings(base, clean, row, 1, spec)),
            ("remove", mutation.remove_users(base, noisy, 5),
             mutation.remove_users(base, clean, 1))):
        got, want = _mutation_tensors(a_), _mutation_tensors(b_)
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{tag}: ineffective ids changed the state")
    sync()
    notes.append("drop-row scatters: filler, out-of-range, negative and "
                 "tombstoned ids bitwise no-ops (update, remove)")
    # the IVF-backed repair at partial probe: the tombstone-masked search on
    # the gathered scorer (kernel 6), bitwise the plain scorer's lists
    n_valid, k = base.n_valid, base.bstate.state.graph.k
    rep = base.bstate.state.representation
    ivf = rt.resolve_ivf(rt.IVFSpec(), n_valid)
    index = rt.build_index(rep, ivf, "cosine", n_valid=n_valid)
    sel = _dirty_rows(base)
    n0 = ops.score_candidates.launches
    got, _ = mutation.repair(base, sel.numel(), spec, ivf_index=index,
                             nprobe=ivf.nprobe)
    sync()
    launched = ops.score_candidates.launches - n0
    v, i = rt.search(index, rep[sel], k, ivf.nprobe, "cosine", self_ids=sel,
                     tomb=base.tomb, scorer="plain")
    v, si = canonical_topk(v.masked_fill(i >= n_valid, float("-inf")), k)
    want = finalize_topk(v, i.gather(1, si))
    g = got.bstate.state.graph
    if not (launched > 0 and torch.equal(g.indices[sel], want.indices)
            and torch.equal(g.weights[sel], want.weights)
            and not _cites_dead(got)):
        raise AssertionError(f"ivf repair: {launched} gathered-scorer "
                             f"launches, not bitwise the plain scorer's, or "
                             f"a dead row cited")
    notes.append(f"ivf repair (C={index.n_clusters}, nprobe={ivf.nprobe}): "
                 f"{sel.numel()} rows bitwise the plain scorer's, {launched} "
                 f"gathered-scorer launches")
    return notes


def _mutation_tensors(mst):
    st = mst.bstate.state
    return (st.representation, st.ratings, st.graph.indices, st.graph.weights,
            mst.landmarks, mst.tomb, mst.dirty)


def _oracle_check(tag, mst, ratings, landmarks, live, spec):
    """The state's live rows against the port's own from-scratch build
    (kernel backend) over ``ratings[live]`` with the frozen basis: ratings
    and representation bitwise, the graph under the tie rule. Returns the
    count of graph weights that differ in any bit."""
    st = mst.bstate.state
    u = ratings.shape[0]
    rep = ops.masked_similarity(ratings, landmarks, spec.d1)
    if not (torch.equal(st.ratings[:u], ratings)
            and torch.equal(st.representation[:u], rep)):
        raise AssertionError(f"oracle {tag}: ratings or representation not "
                             f"bitwise the from-scratch ones")
    g = build_neighbor_graph(rep[live], spec.d2, spec.k_neighbors, "kernel")
    inert = (g.indices == 0) & (g.weights == 0)
    oi = torch.where(inert, torch.zeros_like(g.indices),
                     live[g.indices.long()].to(torch.int32))
    gi, gw = st.graph.indices[live], st.graph.weights[live]
    bad = list_mismatches(g.weights, oi, gw, gi, RTOL, ATOL)
    if bad.size:
        raise AssertionError(f"oracle {tag}: rows {live[bad[:8]].tolist()} "
                             f"disagree beyond the tie rule")
    return int((gw.view(torch.int32) != g.weights.view(torch.int32)).sum())


def _phase10_oracle(state):
    """10 (2): update 8 users (one a landmark user) and remove 8 at full
    width, drain, compare with the port's own build over the mutated
    matrix; then compact and compare with a build over the survivors."""
    spec = cfg.MODEL
    u, p = state.ratings.shape
    mst0 = _mutable(state, "cosine")
    ids, rows = _update_batch(state, p)
    dead = torch.as_tensor(DEAD_ROWS, device=DEVICE)
    mst = mutation.update_ratings(mst0, ids, rows, 8, spec)
    mst = mutation.remove_users(mst, np.array(DEAD_ROWS), 8)
    cites = [_cites_dead(mst)]
    n0 = knn_topk.foldin_topk.launches
    dirty0 = mst.dirty_count()
    mst = mutation.drain_repairs(mst, spec)
    sync()
    rescans = knn_topk.foldin_topk.launches - n0
    cites.append(_cites_dead(mst))
    if any(cites) or mst.dirty_count() or not rescans:
        raise AssertionError(f"oracle: citations of dead rows {cites}, "
                             f"{mst.dirty_count()} dirty after the drain, "
                             f"{rescans} rescan launches")
    ratings = state.ratings.clone()
    ratings[torch.as_tensor(ids, device=DEVICE)] = torch.as_tensor(
        rows, device=DEVICE)
    ratings[dead] = 0.0
    live = torch.nonzero(~mst.tomb[:u]).flatten()
    bits = {"drained": _oracle_check("drained", mst, ratings, mst.landmarks,
                                     live, spec)}
    comp = mutation.compact_tombstones(mst)
    n = live.numel()
    if comp.n_valid != n or comp.tombstone_frac() != 0.0:
        raise AssertionError("compaction left tombstones")
    bits["compacted"] = _oracle_check(
        "compacted", comp, ratings[live], mst.landmarks,
        torch.arange(n, device=DEVICE), spec)
    # device time of one drain of 8 dirty rows
    eight = torch.zeros_like(mst0.dirty)
    eight[torch.as_tensor(UPDATED_ROWS + (0,), device=DEVICE)] = True
    mst8 = dataclasses.replace(mst0, dirty=eight)
    drain = lambda: mutation.drain_repairs(mst8, spec)
    times = dict(drain8_device_ms=_device_ms(drain, "repair_drain"),
                 drain8_event_ms=_event_ms(drain, 20))
    return dict(dirty_rows=dirty0, rescan_launches=rescans,
                live_rows=n, weights_differing_in_any_bit=bits, **times)


def phase_mutation(state, card):
    """10: the write path on the card — the rescan and scatter checks and
    the full-width oracle, then ``serve --engine --mutations`` ``--smoke``
    and at full width (obs exports and a torch.profiler capture under
    ``build/phase10/``): each run's audit N > 0 with 0 mismatches, no
    non-finite prediction, the pre-compaction bar, the repair rescans on
    the scan kernel, every write-lane kernel on the fold lane's stream;
    the smoke's compacting swap; at full width at least one update and
    one removal. Returns the full run's launch counts."""
    from benchmarks import check_obs

    t0 = time.perf_counter()
    notes = _phase10_rescans(state)
    print("phase 10 rescans: " + "; ".join(notes))
    oracle = _phase10_oracle(state)
    print(f"phase 10 oracle ({card}): {json.dumps(oracle)}")
    shutil.rmtree(MUTATION_DIR, ignore_errors=True)
    trace, metrics, prof = (MUTATION_DIR / "trace",
                            MUTATION_DIR / "metrics.json",
                            MUTATION_DIR / "profile")
    rescans = {"n": 0}
    real_repair = mutation.mutate.repair

    def counted_repair(*a, **kw):  # the rescans' launches, counted apart
        n0 = knn_topk.foldin_topk.launches
        out = real_repair(*a, **kw)
        rescans["n"] += knn_topk.foldin_topk.launches - n0
        return out

    out = {}
    for tag, argv in (
            ("smoke", ["--smoke"]),
            ("full", ["--users", "6040", "--items", "3952", "--batch", "128",
                      "--foldin", "64", "--duration", "8", "--trace-dir",
                      str(trace), "--metrics-json", str(metrics),
                      "--torch-profile", str(prof)])):
        buf = io.StringIO()
        t1 = time.perf_counter()
        rescans["n"] = 0
        ops.reset_launches()
        with contextlib.redirect_stdout(buf), \
                mock.patch.object(mutation.mutate, "repair", counted_repair):
            res = serve.main(["--workload", "cf", "--engine", "--mutations"]
                             + argv)
        sync()
        counts = _counts()
        d1 = ms.route_results()
        text = buf.getvalue()
        print(text, end="")
        mut = res["mutations"]
        want = (f"bitwise vs solo replay: {res['checked']} requests re-run, "
                f"0 mismatches | non-finite predictions: 0")
        if not (res["checked"] > 0 and res["mismatches"] == 0
                and want in text and res["nonfinite"] == 0):
            raise AssertionError(f"mutations {tag}: audit {res['checked']} "
                                 f"re-run, {res['mismatches']} mismatches, "
                                 f"{res['nonfinite']} non-finite")
        if not text.rstrip().endswith("cf engine: done"):
            raise AssertionError(f"mutations {tag}: no 'cf engine: done'")
        if mut["cites_dead"] or mut["dirty_published"]:
            raise AssertionError(f"mutations {tag}: pre-compaction bar {mut}")
        if not (res["completed"]["update"] >= 1
                and res["completed"]["remove"] >= 1):
            raise AssertionError(f"mutations {tag}: completed "
                                 f"{res['completed']}")
        if not rescans["n"] > 0:
            raise AssertionError(f"mutations {tag}: no repair rescan "
                                 f"launched the scan kernel")
        if tag == "smoke" and not (
                "refresh swap: " in text and "tombstone_frac=0.000"
                in text.split("refresh swap: ")[1].splitlines()[0]):
            raise AssertionError("mutations smoke: no compacting swap")
        _check_d1_routes(f"mutations {tag}", counts, d1)
        lanes = {}
        if tag == "full":
            check_obs.check_trace(str(trace / "trace.json"),
                                  require_overlap=True)
            check_obs.check_metrics(str(metrics))
            lanes = _lane_streams(prof / "torch_trace.json", res["lane_ids"])
            reads = set(lanes["read_streams"])
            if not (lanes["write_streams"] and reads
                    and not reads & set(lanes["write_streams"])
                    and lanes["lanes_by_kind"]["scan"] == ["engine-folds"]
                    and not reads & set(lanes["fold_streams"]["d1"])):
                raise AssertionError(f"mutations full: a write-lane kernel "
                                     f"ran on the read lane's stream: "
                                     f"{lanes}, lane ids {res['lane_ids']}")
        rl = res["read_latency"]
        wl = {k: f"{v.p50_ms:.3f}/{v.p99_ms:.3f} ms ({v.count})"
              for k, v in mut["write_latency"].items()}
        print(f"phase 10 mutations CLI ({tag}, {card}): sustained "
              f"{res['qps']:.1f} QPS, read p50/p95/p99 {rl.p50_ms:.3f}/"
              f"{rl.p95_ms:.3f}/{rl.p99_ms:.3f} ms ({rl.count} reads), "
              f"write p50/p99 {wl}, mutated_rows {res['mutated_rows']}, "
              f"repaired_rows {res['repaired_rows']}, tombstone_frac "
              f"{res['tombstone_frac']:.4f}, swap "
              f"{ {k: mut.get(k) for k in ('compacted', 'swap_gen')} }, "
              f"rescan launches {rescans['n']}, audit {res['checked']} re-run "
              f"0 mismatches, launches {counts}, d1 results {d1}"
              + (f", load window {json.dumps(lanes)}" if lanes else "")
              + f" | {time.perf_counter() - t1:.1f}s")
        out[tag] = counts
    print(f"phase 10: {time.perf_counter() - t0:.1f}s")
    return out["full"]


# ------------------------------------------------------ paper comparison
PAPER_DIR = ROOT / "build" / "phase11"
# card against CPU from the same initial parameters and permutation, one
# epoch at the ML-1M fold-0 shape (109 steps): f32 sums in other orders and
# the card's accumulation order in the gathers' backward, compounded over
# the steps; parameters are of scale 0.1-1
MF_PARAM_ATOL = 1e-4  # the largest |difference| of any parameter
MF_MAE_ATOL = 1e-5  # |MAE(card) - MAE(CPU)| on the fold's test pairs
# one Gibbs sweep, card against CPU on the same draws: batched Cholesky
# solves and inverses of other libraries (cuSOLVER / LAPACK), factors of
# scale ~0.1
BPMF_ATOL = 1e-4
# the reference's own bars (tests/test_system.py:56-57): landmark MAE,
# kNN and model-based MAE, and claim C3 (landmark within 0.02 of cosine kNN)
LANDMARK_MAE_BAR, BASELINE_MAE_BAR, C3_SLACK = 1.1, 1.2, 0.02
# compact reads against the widened graph's reads: the reference's bf16
# tolerance (tests/test_lifecycle.py)
COMPACT_TOL = 2e-2
# the kernels each part of phase 11 must launch: every landmark row of
# Table 15 runs d1 and the d2 scan; the lifecycle under --compact-serving
# --retrieval ivf folds in (the fold-in scan) and builds and probes its index
PAPER_KERNELS = {"table 15": ("masked_similarity", "topk_sim"),
                 "serve": ("masked_similarity", "foldin_topk",
                           "assign_clusters", "fused_probe_topk")}


def _paper_mf(d, tr, te):
    """11a: each MF configuration, one epoch, on the card and on the CPU
    from the same initial parameters and permutation."""
    out = {}
    users, items, ratings = d.users[tr], d.items[tr], d.ratings[tr]
    perms = [torch.randperm(len(tr), generator=torch.Generator().manual_seed(
        1))]
    for name, cfgf in paper.MF_CONFIGS:
        cfg_mf = cfgf(d.n_users, d.n_items, epochs=1)
        init = mf._init(cfg_mf, float(np.mean(ratings, dtype=np.float64)),
                        "cpu")
        res, maes = {}, {}
        for dev in (DEVICE, "cpu"):
            t0 = time.perf_counter()
            params, aux = mf.fit_mf(users, items, ratings, cfg_mf, device=dev,
                                    init=init, perms=perms)
            preds = mf.predict_mf(params, cfg_mf, d.users[te], d.items[te],
                                  aux)
            if dev == DEVICE:
                sync()
            res[dev] = (params, time.perf_counter() - t0)
            maes[dev] = data.mae(np.clip(preds.cpu().numpy(), 1, 5),
                                 d.ratings[te])
        diff = max(float((c.cpu() - p).abs().max()) for c, p in
                   zip(res[DEVICE][0], res["cpu"][0]))
        # the gathers' backward on the card: the same bits run to run?
        again, _ = mf.fit_mf(users, items, ratings, cfg_mf, device=DEVICE,
                             init=init, perms=perms)
        rerun = all(torch.equal(x, y) for x, y in zip(again, res[DEVICE][0]))
        dmae = abs(maes[DEVICE] - maes["cpu"])
        moved = float((res[DEVICE][0].mu.cpu() - init.mu).abs())
        if not (diff <= MF_PARAM_ATOL and dmae <= MF_MAE_ATOL
                and all(torch.isfinite(t).all() for t in res[DEVICE][0])):
            raise AssertionError(f"11a {name}: card vs CPU parameters differ "
                                 f"by {diff} (bound {MF_PARAM_ATOL}), MAE by "
                                 f"{dmae} (bound {MF_MAE_ATOL})")
        if (moved > 0) != cfg_mf.use_bias:
            raise AssertionError(f"11a {name}: mu moved by {moved}")
        out[name] = dict(max_param_diff=diff, mae_card=maes[DEVICE],
                         mae_diff=dmae, mu_moved=moved,
                         card_rerun_bitwise=rerun,
                         card_s=res[DEVICE][1], cpu_s=res["cpu"][1])
    return out


def _paper_bpmf(d, tr):
    """11b: one Gibbs sweep at the ML-1M shape, card against CPU, on the
    same draws (one seeded CPU generator each)."""
    bcfg = bpmf.BPMFConfig(d.n_users, d.n_items)
    out = {}
    for dev in (DEVICE, "cpu"):
        draws = bpmf.TorchDraws(bcfg.seed, dev)
        rc, m, _ = bpmf.centered_block(d.users[tr], d.items[tr],
                                       d.ratings[tr], bcfg, dev)
        p0 = draws.normal((bcfg.n_users, bcfg.dim)) * 0.1
        q0 = draws.normal((bcfg.n_items, bcfg.dim)) * 0.1
        t0 = time.perf_counter()
        out[dev] = bpmf.gibbs_step(draws, p0, q0, rc, m, bcfg)
        if dev == DEVICE:
            sync()
        out[dev + "_s"] = time.perf_counter() - t0
    diff = max(float((c.cpu() - p).abs().max())
               for c, p in zip(out[DEVICE], out["cpu"]))
    if not diff <= BPMF_ATOL or not all(torch.isfinite(t).all()
                                        for t in out[DEVICE]):
        raise AssertionError(f"11b: a Gibbs sweep, card vs CPU, differs by "
                             f"{diff} (bound {BPMF_ATOL})")
    return dict(max_factor_diff=diff, card_s=out[DEVICE + "_s"],
                cpu_s=out["cpu_s"])


def _paper_table(d):
    """11c: Table 15 on the card, every row, held to the reference's
    bars."""
    ops.reset_launches()
    rows = paper.tab15_comparative("movielens1m", data=d, device=DEVICE)
    sync()
    counts = _counts()
    by = {r["algo"]: r for r in rows}
    lm_mae = by["Landmarks kNN"]["mae"]
    bad = [r["algo"] for r in rows[1:] if not r["mae"] < BASELINE_MAE_BAR]
    if not (lm_mae < LANDMARK_MAE_BAR and not bad
            and lm_mae <= by["cosine kNN"]["mae"] + C3_SLACK
            and len(rows) == 9):
        raise AssertionError(f"11c: Table 15 misses the reference's bars: "
                             f"landmark {lm_mae}, over {BASELINE_MAE_BAR}: "
                             f"{bad}, cosine kNN {by['cosine kNN']['mae']}")
    return rows, counts


def _paper_profiles(d, tr):
    """Where the model-based rows' time goes on the card: the profiler
    over one RSVD epoch (109 autograd steps) and one BPMF sweep."""
    cfg_mf = mf.rsvd_config(d.n_users, d.n_items, epochs=1)
    bcfg = bpmf.BPMFConfig(d.n_users, d.n_items)
    rc, m, _ = bpmf.centered_block(d.users[tr], d.items[tr], d.ratings[tr],
                                   bcfg, DEVICE)
    draws = bpmf.TorchDraws(0, DEVICE)
    p0 = draws.normal((bcfg.n_users, bcfg.dim)) * 0.1
    q0 = draws.normal((bcfg.n_items, bcfg.dim)) * 0.1
    return {
        "rsvd_epoch": _profile(lambda: mf.fit_mf(
            d.users[tr], d.items[tr], d.ratings[tr], cfg_mf, device=DEVICE)),
        "bpmf_sweep": _profile(lambda: bpmf.gibbs_step(draws, p0, q0, rc, m,
                                                       bcfg))}


def _paper_compact(state, pairs):
    """11d, on the main-path fit: the compact serving graph's reads against
    the widened graph's, at the reference's bf16 tolerance."""
    bst = buckets.from_state(state)
    cst = buckets.compact_state(bst)
    g, gc = bst.state.graph, cst.state.graph
    if not (gc.indices.dtype == torch.uint16 and gc.indices.is_cuda
            and buckets.compact_state(cst) is cst):
        raise AssertionError(f"11d: compact graph {gc.indices.dtype}")
    users, items = pairs[0], pairs[1]
    ids, _ = knn._gathered(gc, users, torch.float32)
    full_ids, _ = knn._gathered(g, users, torch.float32)
    got = buckets.predict_pairs(cst, users, items)
    want = buckets.predict_pairs(bst, users, items)
    torch.testing.assert_close(got, want, rtol=COMPACT_TOL, atol=COMPACT_TOL)
    top_c, _ = buckets.recommend_topn(cst, users[:TOPN_USERS])
    if not torch.equal(ids, full_ids) or (top_c < 0).any():
        raise AssertionError("11d: the uint16 gather or top-N differs")
    return dict(pairs=int(users.shape[0]),
                max_read_diff=float((got - want).abs().max()),
                resident_kb=(gc.indices.nbytes + gc.weights.nbytes) / 1024,
                full_kb=(g.indices.nbytes + g.weights.nbytes) / 1024)


def _paper_serve():
    """11d: ``serve --compact`` at ML-1M width, and the lifecycle smoke with
    ``--compact-serving --retrieval ivf``."""
    shutil.rmtree(PAPER_DIR, ignore_errors=True)
    out = {}
    ops.reset_launches()
    for tag, argv, want in (
            ("compact", ["--users", "6040", "--items", "3952", "--waves", "2",
                         "--foldin", "64", "--compact"], "cf serve: done"),
            ("compact-serving", ["--lifecycle", "--retrieval", "ivf",
                                 "--smoke", "--compact-serving"],
             "cf lifecycle: done")):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            serve.main(["--workload", "cf", "--ckpt", str(PAPER_DIR / tag)]
                       + argv)
        sync()
        text = buf.getvalue()
        print(text, end="")
        if not text.rstrip().endswith(want):
            raise AssertionError(f"11d {tag}: no {want!r}")
        if tag == "compact":
            line = next(ln for ln in text.splitlines()
                        if ln.startswith("loaded "))
            if "stored compact" not in line:
                raise AssertionError(f"11d: artifact not stored compact: "
                                     f"{line}")
        else:
            line = next((ln for ln in text.splitlines()
                         if "serving graph compacted" in ln), None)
            if line is None or "swap oracle-exact vs from-scratch fit (gen " \
                    "1): True" not in text:
                raise AssertionError("11d: no compacted wave or no "
                                     "oracle-exact swap")
        out[tag] = dict(line=line, s=time.perf_counter() - t0)
    sync()
    return out, _counts()


def phase_paper(d, tr, te, a, card):
    """11: the paper's comparison on the card — (a) the four MF baselines,
    one epoch, card against CPU; (b) one BPMF Gibbs sweep, card against
    CPU; (c) Table 15 on the card with the reference's bars; (d) compact
    serving: reads of the compact main-path graph, ``serve --compact`` and
    ``serve --lifecycle --retrieval ivf --smoke --compact-serving``.
    Returns the launches of (c) and (d) together."""
    t0 = time.perf_counter()
    t = time.perf_counter()
    mf_out = _paper_mf(d, tr, te)
    print(f"phase 11a MF card vs CPU, one epoch (bounds: parameters "
          f"{MF_PARAM_ATOL}, MAE {MF_MAE_ATOL}): {json.dumps(mf_out)} | "
          f"{time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    print(f"phase 11b BPMF one Gibbs sweep card vs CPU (bound {BPMF_ATOL}): "
          f"{json.dumps(_paper_bpmf(d, tr))} | {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    rows, table_counts = _paper_table(d)
    for r in rows:
        print(f"phase 11c Table 15 ({card}): {r['algo']:14s} MAE "
              f"{r['mae']:.4f}  {r['time_s']:.4f}s  {r['rel']:.1f}x")
    d1 = ms.route_results()
    _check_d1_routes("phase 11 table 15", table_counts, d1)
    print(f"phase 11c Table 15 rows: {json.dumps(rows)}, launches "
          f"{table_counts}, d1 results {d1} | {time.perf_counter() - t:.1f}s")
    print("phase 11c profile (one RSVD epoch; one BPMF sweep): " + json.dumps(
        _paper_profiles(d, tr)))
    t = time.perf_counter()
    reads = _paper_compact(a["state"], a["fit_pairs"])
    serve_out, serve_counts = _paper_serve()
    d1 = ms.route_results()
    _check_d1_routes("phase 11 serve", serve_counts, d1)
    print(f"phase 11d compact serving: reads {json.dumps(reads)} (tolerance "
          f"{COMPACT_TOL}); {json.dumps(serve_out)}; launches {serve_counts}, "
          f"d1 results {d1} | {time.perf_counter() - t:.1f}s")
    for part, counts in (("table 15", table_counts), ("serve", serve_counts)):
        idle = [k for k in PAPER_KERNELS[part] if not counts[k] > 0]
        if idle:
            raise AssertionError(f"phase 11 {part}: {idle} never launched "
                                 f"({counts})")
    print(f"phase 11: {time.perf_counter() - t0:.1f}s")
    return {k: table_counts[k] + serve_counts[k] for k in table_counts}


def _lm_bound(p, n, s_, d, dtype):
    """Least time for p problems of softmax(q̃Kᵀ·scale)V with f32 results,
    on the route of the inputs' dtype: the bytes moved, and the bf16
    products on the tensor cores (exact products, f32 sums) beside one exp
    per score on the special-function units, which run beside them.

    bf16 inputs: q, k, v read once, the f32 output written once; q̃Kᵀ, and
    PV with the f32 probabilities split into two bf16 terms (16 bits of
    mantissa, well inside the 1e-4 bound): 3 products of 2·n·S·D.
    f32 inputs: q, k, v (f32) read once, their bf16 planes (three terms of
    q and k, two of v) written once and read once, the output written
    once; six products for q̃Kᵀ and three for PV: 9 of 2·n·S·D."""
    q_el, kv_el = p * n * d, p * s_ * d
    if dtype == torch.bfloat16:
        moved, products = 2 * (q_el + 2 * kv_el), 3
    else:
        planes = 3 * q_el + 3 * kv_el + 2 * kv_el
        moved, products = 4 * (q_el + 2 * kv_el) + 2 * 2 * planes, 9
    t_bytes = (moved + 4 * q_el) / HBM_BYTES_PER_S * 1e3
    t_tc = p * products * (2 * n * s_ * d) / BF16_TC_FLOPS * 1e3
    t_exp = p * n * s_ / SFU_PER_S * 1e3
    t_ops = max(t_tc, t_exp)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _lm_bound_f32_cores(p, n, s_, d):
    """A yardstick for the f32 route: the same function on f32 inputs with
    every operation at the f32 rate outside the tensor cores — q, k, v read
    once, the output written once, q̃Kᵀ and PV (4·n·S·D) and the exps
    (n·S)."""
    return _bound(4 * p * (n * d + 2 * s_ * d) + 4 * p * n * d,
                  p * (4 * n * s_ * d + n * s_))


def _lm_rows(model_in, err, launches, life_counts):
    """Row 7 of the kernel table at phase 8b's shape, one entry per route:
    bf16 inputs on the tensor-core route (launches on the bf16 landmark
    forward), f32 inputs on the f32_split route (launches on the f32 one).
    bf16 and f32 SDPA on the same inputs are the yardsticks, and for the
    f32 route the f32-rate bound as well; the port never calls them."""
    import torch.nn.functional as F

    rows = []
    for dtype, name, route in (
            (torch.bfloat16, "landmark_summary", "tensor_core"),
            (torch.float32, "landmark_summary_f32", "f32_split")):
        q, k, v = model_in[dtype]
        p, n, d = q.shape
        s_ = k.shape[1]
        bound_ms, bound_by = _lm_bound(p, n, s_, d, dtype)
        extra = {} if dtype == torch.bfloat16 else dict(
            bound_f32_cores_ms=_lm_bound_f32_cores(p, n, s_, d)[0],
            split_device_ms=_device_ms(
                lambda: ops.landmark_summary(q, k, v), "split_terms"))
        # SDPA takes (batch, heads, L, D): the problems as (B, Hkv) so its
        # fused backends can run
        q4, k4, v4 = (t.reshape(LM_BATCH, p // LM_BATCH, *t.shape[1:])
                      for t in (q, k, v))
        bf = [t.bfloat16() for t in (q4, k4, v4)]
        f32 = [t.float() for t in (q4, k4, v4)]
        sdpa_bf16 = _event_ms(lambda: F.scaled_dot_product_attention(*bf), 20)
        sdpa_f32 = _event_ms(lambda: F.scaled_dot_product_attention(*f32), 20)
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        print(f"phase 6 sdpa ({tag} row): F.scaled_dot_product_attention on "
              f"(B, Hkv, n, D) = ({LM_BATCH}, {p // LM_BATCH}, {n}, {d}) "
              f"against S={s_}: bf16 inputs {sdpa_bf16:.4f} ms, backend "
              f"{_sdpa_backend(*bf)}; f32 inputs {sdpa_f32:.4f} ms, backend "
              f"{_sdpa_backend(*f32)}")
        rows.append(dict(
            name=name, route="cuda", kernel_route=route, **KERNELS[name],
            shape=f"P={p} (B={LM_BATCH} x Hkv) n={n} (G x n_landmarks) "
            f"S={s_} D={d} {tag}", launches=launches[route],
            launches_lifecycle=life_counts["landmark_summary"],
            max_abs_err=err[dtype], max_err=err[dtype],
            ms=_event_ms(lambda: ops.landmark_summary(q, k, v), 20),
            plain_ms=_event_ms(lambda: ref.landmark_summary_ref(
                q, k, v, 1.0 / np.sqrt(d)), 5),
            bound_ms=bound_ms, bound_us=bound_ms * 1e3, bound_by=bound_by,
            library_ms=sdpa_bf16 if dtype == torch.bfloat16 else sdpa_f32,
            library_bf16_ms=sdpa_bf16, library_f32_ms=sdpa_f32,
            device_ms=_device_ms(lambda: ops.landmark_summary(q, k, v),
                                 name), **extra))
    return rows


def _sdpa_backend(q, k, v):
    """The device kernels one SDPA call ran, by name (which backend)."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v)
        sync()
    names = {e.name.split("(")[0].removeprefix("void ")[:80]
             for e in prof.events() if e.device_type == DeviceType.CUDA}
    keys = ("flash", "fmha", "mem_eff", "attention", "cudnn", "gemm")
    named = sorted(x for x in names if any(k in x.lower() for k in keys))
    return named or sorted(names) or "not measured (no device events)"


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
    ivf = phase_ivf_kernels(a)
    err.update({name: 0.0 for name in IVF_KERNELS})  # bitwise, checked
    ivf_counts = phase_ivf_path(train, a)
    life_counts = phase_lifecycle()
    model_in, lm_err = phase_lm_kernel()
    lm_launches = phase_lm_forward()
    phase_lm_serve()
    engine_counts = phase_engine()
    table = (phase_times(train, a, err, peak, life_counts)
             + _ivf_rows(ivf, ivf_counts, life_counts, err)
             + _lm_rows(model_in, lm_err, lm_launches, life_counts))
    # after the kernel times: run after phase 10, phase 6's profiler
    # sessions saw only part of the device events
    mutation_counts = phase_mutation(a["state"], card)
    paper_counts = phase_paper(d, train_idx, test_idx, a, card)
    for row in table:  # the engine runs' launches, every row
        row["launches_engine"] = engine_counts.get(row["name"], 0)
        row["launches_mutations"] = mutation_counts.get(row["name"], 0)
        row["launches_paper"] = paper_counts.get(row["name"], 0)
    print(f"card: {card}")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
