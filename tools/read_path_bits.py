#!/usr/bin/env python3
"""Check on the card that a read's bits do not depend on the batch it runs
in: the request engine re-runs a sample of reads alone and requires them
bitwise equal to their micro-batched results.

A bucketed state at MovieLens-1M width (synthetic ratings, seed 0; the
paper's spec: 20 popularity landmarks, cosine, k = 13; capacity 8192 for
6040 users) serves the same query rows alone (padded to the engine's shape
for them) and inside batches of every padded shape of
``EngineConfig(max_batch=128, min_shape=8)``, at the first, a middle and
the last offset, with other random rows around them. Two forms of Eq. (1)'s
sums over the k neighbors run on the same gathered inputs:

- ``fixed``: the port's read path (``core.knn``: pairwise halving over k,
  elementwise adds only);
- ``library``: the forms it replaced — ``torch.einsum("bk,bkp->bp")`` for
  top-N (a batched product) and ``torch.sum(dim=1)`` for pairs.

Prints one JSON line: the card and, per form and read kind, the
(m, shape, offset) cases whose rows differ in any bit from the solo run.

    python3 tools/read_path_bits.py [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import RatingMatrix, fit, knn  # noqa: E402
from repro_torch.core.types import LandmarkSpec  # noqa: E402
from repro_torch.lifecycle import buckets  # noqa: E402
from repro_torch.serving import EngineConfig  # noqa: E402

SIZES = (1, 5, 16, 37, 128)  # rows of the query request


def _library_reads(bst, users, items):
    """Pair predictions and top-N scores with the library reductions."""
    st = bst.state
    mask, means, centered = knn._center(st.ratings)
    idx, w = knn._gathered(st.graph, users, centered.dtype)
    w = knn._mask_padded_rows(idx, w, bst.n_valid)
    r = st.ratings[idx, items[:, None]]
    m = mask[idx, items[:, None]]
    num = torch.sum(w * (r - means[idx]) * m, dim=1)
    den = torch.sum(w.abs() * m, dim=1)
    pairs = means[users] + num / den.clamp(min=knn.EPS)
    num = torch.einsum("bk,bkp->bp", w, centered[idx])
    den = torch.einsum("bk,bkp->bp", w.abs(), mask[idx])
    scores = means[users][:, None] + num / den.clamp(min=knn.EPS)
    return pairs, scores


def _fixed_reads(bst, users, items):
    """The port's read path: pair predictions and the top-N scores."""
    st = bst.state
    mask, means, centered = knn._center(st.ratings)
    idx, w = knn._gathered(st.graph, users, centered.dtype)
    w = knn._mask_padded_rows(idx, w, bst.n_valid)
    pairs = buckets.predict_pairs(bst, users, items)
    scores = knn._block_predict(idx, w, centered, mask, means[users])
    return pairs, scores


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    u, p = 6040, 3952
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    r *= rng.random((u, p)) < 0.042
    spec = LandmarkSpec(n_landmarks=20, k_neighbors=13)
    st = fit(RatingMatrix(torch.as_tensor(r, device=dev), u, p), spec,
             generator=torch.Generator().manual_seed(0))
    bst = buckets.from_state(st, 256)
    cfg = EngineConfig(max_batch=128, min_shape=8)
    bad = {form: {"pair": [], "topn": []} for form in ("fixed", "library")}
    cases = 0
    for m in SIZES:
        uu, it = rng.integers(0, u, m), rng.integers(0, p, m)
        solo = cfg.pad_shape(m)
        su = np.zeros(solo, np.int64)
        si = np.zeros(solo, np.int64)
        su[:m], si[:m] = uu, it
        for form, reads in (("fixed", _fixed_reads),
                            ("library", _library_reads)):
            want = reads(bst, torch.as_tensor(su, device=dev),
                         torch.as_tensor(si, device=dev))
            want = [x[:m].cpu() for x in want]
            for shape in cfg.batch_shapes():
                if shape < m:
                    continue
                for off in sorted({0, (shape - m) // 2, shape - m}):
                    bu = rng.integers(0, u, shape)
                    bi = rng.integers(0, p, shape)
                    bu[off:off + m], bi[off:off + m] = uu, it
                    got = reads(bst, torch.as_tensor(bu, device=dev),
                                torch.as_tensor(bi, device=dev))
                    got = [x[off:off + m].cpu() for x in got]
                    cases += form == "fixed"
                    for kind, g, w in zip(("pair", "topn"), got, want):
                        if not torch.equal(g, w):
                            bad[form][kind].append((m, shape, off))
    card = "cpu"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "cases": cases, "mismatches": bad,
                      "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
