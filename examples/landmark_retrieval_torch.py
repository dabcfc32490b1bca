"""Landmark-accelerated candidate retrieval (the paper's technique on the
recsys serving path) and the landmark-attention analogue, on the
PyTorch/CUDA port.

  PYTHONPATH=src python examples/landmark_retrieval_torch.py [--device cpu]
      [--dataset movielens100k]

Runs on the card unless ``--device cpu`` is given: there d1 runs on the
masked-similarity kernel (``ops.masked_similarity``) and the attention's
B̃V on the landmark-summary kernel's f32 route.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.graph import build_neighbor_graph
from repro_torch.core.similarity import dense_similarity
from repro_torch.core.topk import canonical_topk
from repro_torch.data.ratings import synthesize
from repro_torch.kernels import ops
from repro_torch.models.layers import landmark_attention

N_LANDMARKS = 64
ATTN_SHAPE = (1, 2048, 4, 64)  # batch, seq, heads, head dim
ATTN_LANDMARKS = (64, 256)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dataset", default="movielens1m")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32, as the reference

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    # --- 1. item-item retrieval through the landmark space ----------------
    # MovieLens-statistics ratings (latent structure matters: similarity
    # over structure-free random data has nothing to preserve). Item-based
    # CF: items are represented over users; full item-item = O(I²·U),
    # landmarks = O(I·n·U + I²·n): the paper's complexity win on the
    # serving path.
    data = synthesize(args.dataset, seed=0)
    inter = data.to_matrix(device=device).ratings.T.contiguous()  # (I, U)
    n_items = inter.shape[0]

    sync()
    t0 = time.perf_counter()
    full = ops.masked_similarity(inter, inter, "pearson")
    sync()
    t_full = time.perf_counter() - t0

    counts = (inter != 0).sum(dim=1)
    landmarks = inter[torch.argsort(-counts, stable=True)[:N_LANDMARKS]]
    t0 = time.perf_counter()
    rep = ops.masked_similarity(inter, landmarks.contiguous(), "pearson")
    approx = dense_similarity(rep, rep, "pearson")
    sync()
    t_lm = time.perf_counter() - t0

    # retrieval quality: top-10 overlap between exact and landmark
    # neighbors (restricted to well-rated items; cold items have no exact
    # answer either)
    hot = torch.nonzero(counts > 100).flatten()[:400]
    self_mask = torch.eye(n_items, device=device)[hot] * 10
    _, top_full = canonical_topk(full[hot] - self_mask, 10)
    _, top_lm = canonical_topk(approx[hot] - self_mask, 10)
    top_full, top_lm = top_full.cpu().numpy(), top_lm.cpu().numpy()
    overlap = float(np.mean([len(set(a) & set(b)) / 10
                             for a, b in zip(top_full, top_lm)]))
    # neighbor QUALITY under the exact metric: how much true similarity
    # mass the landmark-chosen neighbors carry vs the optimal top-10 (the
    # paper's claim is end-task accuracy, not neighbor-set identity)
    f_np = full[hot].cpu().numpy()
    quality = float(np.mean([
        f_np[i, top_lm[i]].mean() / max(f_np[i, top_full[i]].mean(), 1e-9)
        for i in range(len(top_full))]))
    print(f"item-item retrieval: full {t_full:.2f}s vs landmark "
          f"{t_lm:.2f}s ({t_full / t_lm:.1f}x), top-10 overlap "
          f"{overlap:.2f}, neighbor quality {quality:.2f} (landmark "
          f"neighbors' true-similarity mass vs optimal)")

    # NeighborGraph via the streaming backend: no (I, I) matrix
    graph = build_neighbor_graph(rep, "cosine", k=10, backend="streaming",
                                 chunk=512)
    print(f"NeighborGraph: {tuple(graph.indices.shape)} neighbor table "
          f"(indices + weights), no {n_items}x{n_items} similarity matrix "
          f"materialized")

    # --- 2. the same reduction on attention (tokens ≙ users) -------------
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.normal(size=ATTN_SHAPE).astype(np.float32),
                               device=device) for _ in range(3))
    d = ATTN_SHAPE[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d)
    dense = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, -1), v)
    attn_err = {}
    for n in ATTN_LANDMARKS:
        out = landmark_attention(q, k, v, n_landmarks=n)
        attn_err[n] = float((out - dense).abs().mean())
        print(f"landmark attention n={n:4d}: mean |err| {attn_err[n]:.4f} "
              f"(O(S·n) vs O(S²) scores)")
    return dict(items=n_items, users=inter.shape[1], t_full_s=t_full,
                t_landmark_s=t_lm, overlap=overlap, quality=quality,
                graph=tuple(graph.indices.shape), attn_err=attn_err)


if __name__ == "__main__":
    main()
