"""Quickstart on the PyTorch/CUDA port: the paper's pipeline in ~30 lines.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import time

import torch

from repro_torch.core import LandmarkSpec, fit, fit_baseline, predict
from repro_torch.data.ratings import kfold_split, mae, synthesize

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
device = torch.device(ap.parse_args().device)
torch.backends.cuda.matmul.allow_tf32 = False  # full f32, as the reference


def sync():
    if device.type == "cuda":
        torch.cuda.synchronize()


# 1) MovieLens100k-statistics synthetic ratings, 10-fold CV split (paper §4.1)
data = synthesize("movielens100k", seed=0)
train_idx, test_idx = kfold_split(data, fold=0)
matrix = data.to_matrix(train_idx, device=device)
test_u = torch.as_tensor(data.users[test_idx], device=device)
test_v = torch.as_tensor(data.items[test_idx], device=device)

# 2) Landmark CF: Popularity selection, 20 landmarks, cosine d1/d2 (paper §4.4)
spec = LandmarkSpec(n_landmarks=20, selection="popularity",
                    d1="cosine", d2="cosine", k_neighbors=13)
t0 = time.perf_counter()
state = fit(matrix, spec)
preds = predict(state, test_u, test_v, spec)
sync()
t_landmark = time.perf_counter() - t0
print(f"Landmarks kNN : MAE {mae(preds.cpu().numpy(), data.ratings[test_idx]):.4f}"
      f"  ({t_landmark:.2f}s on {device}, kernels built on first use)")

# 3) The O(|U|²·|P|) full-matrix baseline the paper speeds up
t0 = time.perf_counter()
base = fit_baseline(matrix, "cosine")
preds_b = predict(base, test_u, test_v, spec)
sync()
t_base = time.perf_counter() - t0
print(f"Full kNN CF   : MAE {mae(preds_b.cpu().numpy(), data.ratings[test_idx]):.4f}"
      f"  ({t_base:.2f}s)")
print(f"landmark representation: {tuple(state.representation.shape)} "
      f"(vs {tuple(matrix.ratings.shape)} ratings) — {spec.n_landmarks} landmarks")
print(f"fitted artifact: NeighborGraph {tuple(state.graph.indices.shape)} "
      f"(indices+weights, O(U·k)) — the dense "
      f"({matrix.ratings.shape[0]}, {matrix.ratings.shape[0]}) similarity matrix is never built")
