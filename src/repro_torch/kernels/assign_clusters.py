"""Wrapper of the Lloyd-assignment CUDA kernel (``csrc/assign_clusters.cu``).

The kernel scores every row against every centroid with the graph-build
epilogue (cosine on caller-normalized rows) and writes each row's arg-max
centroid id, ties to the lowest id; see the source's opening note for its
design and bound.
"""
from __future__ import annotations

import torch

from . import build, ref
from .knn_topk import MAX_WIDTH


def assign_clusters(rep: torch.Tensor, cent: torch.Tensor,
                    measure: str = "cosine") -> torch.Tensor:
    """(U,) int32 nearest-centroid id of every ``rep (U, n)`` row among
    ``cent (C, n)``. Cosine expects both L2-normalized by the caller.

    CUDA tensors go through the kernel (contiguous float32 on one device,
    else ValueError); CPU tensors take the plain version.
    """
    if rep.device.type == "cpu" and cent.device.type == "cpu":
        return ref.assign_clusters_ref(rep, cent, measure)
    build.check_cuda_f32("assign_clusters", rep, cent)
    if measure not in build.MEASURE_CODES:
        raise ValueError(f"unknown measure {measure!r}")
    u, n = rep.shape
    c = cent.shape[0]
    if cent.shape[1] != n:
        raise ValueError(f"assign_clusters: widths differ: {rep.shape} vs "
                         f"{cent.shape}")
    if not 1 <= n <= MAX_WIDTH:
        raise ValueError(f"assign_clusters: width {n} outside 1..{MAX_WIDTH}")
    if c < 1:
        raise ValueError("assign_clusters: no centroids")
    out = torch.empty((u,), dtype=torch.int32, device=rep.device)
    if u:
        build.launch("assign_clusters_f32", rep, cent, out, u, c, n,
                     build.MEASURE_CODES[measure])
        assign_clusters.launches += 1
    return out


assign_clusters.launches = 0
