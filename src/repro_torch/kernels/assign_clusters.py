"""Wrappers of the Lloyd CUDA kernel (``csrc/assign_clusters.cu``).

One launch runs a whole k-means: the rows prepared once, then per step the
assignment (the graph-build epilogue, ties to the lowest centroid id) and
each cell's mean over its members added in ascending row order. The
standalone assignment is the same kernel with no step. See the source's
opening note for its design and bound.

Both wrappers count their launches in ``assign_clusters.launches``, the
kernel's one count.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build, ref
from .knn_topk import NARROW_WIDTH, check_width


def centroid_stride(n: int) -> int:
    """Floats a prepared centroid takes in the kernel's scratch: up to
    ``NARROW_WIDTH`` its register width (8, 20, 32, 64 or 104) padded to
    ≡ 4 mod 8, past it n (the wide route)."""
    if n > NARROW_WIDTH:
        return n
    width = next(w for w in (8, 20, 32, 64, NARROW_WIDTH) if n <= w)
    return width if width % 8 else width + 4


def kmeans_lloyd(rep: torch.Tensor, init: torch.Tensor, iters: int = 8,
                 n_valid: Optional[int] = None, measure: str = "cosine", *,
                 normalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` Lloyd steps over ``rep (U, n)`` from ``init (C, n)``:
    ``(centroids (C, n) f32, assign (U,) int32)``, the assignment of all U
    rows under the last centroids. Rows ``>= n_valid`` take no part in the
    means. With ``normalize`` cosine rows and centroids are L2-normalized
    in the kernel; otherwise the caller normalized them.

    CUDA tensors go through the kernel in one cooperative launch
    (contiguous float32 on one device, else ValueError; a launch the card
    refuses raises RuntimeError); CPU tensors take the plain version.
    """
    if rep.device.type == "cpu" and init.device.type == "cpu":
        return ref.kmeans_lloyd_ref(rep, init, iters, n_valid, measure,
                                    normalize)
    build.check_cuda_f32("kmeans_lloyd", rep, init)
    if measure not in build.MEASURE_CODES:
        raise ValueError(f"unknown measure {measure!r}")
    u, n = rep.shape
    c = init.shape[0]
    if init.shape[1] != n:
        raise ValueError(f"kmeans_lloyd: widths differ: {rep.shape} vs "
                         f"{init.shape}")
    check_width("kmeans_lloyd", n)
    if c < 1:
        raise ValueError("kmeans_lloyd: no centroids")
    nv = u if n_valid is None else int(n_valid)
    if not 0 <= nv <= u or iters < 0:
        raise ValueError(f"kmeans_lloyd: n_valid={n_valid} outside 0..{u} "
                         f"or iters={iters} < 0")
    cent = torch.empty_like(init)
    assign = torch.empty((u,), dtype=torch.int32, device=rep.device)
    if not u:
        return cent.copy_(init), assign
    # per-call scratch: the rows and the centroids as the scores take them,
    # each with its epilogue value
    prep = torch.empty_like(rep)
    pval = torch.empty((u,), dtype=torch.float32, device=rep.device)
    cscratch = torch.empty((c * (centroid_stride(n) + 1),),
                           dtype=torch.float32, device=rep.device)
    build.launch("kmeans_lloyd_f32", rep, init, cent, assign, prep, pval,
                 cscratch, u, c, n, iters, nv, build.MEASURE_CODES[measure],
                 int(normalize))
    build.count_launch(assign_clusters)
    return cent, assign


def assign_clusters(rep: torch.Tensor, cent: torch.Tensor,
                    measure: str = "cosine") -> torch.Tensor:
    """(U,) int32 nearest-centroid id of every ``rep (U, n)`` row among
    ``cent (C, n)``. Cosine expects both L2-normalized by the caller.

    CUDA tensors go through the Lloyd kernel with no step (contiguous
    float32 on one device, else ValueError); CPU tensors take the plain
    version.
    """
    if rep.device.type == "cpu" and cent.device.type == "cpu":
        return ref.assign_clusters_ref(rep, cent, measure)
    return kmeans_lloyd(rep, cent, 0, measure=measure, normalize=False)[1]


assign_clusters.launches = 0
