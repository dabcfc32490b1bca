"""Wrapper of the gathered-candidate scorer CUDA kernel
(``csrc/score_candidates.cu``): each query against its own gathered
candidate rows, the ``dense_similarity`` algebra on raw rows. The IVF
search runs it at partial probe with ``scorer="kernel"``; its shared form
(one candidate block for every query) scores the back-patch of the
bucketed and sharded fold-ins and of every update
(``core/graph.py::backpatch_sims``). The two forms are two kernels of one
launch each, chosen by ``cand``'s rank; both take any landmark count.
"""
from __future__ import annotations

import torch

from . import build, ref
from .knn_topk import check_width


def score_candidates(q: torch.Tensor, cand: torch.Tensor,
                     measure: str = "cosine") -> torch.Tensor:
    """(b, m) d2 scores of ``q (b, n)`` against ``cand (b, m, n)``, each
    query's own candidates, or against ``cand (m, n)``, one block shared by
    every query.

    CUDA tensors go through the kernel (contiguous float32 on one device,
    else ValueError); CPU tensors take the plain version.
    """
    if q.device.type == "cpu" and cand.device.type == "cpu":
        return ref.score_candidates_ref(q, cand, measure)
    build.check_cuda_f32("score_candidates", q)
    shared = cand.dim() == 2
    build.check_cuda("score_candidates", cand, 2 if shared else 3,
                     (torch.float32,), q.device)
    if measure not in build.MEASURE_CODES:
        raise ValueError(f"unknown measure {measure!r}")
    b, n = q.shape
    if cand.shape[-1] != n or not (shared or cand.shape[0] == b):
        raise ValueError(f"score_candidates: shapes differ: {tuple(q.shape)} "
                         f"vs {tuple(cand.shape)}")
    check_width("score_candidates", n)
    m = cand.shape[-2]
    out = torch.empty((b, m), dtype=torch.float32, device=q.device)
    if b and m:
        build.launch("score_candidates_f32", q, cand, out, b, m, n,
                     build.MEASURE_CODES[measure], int(shared))
        build.count_launch(score_candidates)
    return out


score_candidates.launches = 0
