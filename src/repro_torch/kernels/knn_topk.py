"""Wrappers of the fused d2 similarity + top-k CUDA kernels
(``csrc/knn_topk.cu``).

- :func:`topk_sim` — the neighbor-graph build: every query row's top-k
  candidates, the (U, C) score matrix never written.
- :func:`foldin_topk` — the skinny fold-in search: candidates split across
  blocks, then the partial lists merged by a second kernel.

Both return lists in canonical order (value desc, id asc) with empty slots
as (-inf, 0). Cosine expects rows L2-normalized by the caller; pearson and
euclidean take raw representation rows.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build, ref

MAX_WIDTH = 64  # landmark axis n: register array size of the kernel
MAX_K = 32  # list length: register array size of the kernel
FOLDIN_SPLIT = 512  # candidates per block of the fold-in search


def _check(name, rep, cand, k, n_valid, measure):
    build.check_cuda_f32(name, rep, cand)
    n = rep.shape[1]
    if cand.shape[1] != n:
        raise ValueError(f"{name}: widths differ: {rep.shape} vs {cand.shape}")
    if not 1 <= n <= MAX_WIDTH:
        raise ValueError(f"{name}: width {n} outside 1..{MAX_WIDTH}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"{name}: k={k} outside 1..{MAX_K}")
    if not 0 <= n_valid <= cand.shape[0]:
        raise ValueError(f"{name}: n_valid={n_valid} outside 0..{cand.shape[0]}")
    if measure not in build.MEASURE_CODES:
        raise ValueError(f"unknown measure {measure!r}")


def topk_sim(rep: torch.Tensor, cand: torch.Tensor, k: int = 14,
             exclude_self: bool = False, n_valid: Optional[int] = None,
             measure: str = "cosine") -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals, ids), each (U, k): every rep row's top-k candidate d2 weights.

    Candidates ``>= n_valid`` (default: all valid) are never selected;
    ``exclude_self`` assumes rep row i is candidate i and masks it. CUDA
    tensors go through the kernel, CPU tensors take the plain version.
    """
    if rep.device.type == "cpu" and cand.device.type == "cpu":
        return ref.topk_sim_ref(rep, cand, k, exclude_self, n_valid, measure)
    n_valid = cand.shape[0] if n_valid is None else n_valid
    _check("topk_sim", rep, cand, k, n_valid, measure)
    u, n = rep.shape
    vals = torch.empty((u, k), dtype=torch.float32, device=rep.device)
    ids = torch.empty((u, k), dtype=torch.int32, device=rep.device)
    if u and cand.shape[0]:
        build.launch("topk_sim_f32", rep, cand, vals, ids, u, cand.shape[0],
                     n, k, n_valid, 0 if exclude_self else -1,
                     build.MEASURE_CODES[measure])
        topk_sim.launches += 1
    else:
        vals.fill_(float("-inf"))
        ids.zero_()
    return vals, ids


def foldin_topk(rep: torch.Tensor, cand: torch.Tensor, k: int = 14,
                self_offset: Optional[int] = None,
                n_valid: Optional[int] = None, measure: str = "cosine"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals, ids), each (b, k): top-k candidates of a skinny fold-in batch.

    Query i is candidate ``self_offset + i`` and never lists itself (None:
    the queries are not among the candidates). CUDA tensors go through the
    kernels, CPU tensors take the plain version.
    """
    if rep.device.type == "cpu" and cand.device.type == "cpu":
        return ref.foldin_topk_ref(rep, cand, k, self_offset, n_valid, measure)
    n_valid = cand.shape[0] if n_valid is None else n_valid
    _check("foldin_topk", rep, cand, k, n_valid, measure)
    b, n = rep.shape
    c = cand.shape[0]
    vals = torch.empty((b, k), dtype=torch.float32, device=rep.device)
    ids = torch.empty((b, k), dtype=torch.int32, device=rep.device)
    if b and c:
        splits = -(-c // FOLDIN_SPLIT)
        part_v = torch.empty((b, splits, k), dtype=torch.float32,
                             device=rep.device)
        part_i = torch.empty((b, splits, k), dtype=torch.int32,
                             device=rep.device)
        build.launch("foldin_topk_f32", rep, cand, part_v, part_i, vals, ids,
                     b, c, n, k, n_valid,
                     -1 if self_offset is None else self_offset,
                     FOLDIN_SPLIT, build.MEASURE_CODES[measure])
        foldin_topk.launches += 1
    else:
        vals.fill_(float("-inf"))
        ids.zero_()
    return vals, ids


topk_sim.launches = 0
foldin_topk.launches = 0
