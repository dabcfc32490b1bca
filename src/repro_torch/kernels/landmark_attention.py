"""Wrapper of the landmark-summary CUDA kernel
(``csrc/landmark_summary.cu``): softmax(Q̃ Kᵀ · scale) V streamed over the
sequence with running (max, denominator, accumulator), the B̃V term of
landmark attention. See the source's opening note for its design and bound.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build, ref

HEAD_DIMS = (32, 64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_PROBLEMS = 65535  # the grid's y axis


def landmark_summary(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v → float32, ``scale`` defaulting to 1/√D.

    ``q (n, D)`` against ``k, v (S, D)``, or a batch of problems
    ``q (P, n, D)``, ``k, v (P, S, D)``: in grouped-query form one problem
    is the stacked landmark queries of one (batch, kv-head). Any S; inputs
    float32 or bfloat16, upcast on load.

    CUDA tensors go through the kernel (contiguous, one dtype, on one
    device, D in :data:`HEAD_DIMS`, no gradient: there is no backward
    kernel; else ValueError); CPU tensors take the plain version.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.landmark_summary_ref(q, k, v, scale)
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"landmark_summary: inputs must be float32 or "
                         f"bfloat16, got {q.dtype}")
    if q.device.type != "cuda":
        raise ValueError(f"landmark_summary: all inputs must be on one CUDA "
                         f"device, got {[str(t.device) for t in (q, k, v)]}")
    if any(t.requires_grad for t in (q, k, v)):
        raise ValueError("landmark_summary: no backward kernel; call it "
                         "under torch.no_grad()")
    single = q.dim() == 2
    if single:
        q, k, v = q[None], k[None], v[None]
    for t in (q, k, v):
        build.check_cuda("landmark_summary", t, 3, (q.dtype,), q.device)
    p, n, _ = q.shape
    s = k.shape[1]
    if k.shape != (p, s, d) or v.shape != k.shape:
        raise ValueError(f"landmark_summary: shapes differ: q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"landmark_summary: head dim {d} not in {HEAD_DIMS}")
    if s < 1:
        raise ValueError("landmark_summary: no keys")
    if p > MAX_PROBLEMS:
        raise ValueError(f"landmark_summary: {p} problems exceed "
                         f"{MAX_PROBLEMS}")
    out = torch.empty((p, n, d), dtype=torch.float32, device=q.device)
    if p and n:
        build.launch("landmark_summary", q, k, v, out, p, n, s, d,
                     DTYPE_CODES[q.dtype], float(scale))
        landmark_summary.launches += 1
    return out[0] if single else out


landmark_summary.launches = 0
