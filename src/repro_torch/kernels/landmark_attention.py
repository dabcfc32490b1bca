"""Wrapper of the landmark-summary CUDA kernels
(``csrc/landmark_summary.cu``): softmax(Q̃ Kᵀ · scale) V streamed over the
sequence with running (max, denominator, accumulator), the B̃V term of
landmark attention. See the source's opening note for the design and bound.

The inputs' dtype chooses the route: bfloat16 goes to the tensor-core kernel
(TMA + wgmma, P split into two bf16 terms), float32 to the CUDA-core kernel.
``landmark_summary.launches`` counts both; ``landmark_summary.route_launches``
counts each.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build, ref

HEAD_DIMS = (32, 64, 128, 256)
# dtype → (route, C entry point)
ROUTES = {torch.bfloat16: ("tensor_core", "landmark_summary_bf16"),
          torch.float32: ("cuda_core", "landmark_summary_f32")}
MAX_PROBLEMS = 65535  # the grid's y axis
TMA_ALIGN = 16  # bytes: TMA's base address and row strides


def landmark_summary(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v → float32, ``scale`` defaulting to 1/√D.

    ``q (n, D)`` against ``k, v (S, D)``, or a batch of problems
    ``q (P, n, D)``, ``k, v (P, S, D)``: in grouped-query form one problem
    is the stacked landmark queries of one (batch, kv-head). Any S; inputs
    float32 or bfloat16.

    CUDA tensors go through the kernel of their dtype's route (contiguous,
    one dtype, on one device, 16-byte aligned for TMA, D in
    :data:`HEAD_DIMS`, no gradient: there is no backward kernel; else
    ValueError); a failed launch raises RuntimeError. CPU tensors take the
    plain version.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.landmark_summary_ref(q, k, v, scale)
    if q.dtype not in ROUTES:
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
        # TMA reads bf16 tiles: the base on a 16-byte boundary; the row
        # stride, 2·D bytes of a contiguous tensor, is a multiple of 16 for
        # every D in HEAD_DIMS
        if q.dtype == torch.bfloat16 and t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"landmark_summary: bfloat16 inputs must start "
                             f"on a {TMA_ALIGN}-byte boundary (TMA)")
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
        route, entry = ROUTES[q.dtype]
        build.launch(entry, q, k, v, out, p, n, s, d, float(scale))
        landmark_summary.launches += 1
        landmark_summary.route_launches[route] += 1
    return out[0] if single else out


landmark_summary.launches = 0
landmark_summary.route_launches = {route: 0 for route, _ in ROUTES.values()}
