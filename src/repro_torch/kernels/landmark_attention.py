"""Wrapper of the landmark-summary CUDA kernels
(``csrc/landmark_summary.cu``): softmax(Q̃ Kᵀ · scale) V streamed over the
sequence with running (max, denominator, accumulator), the B̃V term of
landmark attention. See the source's opening note for the design and bound.

The inputs' dtype chooses the route, both on the tensor cores (one TMA +
wgmma loop, P split into two bf16 terms): bfloat16 inputs go in as they
are (``tensor_core``); float32 inputs are first split into bf16 planes by
:func:`bf16_terms`, three terms of q and k and two of v (``f32_split``).
``landmark_summary.launches`` counts both; ``landmark_summary.route_launches``
counts each; ``bf16_terms.launches`` counts the split pass.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build, ref

HEAD_DIMS = (32, 64, 128, 256)
# dtype → (route, C entry point)
ROUTES = {torch.bfloat16: ("tensor_core", "landmark_summary_bf16"),
          torch.float32: ("f32_split", "landmark_summary_f32")}
QK_TERMS, V_TERMS = 3, 2  # bf16 terms of f32 q and k, and of f32 v
MAX_PROBLEMS = 65535  # the grid's y axis
# bytes: TMA's base address and row strides, and the split pass's float4
# loads
ALIGN = 16


def bf16_terms(x: torch.Tensor, terms: int) -> torch.Tensor:
    """float32 ``x`` as ``terms`` bfloat16 planes ``(terms, *x.shape)``:
    x0 = bf16(x), x1 = bf16(x − x0), x2 = bf16(x − x0 − x1) — the f32
    route's split pass (``split_bf16_terms`` in ``csrc/landmark_summary.cu``).

    A CUDA tensor (contiguous, 16-byte aligned, a multiple of 4 elements,
    ``terms`` in 1–3; else ValueError) goes through the kernel; a CPU
    tensor takes the plain version, :func:`ref.bf16_terms`.
    """
    if x.device.type == "cpu":
        return ref.bf16_terms(x, terms)
    build.check_cuda("bf16_terms", x, x.dim(), (torch.float32,), x.device)
    if x.data_ptr() % ALIGN or x.numel() % 4 or not 1 <= terms <= 3:
        raise ValueError(f"bf16_terms: needs a {ALIGN}-byte aligned base, "
                         f"a multiple of 4 elements and 1-3 terms")
    planes = torch.empty((terms, *x.shape), dtype=torch.bfloat16,
                         device=x.device)
    if x.numel():
        build.launch("split_bf16_terms", x, planes, x.numel(), terms)
        build.count_launch(bf16_terms)
    return planes


bf16_terms.launches = 0


def landmark_summary(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v → float32, ``scale`` defaulting to 1/√D.

    ``q (n, D)`` against ``k, v (S, D)``, or a batch of problems
    ``q (P, n, D)``, ``k, v (P, S, D)``: in grouped-query form one problem
    is the stacked landmark queries of one (batch, kv-head). Any S; inputs
    float32 or bfloat16.

    CUDA tensors go through the kernel of their dtype's route (contiguous,
    one dtype, on one device, 16-byte aligned, D in
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
        # TMA reads bf16 tiles and the split pass f32 float4s: the base on
        # a 16-byte boundary; the row stride, 2·D or 4·D bytes of a
        # contiguous tensor, is a multiple of 16 for every D in HEAD_DIMS
        if t.data_ptr() % ALIGN:
            raise ValueError(f"landmark_summary: inputs must start on a "
                             f"{ALIGN}-byte boundary (TMA)")
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
        if route == "f32_split":
            q, k = bf16_terms(q, QK_TERMS), bf16_terms(k, QK_TERMS)
            v = bf16_terms(v, V_TERMS)
        build.launch(entry, q, k, v, out, p, n, s, d, float(scale))
        build.count_launch(landmark_summary)
        landmark_summary.route_launches[route] += 1
    return out[0] if single else out


landmark_summary.launches = 0
landmark_summary.route_launches = {route: 0 for route, _ in ROUTES.values()}
