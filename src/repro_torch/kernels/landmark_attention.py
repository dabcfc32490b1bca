"""Wrappers of the landmark-summary CUDA kernels
(``csrc/landmark_summary.cu``, ``csrc/landmark_summary_bwd.cu``):
softmax(Q̃ Kᵀ · scale) V streamed over the sequence with running (max,
denominator, accumulator), the B̃V term of landmark attention, and its
backward. See each source's opening note for the design and bound.

The inputs' dtype chooses the forward's route, both on the tensor cores
(one TMA + wgmma loop, P split into two bf16 terms): bfloat16 inputs go in
as they are (``tensor_core``); float32 inputs are first split into bf16
planes by :func:`bf16_terms`, three terms of q and k and two of v
(``f32_split``). ``landmark_summary.launches`` counts both;
``landmark_summary.route_launches`` counts each; ``bf16_terms.launches``
counts the split pass.

:func:`landmark_summary` is differentiable: with grad enabled and an input
that requires grad it runs through :class:`LandmarkSummary`, the forward
kernel and then :func:`landmark_summary_bwd`'s kernels (two launches a
call, counted in ``landmark_summary_bwd.launches``, and by route in
``landmark_summary_bwd.route_launches``); CPU tensors take the plain
versions of both; meta tensors take neither (the outputs and scratch on
``meta``, each call's cost charged to ``kernels/cost.py``'s tallies, no
launch). The backward's route is chosen by dtype and head dim; at
D ≤ 128 both forms run one TMA + wgmma loop on bf16 planes, dO split into
two by :func:`bf16_terms` first: bfloat16 inputs go in as they are
(``tensor_core``, one split pass a call), float32 inputs are split into
three planes of q and k and two of v as well (``f32_split``, four split
passes a call). D = 256 takes ``fma`` (scalar f32 FMAs) at either dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import build, cost, ref

HEAD_DIMS = (32, 64, 128, 256)
# dtype → (route, C entry point)
ROUTES = {torch.bfloat16: ("tensor_core", "landmark_summary_bf16"),
          torch.float32: ("f32_split", "landmark_summary_f32")}
QK_TERMS, V_TERMS = 3, 2  # bf16 terms of f32 q and k, and of f32 v
MAX_PROBLEMS = 65535  # the grid's y axis
# the backward's launches a call (the dq pass, then the dk/dv pass); the
# head dims of its tensor-core routes (D = 256 keeps dK and dV in 256
# registers a thread, more than a thread has, so it takes the FMA route);
# the C entry points by dtype of the tensor-core routes (D ≤ 128) and of
# the FMA route (D = 256)
BWD_LAUNCHES = 2
BWD_TC_DIMS = (32, 64, 128)
BWD_TC_ENTRIES = {torch.bfloat16: "landmark_summary_bwd_tc",
                  torch.float32: "landmark_summary_bwd_tc_f32"}
BWD_FMA_ENTRIES = {torch.bfloat16: "landmark_summary_bwd_bf16",
                   torch.float32: "landmark_summary_bwd_f32"}
BWD_DO_TERMS = 2  # bf16 planes of dO on the tensor-core routes
# lse and Δ rows of the tensor-core route: n padded to a multiple of every
# query tile (ROW_PAD in csrc/landmark_summary_bwd.cu)
BWD_ROW_PAD = 128
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
    meta = build.on_meta("bf16_terms", x)
    build.check_cuda("bf16_terms", x, x.dim(), (torch.float32,), x.device)
    if x.data_ptr() % ALIGN or x.numel() % 4 or not 1 <= terms <= 3:
        raise ValueError(f"bf16_terms: needs a {ALIGN}-byte aligned base, "
                         f"a multiple of 4 elements and 1-3 terms")
    planes = torch.empty((terms, *x.shape), dtype=torch.bfloat16,
                         device=x.device)
    if x.numel() and not meta:
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
    one dtype, on one device, 16-byte aligned, D in :data:`HEAD_DIMS`;
    else ValueError); a failed launch raises RuntimeError. CPU tensors take
    the plain version. With grad enabled and an input that requires grad,
    the call is differentiable (:class:`LandmarkSummary`): its backward is
    :func:`landmark_summary_bwd`.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return LandmarkSummary.apply(q, k, v, scale)
    return _summary(q, k, v, scale)


def _summary(q, k, v, scale: float) -> torch.Tensor:
    """The forward: the kernel for CUDA tensors, the plain version for CPU
    ones (no autograd)."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.landmark_summary_ref(q, k, v, scale)
    meta = build.on_meta("landmark_summary", q, k, v)
    single = q.dim() == 2
    if single:
        q, k, v = q[None], k[None], v[None]
    p, n, s, d = _check("landmark_summary", q, k, v)
    out = torch.empty((p, n, d), dtype=torch.float32, device=q.device)
    if p and n:
        route, entry = ROUTES[q.dtype]
        bf16 = q.dtype == torch.bfloat16
        cost.charge("landmark_summary",
                    lambda: cost.landmark_summary(p, n, s, d, bf16))
        if route == "f32_split":
            q, k = bf16_terms(q, QK_TERMS), bf16_terms(k, QK_TERMS)
            v = bf16_terms(v, V_TERMS)
        if not meta:
            build.launch(entry, q, k, v, out, p, n, s, d, float(scale))
            build.count_launch(landmark_summary)
            landmark_summary.route_launches[route] += 1
    return out[0] if single else out


def _check(name: str, q, k, v):
    """Raise unless q (P, n, D), k, v (P, S, D) are contiguous CUDA tensors
    of one kernel dtype on one device, 16-byte aligned, D in HEAD_DIMS,
    S ≥ 1, P ≤ MAX_PROBLEMS; returns (P, n, S, D)."""
    if q.dtype not in ROUTES:
        raise ValueError(f"{name}: inputs must be float32 or bfloat16, got "
                         f"{q.dtype}")
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                         f"got {[str(t.device) for t in (q, k, v)]}")
    for t in (q, k, v):
        build.check_cuda(name, t, 3, (q.dtype,), q.device)
        # TMA reads bf16 tiles and the split pass f32 float4s: the base on
        # a 16-byte boundary; the row stride, 2·D or 4·D bytes of a
        # contiguous tensor, is a multiple of 16 for every D in HEAD_DIMS
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name}: inputs must start on a {ALIGN}-byte "
                             f"boundary (TMA)")
    p, n, d = q.shape
    s = k.shape[1]
    if k.shape != (p, s, d) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes differ: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if s < 1:
        raise ValueError(f"{name}: no keys")
    if p > MAX_PROBLEMS:
        raise ValueError(f"{name}: {p} problems exceed {MAX_PROBLEMS}")
    return p, n, s, d


landmark_summary.launches = 0
landmark_summary.route_launches = {route: 0 for route, _ in ROUTES.values()}


def landmark_summary_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, dout: torch.Tensor, scale: float):
    """The gradients (dq, dk, dv), float32, of ``out`` = softmax(q kᵀ ·
    scale) v given ``dout``: the backward of :func:`landmark_summary`, in
    its shapes (2-D, or P problems).

    CUDA tensors go through the backward kernels of the route
    :func:`bwd_route` names (q, k, v as the forward takes them; ``out``
    and ``dout`` contiguous float32 of q's shape on the same device, 16-byte
    aligned; else ValueError), two launches, after :func:`bf16_terms` of
    ``dout`` on the tensor-core routes (and of q, k, v on ``f32_split``); a
    failed launch raises RuntimeError, with no other route to fall back to.
    CPU tensors take the plain version, :func:`ref.landmark_summary_bwd_ref`.
    """
    if all(t.device.type == "cpu" for t in (q, k, v, out, dout)):
        return ref.landmark_summary_bwd_ref(q, k, v, out, dout, scale)
    meta = build.on_meta("landmark_summary_bwd", q, k, v, out, dout)
    single = q.dim() == 2
    if single:
        q, k, v, out, dout = (t[None] for t in (q, k, v, out, dout))
    name = "landmark_summary_bwd"
    p, n, s, d = _check(name, q, k, v)
    for t in (out, dout):
        build.check_cuda(name, t, 3, (torch.float32,), q.device)
        if t.shape != q.shape:
            raise ValueError(f"{name}: out and dout must be {tuple(q.shape)}"
                             f", got {tuple(t.shape)}")
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name}: out and dout must start on a {ALIGN}"
                             f"-byte boundary")
    dq = torch.empty((p, n, d), dtype=torch.float32, device=q.device)
    # every row of dk and dv is written when there is a query
    alloc = torch.empty if p and n else torch.zeros
    dk = alloc((p, s, d), dtype=torch.float32, device=q.device)
    dv = alloc((p, s, d), dtype=torch.float32, device=q.device)
    if p and n:
        route = bwd_route(q.dtype, d)
        tc = route != "fma"
        entry = (BWD_TC_ENTRIES if tc else BWD_FMA_ENTRIES)[q.dtype]
        rows = -(-n // BWD_ROW_PAD) * BWD_ROW_PAD if tc else n
        lse = torch.empty((p, rows), dtype=torch.float32, device=q.device)
        delta = torch.empty_like(lse)
        bf16 = q.dtype == torch.bfloat16
        cost.charge("landmark_summary_bwd",
                    lambda: cost.landmark_summary_bwd(p, n, s, d, bf16))
        if tc:
            planes = bf16_terms(dout, BWD_DO_TERMS)
            if route == "f32_split":
                q, k = bf16_terms(q, QK_TERMS), bf16_terms(k, QK_TERMS)
                v = bf16_terms(v, V_TERMS)
        if tc and not meta:
            build.launch(entry, q, k, v, out, dout, planes, dq, dk, dv, lse,
                         delta, p, n, rows, s, d, float(scale))
        elif not meta:
            build.launch(entry, q, k, v, out, dout, dq, dk, dv, lse, delta,
                         p, n, s, d, float(scale))
        if not meta:
            build.count_launch(landmark_summary_bwd, BWD_LAUNCHES)
            landmark_summary_bwd.route_launches[route] += BWD_LAUNCHES
    if single:
        return dq[0], dk[0], dv[0]
    return dq, dk, dv


def bwd_route(dtype: torch.dtype, d: int) -> str:
    """The backward's route for inputs of ``dtype`` and head dim ``d``: at
    D in :data:`BWD_TC_DIMS`, ``tensor_core`` for bfloat16 and
    ``f32_split`` for float32; else ``fma``."""
    if d not in BWD_TC_DIMS:
        return "fma"
    return "tensor_core" if dtype == torch.bfloat16 else "f32_split"


landmark_summary_bwd.launches = 0
landmark_summary_bwd.route_launches = {"tensor_core": 0, "f32_split": 0,
                                       "fma": 0}


class LandmarkSummary(torch.autograd.Function):
    """:func:`landmark_summary` with a gradient: the forward kernel (plain
    version on the CPU) saves q, k, v and its float32 output; the backward
    runs :func:`landmark_summary_bwd` and returns the gradients in the
    inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out = _summary(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = landmark_summary_bwd(q, k, v, out,
                                          dout.float().contiguous(),
                                          ctx.scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None
