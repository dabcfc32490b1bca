"""Gradient compression: int8 quantization with error feedback.

The reference's ``repro.distributed.compression``. For cross-pod gradient
reduction the wire format matters: int8 and one f32 scale a tensor is a
4× (against f32) or 2× (against bf16) cut of the payload. Error feedback
(Seide et al. 2014) keeps the quantization residual in a local buffer and
folds it into the next step, which keeps convergence.

The quantizers are the reference's operations in the same order: the
scale max|x| / 127 + 1e-12 in f32, codes round-half-even(x / scale)
clipped to ±127. Every division is by a tensor, never by a Python
number: on the card, torch divides by a host scalar as a multiplication
by its reciprocal, which can differ from the quotient in the last bit.

:func:`psum_compressed` is the collective on the single-process mesh
(``launch/mesh.py``): each position along the axis quantizes its copy,
the positions share the largest scale, sum their codes in int32 in linear
order and dequantize. The reference has no Pallas kernel here, so this is
plain tensor code.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..kernels import cost

Grads = Dict[str, torch.Tensor]


def _scale(x: torch.Tensor) -> torch.Tensor:
    """max|x| / 127 + 1e-12, a 0-d f32 tensor on x's device."""
    f32 = dict(dtype=torch.float32, device=x.device)
    return (x.abs().max() / torch.tensor(127.0, **f32)
            + torch.tensor(1e-12, **f32))


def _codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 codes of x's shape, the 0-d f32 scale)."""
    scale = _scale(x)
    return _codes(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grad: torch.Tensor, error_buf: torch.Tensor):
    """(int8 payload, scale, new error buffer) of ``grad`` with the
    residual ``error_buf`` folded in: the new buffer is exactly what the
    payload leaves out."""
    g = grad.to(torch.float32) + error_buf
    q, scale = quantize_int8(g)
    return q, scale, g - dequantize_int8(q, scale)


def tree_compress(grads: Grads, error_bufs: Grads):
    """Quantize a ``{name: gradient}`` dict with per-leaf error feedback.
    Returns ``((codes, scales), new error buffers, dequantized gradients
    in each gradient's dtype)``, each a dict by name."""
    qs, scales, errs, deqs = {}, {}, {}, {}
    for name, g in grads.items():
        qs[name], scales[name], errs[name] = compress_with_feedback(
            g, error_bufs[name])
        deqs[name] = dequantize_int8(qs[name], scales[name]).to(g.dtype)
    return (qs, scales), errs, deqs


def init_error_buffers(grads_like: Grads) -> Grads:
    """Zero f32 residuals of each gradient's shape, on its device."""
    return {name: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for name, g in grads_like.items()}


def psum_compressed(x: torch.Tensor, mesh, axis: str = "pod"
                    ) -> torch.Tensor:
    """The int8-on-the-wire sum of ``x`` over the mesh's ``axis``.

    ``x`` is replicated, as under the reference's ``P(None, …)`` in-spec:
    each of the n positions along ``axis`` (the other axes at 0) holds a
    copy on its device and quantizes it; the positions share the largest
    scale s (the reference's ``pmax``), sum their codes in int32 in linear
    order and dequantize, so the result is n·round(x/s)·s, within n·s/2 of
    the exact sum. An ``axis`` the mesh lacks returns ``x`` unchanged.
    """
    if axis not in mesh.axis_names:
        return x
    stride = 1
    for name, size in zip(reversed(mesh.axis_names), reversed(mesh.sizes)):
        if name == axis:
            break
        stride *= size
    copies = [x.to(mesh.devices[i * stride])
              for i in range(mesh.shape[axis])]
    scale = torch.stack([_scale(c).to(x.device) for c in copies]).max()
    cost.collective("all-reduce", 4)  # the shared scale
    codes = [_codes(c, scale.to(c.device)).to(torch.int32) for c in copies]
    cost.collective("all-reduce", 4 * x.numel())  # the int32 sum
    total = codes[0].to(x.device)
    for c in codes[1:]:
        total = total + c.to(x.device)
    return total.to(torch.float32) * scale
