"""Wrapper of the d1 CUDA kernel (``csrc/masked_similarity.cu``).

The kernel computes the six co-rated moments of two rating blocks in one
pass over the item axis and applies the measure epilogue in registers;
see the source's opening note for its design and bound.
"""
from __future__ import annotations

import torch

from . import build, ref


def masked_similarity(r_a: torch.Tensor, r_b: torch.Tensor,
                      measure: str = "cosine") -> torch.Tensor:
    """Co-rated similarity (A, B) of ``r_a (A, P)`` against ``r_b (B, P)``.

    CUDA tensors go through the kernel (contiguous float32 on one device,
    else ValueError); CPU tensors take the plain version.
    """
    if r_a.device.type == "cpu" and r_b.device.type == "cpu":
        return ref.masked_similarity_ref(r_a, r_b, measure)
    build.check_cuda_f32("masked_similarity", r_a, r_b)
    if measure not in build.MEASURE_CODES:
        raise ValueError(f"unknown measure {measure!r}")
    if r_a.shape[1] != r_b.shape[1]:
        raise ValueError(f"item axes differ: {r_a.shape} vs {r_b.shape}")
    a, p = r_a.shape
    b = r_b.shape[0]
    out = torch.empty((a, b), dtype=torch.float32, device=r_a.device)
    if a and b:
        build.launch("masked_similarity_f32", r_a, r_b, out, a, b, p,
                     build.MEASURE_CODES[measure])
        masked_similarity.launches += 1
    return out


masked_similarity.launches = 0
