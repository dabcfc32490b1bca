"""Wrapper of the d1 CUDA kernels (``csrc/masked_similarity.cu``).

The six co-rated moments of two rating blocks are taken in one pass over
the item axis, then the measure epilogue; see the source's opening note for
the design and bound. Two routes:

- ``tensor_core``: bf16 ``wgmma`` with f32 sums, exact on values that are
  multiples of ½ with |v| ≤ 8 (ratings 1..5 and 0 for missing, half stars
  too) while P < 65536. The kernel checks every value on the device; the
  finalize launch that follows computes the f32 route instead when one
  fails, with no host sync. So its output is the f32 route's, bit for bit,
  on every input;
- ``f32``: f32 FMAs on the CUDA cores.

``route="auto"`` takes the tensor-core route whenever P allows it,
``route="f32"`` the f32 route.
``masked_similarity.launches`` counts calls that launched, and
``masked_similarity.route_launches`` the route each launched;
:func:`route_results` reads from the card how many tensor-core calls kept
their result and how many the f32 route replaced.
"""
from __future__ import annotations

import torch

from . import build, cost, ref

ROUTES = ("auto", "f32")
# the tensor-core route's bound on P (ref.D1_MAX_ITEMS: sums stay below 2^22)
MAX_ITEMS = 65535
# the route's landmark planes, as the source lays them out: one 8 KB bf16
# tile per 21 landmarks and 64 items
N_TILE, STAGE_ITEMS, PLANE_TILE_BYTES = 21, 64, 8192


def _workspace_bytes(a: int, b: int, p: int) -> int:
    """The tensor-core route's scratch: the (6, B, A) f32 moments and the
    guard flag, then on a 16-byte boundary the landmark planes."""
    head = -(-(6 * a * b * 4 + 16) // 16) * 16
    tiles = -(-b // N_TILE) * -(-p // STAGE_ITEMS)
    return head + tiles * PLANE_TILE_BYTES


def _results(device: torch.device) -> torch.Tensor:
    """The card's [kept, replaced] count of ``device`` (made at first use
    after a reset)."""
    counts = masked_similarity.results
    if device not in counts:
        counts[device] = torch.zeros(2, dtype=torch.int32, device=device)
    return counts[device]


def route_results() -> dict:
    """Tensor-core calls since the last reset: ``tensor_core`` kept their
    result, ``f32_fallback`` had it replaced by the f32 route because a
    value failed the guard. Synchronizes."""
    kept = replaced = 0
    for t in masked_similarity.results.values():
        kept_t, replaced_t = t.tolist()
        kept, replaced = kept + kept_t, replaced + replaced_t
    return {"tensor_core": kept, "f32_fallback": replaced}


def masked_similarity(r_a: torch.Tensor, r_b: torch.Tensor,
                      measure: str = "cosine", route: str = "auto"
                      ) -> torch.Tensor:
    """Co-rated similarity (A, B) of ``r_a (A, P)`` against ``r_b (B, P)``.

    CUDA tensors go through the kernels (contiguous float32 on one device,
    else ValueError): ``route`` "auto" (the tensor-core route while
    P <= :data:`MAX_ITEMS`, else the f32 route) or "f32". CPU tensors take
    the plain version. Meta tensors take neither: the output (and the
    route's scratch) on ``meta``, the call's cost charged
    (``kernels/cost.py``).
    """
    if route not in ROUTES:
        raise ValueError(f"masked_similarity: route {route!r} not in "
                         f"{ROUTES}")
    if r_a.device.type == "cpu" and r_b.device.type == "cpu":
        return ref.masked_similarity_ref(r_a, r_b, measure)
    meta = build.on_meta("masked_similarity", r_a, r_b)
    build.check_cuda_f32("masked_similarity", r_a, r_b)
    if measure not in build.MEASURE_CODES:
        raise ValueError(f"unknown measure {measure!r}")
    if r_a.shape[1] != r_b.shape[1]:
        raise ValueError(f"item axes differ: {r_a.shape} vs {r_b.shape}")
    a, p = r_a.shape
    b = r_b.shape[0]
    out = torch.empty((a, b), dtype=torch.float32, device=r_a.device)
    if a and b:
        code = build.MEASURE_CODES[measure]
        tc = route != "f32" and p <= MAX_ITEMS
        if tc:
            ws = torch.empty(_workspace_bytes(a, b, p), dtype=torch.uint8,
                             device=r_a.device)
        if tc and not meta:
            build.launch("masked_similarity_tc", r_a, r_b, out, ws,
                         _results(r_a.device), a, b, p, code)
        elif not meta:
            build.launch("masked_similarity_f32", r_a, r_b, out, a, b, p,
                         code)
        if not meta:
            masked_similarity.route_launches[
                "tensor_core" if tc else "f32"] += 1
            build.count_launch(masked_similarity)
        cost.charge("masked_similarity",
                    lambda: cost.masked_similarity(a, b, p, tc))
    return out


masked_similarity.launches = 0
masked_similarity.route_launches = {"tensor_core": 0, "f32": 0}
# device → int32 [kept, replaced] on the card (see route_results)
masked_similarity.results = {}
