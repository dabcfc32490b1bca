"""Wrapper of the fused IVF probe CUDA kernel (``csrc/ivf_probe.cu``): per
query, gather its probed posting-list blocks, dequantize, score with the
``dense_similarity`` algebra and keep the canonical top-k, without the
(b, nprobe·cap, n) candidate tensor ever reaching device memory.

The kernel's block owns ``G`` queries that share cells: the call orders
the queries by their first-probed (nearest) cell on the card and the
wrapper picks ``G`` from the batch size (:func:`plan_group`), so each cell
of a group's union is staged once per block. The order and ``G`` change
which rows a block visits, never the result: the lists are canonical and
each id lies in one list. Past ``NARROW_WIDTH`` landmarks the kernel's wide
route takes one query a block and stages rows in slices of the landmark
axis.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from . import build, ref
from .knn_topk import MAX_K, NARROW_WIDTH, check_width

PAYLOAD_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
GROUPS = (8, 4, 2)  # queries a block may own besides 1 (8 warps a block)
ORDER_MAX_CELLS = 32768  # cells the kernel's counting sort holds


def plan_group(b: int, sms: int, cells: int = 1) -> int:
    """Queries per block: the largest of 8, 4, 2 whose grid still gives
    every one of ``sms`` SMs two blocks, else 1 (the block's 8 warps then
    split one query's rows and merge their lists). Grouping needs the
    queries ordered by cell, for at most ``ORDER_MAX_CELLS`` cells."""
    if cells > ORDER_MAX_CELLS:
        return 1
    return next((g for g in GROUPS if -(-b // g) >= 2 * sms), 1)


def group_order(probe: torch.Tensor, group: int) -> Optional[torch.Tensor]:
    """The order in which blocks take the queries: by first-probed cell, so
    neighbouring queries probe overlapping cells; None (the queries' own
    order) when a block owns one query. This is the plain version of the
    kernel's counting sort, stable where the kernel's atomics leave the
    order within a cell open."""
    return None if group == 1 else torch.argsort(probe[:, 0], stable=True)


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_probe_topk(q: torch.Tensor, probe: torch.Tensor,
                     lists: torch.Tensor, rows: torch.Tensor,
                     scale: Optional[torch.Tensor], fill: torch.Tensor, *,
                     k: int, measure: str = "cosine",
                     self_ids: Optional[torch.Tensor] = None,
                     probe_ok: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(vals, ids), each (b, k): top-k candidates per query over its probed
    posting lists, in canonical order (value desc, id asc), empty slots
    (-inf, 0).

    ``q (b, n)`` f32 query rows; ``probe (b, nprobe)`` distinct cells per
    query; ``lists (C, cap)`` ids; ``rows (C, cap, n)`` f32, bf16 or int8
    payloads; ``scale (C, cap)`` f32 for int8 rows, else None; ``fill (C,)``
    live slots per cell; ``self_ids (b,)`` an id each query never lists (-1:
    none); ``probe_ok (b, nprobe)``, False/0 skips that probe. CUDA tensors
    go through the kernel (else ValueError); CPU tensors take the plain
    version.
    """
    if all(t.device.type == "cpu" for t in (q, probe, lists, rows, fill)):
        return ref.fused_probe_topk_ref(
            q, probe, lists, rows, scale, fill, k=k, measure=measure,
            self_ids=self_ids, probe_ok=probe_ok)
    build.check_cuda_f32("fused_probe_topk", q)
    dev = q.device
    b, n = q.shape
    c, cap = lists.shape
    nprobe = probe.shape[1] if probe.dim() == 2 else -1
    i32 = (torch.int32,)
    build.check_cuda("fused_probe_topk probe", probe, 2, i32, dev)
    build.check_cuda("fused_probe_topk lists", lists, 2, i32, dev)
    build.check_cuda("fused_probe_topk rows", rows, 3, tuple(PAYLOAD_CODES),
                     dev)
    build.check_cuda("fused_probe_topk fill", fill, 1, i32, dev)
    if rows.dtype == torch.int8:
        if scale is None:
            raise ValueError("fused_probe_topk: int8 rows need their scales")
        build.check_cuda("fused_probe_topk scale", scale, 2, (torch.float32,),
                         dev)
        if tuple(scale.shape) != (c, cap):
            raise ValueError(f"fused_probe_topk: scale {tuple(scale.shape)} "
                             f"!= lists {(c, cap)}")
    elif scale is not None:
        raise ValueError("fused_probe_topk: scales go with int8 rows only")
    if (probe.shape[0] != b or tuple(rows.shape) != (c, cap, n)
            or fill.shape[0] != c):
        raise ValueError(
            f"fused_probe_topk: shapes disagree: q {tuple(q.shape)}, probe "
            f"{tuple(probe.shape)}, lists {(c, cap)}, rows "
            f"{tuple(rows.shape)}, fill {tuple(fill.shape)}")
    check_width("fused_probe_topk", n)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"fused_probe_topk: k={k} outside 1..{MAX_K}")
    if measure not in build.MEASURE_CODES:
        raise ValueError(f"unknown measure {measure!r}")
    if self_ids is not None:
        self_ids = self_ids.to(torch.int32).contiguous()
        build.check_cuda("fused_probe_topk self_ids", self_ids, 1, i32, dev)
        if self_ids.shape[0] != b:
            raise ValueError("fused_probe_topk: self_ids/probe_ok shapes")
    if probe_ok is not None:
        probe_ok = probe_ok.to(torch.int32).contiguous()
        build.check_cuda("fused_probe_topk probe_ok", probe_ok, 2, i32, dev)
        if tuple(probe_ok.shape) != (b, nprobe):
            raise ValueError("fused_probe_topk: self_ids/probe_ok shapes")
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b and nprobe and c and cap:
        # the wide route (past NARROW_WIDTH) takes one query a block
        group = 1 if n > NARROW_WIDTH else plan_group(
            b, _sms(dev.index if dev.index is not None
                    else torch.cuda.current_device()), c)
        order = (None if group == 1
                 else torch.empty(b, dtype=torch.int32, device=dev))
        build.launch("ivf_probe_f32", q, probe, probe_ok, order, lists, rows,
                     scale, fill, self_ids, vals, ids, b, nprobe, c, cap, n,
                     k, build.MEASURE_CODES[measure],
                     PAYLOAD_CODES[rows.dtype], group)
        build.count_launch(fused_probe_topk)
    else:
        vals.fill_(float("-inf"))
        ids.zero_()
    return vals, ids


fused_probe_topk.launches = 0
