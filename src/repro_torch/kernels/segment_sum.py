"""Wrapper of the fixed-order CSR segment-sum CUDA kernel
(``csrc/segment_sum.cu``) and the two autograd Functions the GNN's message
passing runs on.

A :class:`CSR` lists the live edges of one index (``edge_dst``,
``edge_src`` or ``graph_ids``) grouped by segment: ``perm`` a stable
argsort of the index over the live edges, ``indptr`` the segments' bounds,
and the kernel's schedule (``chunk_rows``: the rows each warp walks,
about :func:`chunk_size` rows + edges a chunk; ``heavy_rows``: the
segments of more than ``HEAVY`` members, longest first, each cut into
units of a 16-byte slice of channels, or 4 bytes past ``HUGE`` members,
a warp a unit).
It is built once per batch and reused by every layer and the backward.
Edges whose mask is 0 belong to no segment: the GNN multiplies every
message of a padded edge by its mask, so its terms are exact zeros, and a
fixed-order sum that starts from +0 is never -0, so leaving them out
changes no bit — and spares a padded batch's node 0 a serial chain of
every pad edge (115,571 of minibatch_lg's 169,984 edges).

- :func:`segment_sum` ``(x (E, H), csr) -> (N, H)``: the kernel on a CUDA
  tensor (f32 or bf16), its plain version ``ref.segment_sum_ref`` on a CPU
  one; the same adds in the same order, so the two agree bitwise.
- :class:`SegmentSum` — forward :func:`segment_sum`, backward the gather
  ``grad[index]`` (0 at masked edges): its exact adjoint.
- :class:`Gather` — forward ``x[index]`` at every edge, as the reference
  gathers; backward ``segment_sum(grad, csr)`` over the live edges, not
  autograd's ``index_add_`` with atomics. That is the adjoint of the
  gather wherever a masked edge's gradient is 0, as it is in the GNN:
  every use of a masked edge's row meets its mask 0 (the gate and the
  message are multiplied by it; the edge state it feeds reaches no
  output), so its gradient is an exact zero and leaving it out changes no
  bit.

A training step on the two adds no float in an order that changes from
run to run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import build, ref

DTYPES = {torch.float32: "segment_sum_f32", torch.bfloat16: "segment_sum_bf16"}
# the kernel's schedule (csrc/segment_sum.cu): a warp walks a chunk of
# rows holding about `chunk_size` rows + edges; a segment of more than
# HEAVY members is left to its heavy units, a 16-byte slice of its
# channels each (csrc kSlot), 4 bytes (kSlotHuge) for a segment of more
# than HUGE members
HEAVY = 64
HUGE = 4096
# CHUNK rows + edges a chunk while that leaves SPREAD chunks or more, else
# halved down to CHUNK_MIN: a small CSR spreads over more, shorter chunks
# (NVIDIA H100 80GB HBM3, 700.00 W, tools/time_segment_sum.py, f32: the
# molecule CSR by destination 0.0059 ms device at 32, 0.0044 at 8;
# minibatch_lg's 0.0263 at 32, 0.0334 at 8); doubled up to CHUNK_MAX while
# that still leaves 2 · FILL chunks or more: a CSR of millions of rows
# (FM's by field id, 41.7 M) gives each warp a window of rows whose bounds
# it loads at once, instead of a warp for every 32 rows
CHUNK, CHUNK_MIN, SPREAD = 32, 8, 4096
CHUNK_MAX, FILL = 1024, 32768


def chunk_size(n: int, n_live: int) -> int:
    """Rows + edges a warp's chunk holds for a CSR of ``n`` segments and
    ``n_live`` edges."""
    chunk = CHUNK
    while chunk > CHUNK_MIN and n + n_live < chunk * SPREAD:
        chunk //= 2
    while chunk < CHUNK_MAX and n + n_live >= 2 * chunk * FILL:
        chunk *= 2
    return chunk


@dataclasses.dataclass(frozen=True)
class CSR:
    """The live edges of one (E,) index grouped into N segments."""

    index: torch.Tensor  # (E,) int64: every edge's segment
    live: Optional[torch.Tensor]  # (E,) bool, or None when every edge is
    perm: torch.Tensor  # (E_live,) int32: live edges by segment, stable
    indptr: torch.Tensor  # (N + 1,) int32: segment n is perm[indptr[n]:…]
    n: int  # segments
    # (n_chunks + 1,) int32: warp c walks rows chunk_rows[c]:chunk_rows[c+1]
    chunk_rows: torch.Tensor
    # (n_live // (HEAVY + 1),) int32: the segments of more than HEAVY
    # members, longest first (ties by index), then n for every unused slot
    heavy_rows: torch.Tensor
    # (1,) int32: how many of them have more than HUGE members (on the
    # device: the kernel reads it, the host never does)
    n_huge: torch.Tensor

    @property
    def n_edges(self) -> int:
        return self.index.shape[0]


def build_csr(index: torch.Tensor, n: int,
              mask: Optional[torch.Tensor] = None) -> CSR:
    """The CSR of ``index`` (E,) over ``n`` segments, on its device; edges
    where ``mask`` (E,) is 0 are left out. Every index of a live edge must
    lie in [0, n). One host sync (whether any edge is masked); the
    schedule's sizes are bounds the host knows from it.

    The schedule: a row costs 1, plus its members unless it is heavy (more
    than HEAVY members); with w = :func:`chunk_size`, warp c takes the rows
    whose cost prefix lies in [c·w, (c + 1)·w), so at most w rows and
    w + HEAVY edges. ``heavy_rows`` has n_live // (HEAVY + 1) slots, at
    least one for each heavy row, the longest first: their units start at
    the launch's start, the chains that set its length."""
    idx = index.long()
    if idx.numel() >= 2 ** 31:
        raise ValueError(f"build_csr: {idx.numel()} edges overflow the "
                         f"kernel's int32 edge ids")
    live = None if mask is None else mask != 0
    n_live = idx.numel() if live is None else int(live.sum())
    if n_live == idx.numel():
        live = None
    # masked edges go to a sentinel segment n, past every live one
    key = idx if live is None else torch.where(live, idx, n)
    perm = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=n + 1)[:n]
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=idx.device)
    indptr[1:] = torch.cumsum(counts, 0)
    heavy = counts > HEAVY
    prefix = torch.zeros(n + 1, dtype=torch.int64, device=idx.device)
    prefix[1:] = torch.cumsum(torch.where(heavy, 1, counts + 1), 0)
    chunk = chunk_size(n, n_live)
    n_chunks = -(-(n + n_live) // chunk)
    bounds = torch.arange(n_chunks + 1, device=idx.device) * chunk
    chunk_rows = torch.searchsorted(prefix, bounds).clamp_(max=n)
    slots = torch.arange(1, n_live // (HEAVY + 1) + 1, device=idx.device)
    heavy_rows = torch.searchsorted(torch.cumsum(heavy, 0), slots)
    members = torch.where(heavy_rows < n,
                          counts[heavy_rows.clamp(max=max(n - 1, 0))], -1)
    heavy_rows = heavy_rows[torch.sort(members, descending=True,
                                       stable=True).indices]
    n_huge = (counts > HUGE).sum().reshape(1).to(torch.int32)
    return CSR(idx, live, perm[:n_live].to(torch.int32).contiguous(),
               indptr, n, chunk_rows.to(torch.int32),
               heavy_rows.to(torch.int32), n_huge)


def segment_sum(x: torch.Tensor, csr: CSR) -> torch.Tensor:
    """(N, H) segment sums of ``x (E, H)`` in the CSR's fixed order.

    CUDA tensors go through the kernel (contiguous 2-D f32 or bf16 on the
    CSR's device, else ValueError); CPU tensors take the plain version.
    """
    if x.device.type == "cpu":
        return ref.segment_sum_ref(x, csr.perm, csr.indptr)
    build.check_cuda("segment_sum", x, 2, tuple(DTYPES), x.device)
    for name, t in (("perm", csr.perm), ("indptr", csr.indptr),
                    ("chunk_rows", csr.chunk_rows),
                    ("heavy_rows", csr.heavy_rows), ("n_huge", csr.n_huge)):
        build.check_cuda(f"segment_sum {name}", t, 1, (torch.int32,),
                         x.device)
    if x.shape[0] != csr.n_edges:
        raise ValueError(f"segment_sum: {x.shape[0]} rows for a CSR of "
                         f"{csr.n_edges} edges")
    h = x.shape[1]
    out = torch.empty((csr.n, h), dtype=x.dtype, device=x.device)
    if csr.n and h:
        build.launch(DTYPES[x.dtype], x, csr.perm, csr.indptr,
                     csr.chunk_rows, csr.heavy_rows, csr.n_huge, out, csr.n,
                     csr.perm.numel(), h, csr.chunk_rows.numel() - 1,
                     csr.heavy_rows.numel(), HEAVY)
        build.count_launch(segment_sum)
    return out


segment_sum.launches = 0


class SegmentSum(torch.autograd.Function):
    """``segment_sum(x, csr)``; its backward gathers ``grad[index]``."""

    @staticmethod
    def forward(ctx, x, csr):
        ctx.csr = csr
        return segment_sum(x.contiguous(), csr)

    @staticmethod
    def backward(ctx, grad):
        csr = ctx.csr
        rows = grad.index_select(0, csr.index)
        if csr.live is not None:
            rows = torch.where(csr.live[:, None], rows, rows.new_zeros(()))
        return rows, None


class Gather(torch.autograd.Function):
    """``x[index]``; its backward is the fixed-order ``segment_sum(grad,
    csr)`` over the live edges."""

    @staticmethod
    def forward(ctx, x, csr):
        ctx.csr = csr
        return x.index_select(0, csr.index)

    @staticmethod
    def backward(ctx, grad):
        return segment_sum(grad.contiguous(), ctx.csr), None


def seg_sum(x: torch.Tensor, csr: CSR) -> torch.Tensor:
    """Differentiable :func:`segment_sum` (:class:`SegmentSum`)."""
    return SegmentSum.apply(x, csr)


def gather(x: torch.Tensor, csr: CSR) -> torch.Tensor:
    """Differentiable ``x[csr.index]`` (:class:`Gather`)."""
    return Gather.apply(x, csr)
