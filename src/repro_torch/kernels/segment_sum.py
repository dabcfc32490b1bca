"""Wrapper of the fixed-order CSR segment-sum CUDA kernel
(``csrc/segment_sum.cu``) and the two autograd Functions the GNN's message
passing runs on.

A :class:`CSR` lists the live edges of one index (``edge_dst``,
``edge_src`` or ``graph_ids``) grouped by segment: ``perm`` a stable
argsort of the index over the live edges, ``indptr`` the segments' bounds.
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


@dataclasses.dataclass(frozen=True)
class CSR:
    """The live edges of one (E,) index grouped into N segments."""

    index: torch.Tensor  # (E,) int64: every edge's segment
    live: Optional[torch.Tensor]  # (E,) bool, or None when every edge is
    perm: torch.Tensor  # (E_live,) int32: live edges by segment, stable
    indptr: torch.Tensor  # (N + 1,) int32: segment n is perm[indptr[n]:…]
    n: int  # segments

    @property
    def n_edges(self) -> int:
        return self.index.shape[0]


def build_csr(index: torch.Tensor, n: int,
              mask: Optional[torch.Tensor] = None) -> CSR:
    """The CSR of ``index`` (E,) over ``n`` segments, on its device; edges
    where ``mask`` (E,) is 0 are left out. Every index of a live edge must
    lie in [0, n). One host sync (whether any edge is masked)."""
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
    return CSR(idx, live, perm[:n_live].to(torch.int32).contiguous(),
               indptr, n)


def segment_sum(x: torch.Tensor, csr: CSR) -> torch.Tensor:
    """(N, H) segment sums of ``x (E, H)`` in the CSR's fixed order.

    CUDA tensors go through the kernel (contiguous 2-D f32 or bf16 on the
    CSR's device, else ValueError); CPU tensors take the plain version.
    """
    if x.device.type == "cpu":
        return ref.segment_sum_ref(x, csr.perm, csr.indptr)
    build.check_cuda("segment_sum", x, 2, tuple(DTYPES), x.device)
    for name, t in (("perm", csr.perm), ("indptr", csr.indptr)):
        build.check_cuda(f"segment_sum {name}", t, 1, (torch.int32,),
                         x.device)
    if x.shape[0] != csr.n_edges:
        raise ValueError(f"segment_sum: {x.shape[0]} rows for a CSR of "
                         f"{csr.n_edges} edges")
    h = x.shape[1]
    out = torch.empty((csr.n, h), dtype=x.dtype, device=x.device)
    if csr.n and h:
        build.launch(DTYPES[x.dtype], x, csr.perm, csr.indptr, out, csr.n, h)
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
