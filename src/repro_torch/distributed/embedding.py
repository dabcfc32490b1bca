"""Embedding lookups of the recsys models, the reference's
``repro.distributed.embedding`` in PyTorch.

The reference gathers with ``jnp.take`` and a padding mask; its gradient
is XLA's scatter-add. Here a lookup that needs a gradient gathers through
``kernels/segment_sum.py::gather`` over a CSR of its ids: the forward is
``index_select``, the backward the fixed-order segment sum (the kernel on
a CUDA tensor, ``ref.segment_sum_ref`` on a CPU one), not autograd's
``index_add_``, whose atomics add in a different order from run to run.
Padding ids (-1) are masked out of the CSR: their rows are set to zero
after the gather, so their gradient is an exact zero and leaving them out
changes no bit. A lookup that needs no gradient (serving, or a table that
does not require one) builds no CSR and gathers with ``index_select``
alone: the same values.

With a mesh that has a ``model`` axis, the table is split into row shards
as the reference's ``shard_map`` splits it (``_local_lookup``): shard s
gathers the ids in its row range, and the partials are added in shard
order (``sharding.ordered_sum``). Exactly one shard gives a row its
value and every other adds +0, so the result is the plain lookup's, bit
for bit. On the port's single-process mesh the shards are views of the
one table.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.topk import canonical_topk
from ..kernels import ops  # noqa: F401  (first: it imports every wrapper)
from ..kernels.segment_sum import CSR, build_csr, gather
from .sharding import ordered_sum, shard_devices

ROW_AXIS = "model"  # the mesh axis a table's rows are sharded over


def lookup_csr(ids: torch.Tensor, n_rows: int) -> CSR:
    """The CSR of a lookup's ids over the table's ``n_rows`` rows, padding
    ids (< 0) left out: the backward of :func:`embedding_lookup`. Tables
    that take the same ids (FM's ``v`` and ``w``) can share one."""
    flat = ids.reshape(-1)
    return build_csr(flat.clamp(min=0), n_rows, mask=flat >= 0)


def _gather(table: torch.Tensor, ids: torch.Tensor,
            csr: Optional[CSR]) -> torch.Tensor:
    """Rows ``table[ids]``, padding ids (< 0) zero; shape ids.shape + (D,)."""
    ok = ids >= 0
    if torch.is_grad_enabled() and table.requires_grad:
        csr = csr if csr is not None else lookup_csr(ids, table.shape[0])
        rows = gather(table, csr)
    else:
        rows = table.index_select(0, ids.reshape(-1).clamp(min=0))
    rows = rows.reshape(*ids.shape, table.shape[1])
    return torch.where(ok[..., None], rows, rows.new_zeros(()))


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor, mesh=None,
                     csr: Optional[CSR] = None) -> torch.Tensor:
    """Gather rows of ``table (V, D)`` at ``ids`` (any shape, int, -1 =
    padding, which gives zeros). Output ``ids.shape + (D,)``. ``csr``, a
    :func:`lookup_csr` of the same ids, is reused instead of built (the
    plain form only). The reference's ``batch_axes`` only place the ids
    over the batch shards, which one device does not have."""
    if mesh is None or ROW_AXIS not in mesh.axis_names:
        return _gather(table, ids, csr)
    n_shards = mesh.shape[ROW_AXIS]
    if table.shape[0] % n_shards != 0:
        raise ValueError(
            f"table rows {table.shape[0]} must divide the '{ROW_AXIS}' axis "
            f"({n_shards}); pad the table (configs use round_up(·, 512)).")
    size = table.shape[0] // n_shards
    parts = []
    for s, dev in enumerate(shard_devices(mesh, (ROW_AXIS,))):
        local = ids.to(dev) - s * size
        ok = (local >= 0) & (local < size) & (ids.to(dev) >= 0)
        parts.append(_gather(table[s * size:(s + 1) * size].to(dev),
                             torch.where(ok, local, -1), None))
    return ordered_sum(parts, ids.device)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mode: str = "sum",
                  weights: Optional[torch.Tensor] = None, mesh=None
                  ) -> torch.Tensor:
    """EmbeddingBag (sum | mean) over the bag dim of ``ids (B, F)``, -1
    padding, with optional per-id ``weights (B, F)``."""
    emb = embedding_lookup(table, ids, mesh)  # (B, F, D)
    m = (ids >= 0).to(emb.dtype)[..., None]
    if weights is not None:
        m = m * weights[..., None]
    s = (emb * m).sum(dim=-2)
    if mode == "sum":
        return s
    return s / torch.clamp_min(m.sum(dim=-2), 1.0)


def distributed_topk(scores: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last dim in ``lax.top_k``'s order: value descending,
    ties to the lowest id (``core/topk.py::canonical_topk``). Returns
    ``(values, ids)``, ids int64."""
    return canonical_topk(scores, k)
