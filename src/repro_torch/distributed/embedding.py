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

A DTensor table (a model laid over a ``torch.distributed`` mesh of ranks
by the logical-axis rules, ``"rows"`` over ``model``) takes the same
route on each rank's own blocks (:func:`_mesh_lookups`): the ids are
placed over the batch axes and replicated over ``model`` (the
reference's ``id_spec``; replicated everywhere when the batch does not
divide them), each rank gathers the ids of its row range through
:func:`_gather` (its backward the fixed-order segment sum over the rank's
own CSR), and the partial rows are summed over ``model`` (the
reference's ``psum``; bitwise the plain lookup, as above). Each rank's
table gradient is then a partial sum over the batch axes, all-reduced
over them where the optimizer reads it.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..core.topk import canonical_topk
from ..kernels import ops  # noqa: F401  (first: it imports every wrapper)
from ..kernels.segment_sum import CSR, build_csr, gather
from .sharding import mesh_axes, mesh_dims, ordered_sum, shard_devices

ROW_AXIS = "model"  # the mesh axis a table's rows are sharded over
BATCH_AXES = ("pod", "data")  # the mesh axes the ids are split over


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


def _row_check(rows: int, n_shards: int) -> None:
    if rows % n_shards != 0:
        raise ValueError(
            f"table rows {rows} must divide the '{ROW_AXIS}' axis "
            f"({n_shards}); pad the table (configs use round_up(·, 512)).")


def _mesh_lookups(tables: Sequence[DTensor], ids: torch.Tensor
                  ) -> Tuple[DTensor, ...]:
    """Each DTensor table's rows at ``ids`` over the tables' mesh of
    ranks (the tables share one mesh, one row count and one CSR): the
    reference's ``shard_map`` of ``_local_lookup``, as ``local_map``."""
    from torch.distributed.tensor.experimental import local_map

    dm = tables[0].device_mesh
    dims, sizes = mesh_dims(dm), mesh_axes(dm)
    row_dim = dims.get(ROW_AXIS)
    if row_dim is not None:
        _row_check(tables[0].shape[0], sizes[ROW_AXIS])
    batch_dims = {dims[a] for a in BATCH_AXES if a in dims}
    n_b = 1
    for d in batch_dims:
        n_b *= dm.mesh.shape[d]
    # batch-1 / ragged: the ids replicated
    split = n_b > 1 and ids.ndim > 0 and ids.shape[0] % n_b == 0
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, dm, [Replicate()] * dm.ndim,
                                 run_check=False)

    def pl(batch, rows):
        return tuple(rows if d == row_dim else batch
                     if split and d in batch_dims else Replicate()
                     for d in range(dm.ndim))

    table_pl = pl(Replicate(), Shard(0))
    grad_pl = pl(Partial(), Shard(0))
    ids_pl = pl(Shard(0), Replicate())
    out_pl = pl(Shard(0), Partial())
    coord = 0 if row_dim is None else dm.get_local_rank(row_dim)

    def local(*args):
        *shards, idx = args
        size = shards[0].shape[0]
        rel = idx - coord * size
        ok = (rel >= 0) & (rel < size) & (idx >= 0)
        rel = torch.where(ok, rel, -1)
        csr = (lookup_csr(rel, size) if torch.is_grad_enabled()
               and any(t.requires_grad for t in shards) else None)
        return tuple(_gather(t, rel, csr) for t in shards)

    outs = local_map(local, out_placements=(out_pl,) * len(tables),
                     in_placements=(table_pl,) * len(tables) + (ids_pl,),
                     in_grad_placements=(grad_pl,) * len(tables) + (ids_pl,),
                     device_mesh=dm, redistribute_inputs=True)(*tables, ids)
    # the psum over model: one shard gives each row, the others +0
    return tuple(o.redistribute(dm, pl(Shard(0), Replicate())) for o in outs)


def embedding_lookups(tables: Sequence[torch.Tensor], ids: torch.Tensor,
                      mesh=None) -> Tuple[torch.Tensor, ...]:
    """:func:`embedding_lookup` of several tables of one row count at the
    same ``ids`` (FM's ``v`` and ``w``): one CSR serves every table's
    backward, in the plain form and on a mesh of ranks."""
    if isinstance(tables[0], DTensor):
        return _mesh_lookups(tables, ids)
    if mesh is not None and ROW_AXIS in mesh.axis_names:
        return tuple(embedding_lookup(t, ids, mesh) for t in tables)
    csr = (lookup_csr(ids, tables[0].shape[0]) if torch.is_grad_enabled()
           and any(t.requires_grad for t in tables) else None)
    return tuple(_gather(t, ids, csr) for t in tables)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor, mesh=None,
                     csr: Optional[CSR] = None) -> torch.Tensor:
    """Gather rows of ``table (V, D)`` at ``ids`` (any shape, int, -1 =
    padding, which gives zeros). Output ``ids.shape + (D,)``. ``csr``, a
    :func:`lookup_csr` of the same ids, is reused instead of built (the
    plain form only). The reference's ``batch_axes`` only place the ids
    over the batch shards, which one device does not have; a DTensor
    table is looked up over its mesh of ranks (:func:`_mesh_lookups`)."""
    if isinstance(table, DTensor):
        return _mesh_lookups((table,), ids)[0]
    if mesh is None or ROW_AXIS not in mesh.axis_names:
        return _gather(table, ids, csr)
    n_shards = mesh.shape[ROW_AXIS]
    _row_check(table.shape[0], n_shards)
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


def distributed_topk(scores: torch.Tensor, k: int,
                     n_valid: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last dim in ``lax.top_k``'s order: value descending,
    ties to the lowest id (``core/topk.py::canonical_topk``); ids at or
    past ``n_valid`` (a table's padding rows) score -inf. Returns
    ``(values, ids)``, ids int64.

    A DTensor whose last dim is split over mesh dims (scores against a
    row-sharded table) is reduced in two stages: each rank's top k of its
    block with global ids, the candidates gathered in shard order, then
    their top k. Shard order is id order, so the lowest position among
    equal values is the lowest id: the one-device result."""
    if not isinstance(scores, DTensor):
        return canonical_topk(_masked(scores, 0, n_valid), k)
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    from torch.distributed.tensor.experimental import local_map

    dm = scores.device_mesh
    if any(isinstance(p, Partial) for p in scores.placements):  # summed
        scores = scores.redistribute(dm, [
            Replicate() if isinstance(p, Partial) else p
            for p in scores.placements])
    pls = tuple(scores.placements)
    last = scores.ndim - 1
    split = [isinstance(p, Shard) and p.dim % scores.ndim == last
             for p in pls]
    _, off = compute_local_shape_and_global_offset(scores.shape, dm, pls)

    def local(s):
        ids = torch.arange(s.shape[-1], device=s.device) + off[-1]
        v, i = canonical_topk(_masked(s, off[-1], n_valid),
                              min(k, s.shape[-1]))
        return v, ids[i]

    v, i = local_map(local, out_placements=(pls, pls), in_placements=(pls,),
                     device_mesh=dm)(scores)
    whole = tuple(Replicate() if sp else p for sp, p in zip(split, pls))
    v, i = v.redistribute(dm, whole), i.redistribute(dm, whole)

    def merge(v, i):
        vals, pos = canonical_topk(v, k)
        return vals, i.gather(-1, pos)

    return local_map(merge, out_placements=(whole, whole),
                     in_placements=(whole, whole), device_mesh=dm)(v, i)


def _masked(scores: torch.Tensor, offset: int, n_valid: Optional[int]
            ) -> torch.Tensor:
    """Scores of ids ``offset + j`` at or past ``n_valid`` set to -inf."""
    if n_valid is None:
        return scores
    ids = torch.arange(scores.shape[-1], device=scores.device) + offset
    return torch.where(ids < n_valid, scores,
                       scores.new_full((), float("-inf")))
