"""CF row-block sharding over a :class:`~repro_torch.launch.mesh.Mesh`.

The serving artifact block-partitions user rows over the mesh's row axes:
shard s (the linear index over ``axes``, last axis fastest, the
linearization of ``core.similarity.streaming_knn_graph_sharded``) owns rows
``[s*C, (s+1)*C)`` of every row-indexed array, where C is the per-shard
bucket capacity (``lifecycle.buckets``). A *sharded row id* is
``s * C + slot``; a fitted state's contiguous *dense* ids map through
:func:`dense_to_sharded_ids` (shard = id // u_per, slot = id % u_per with
u_per = ceil(U / S)).

In the port a row-sharded array is a list of S blocks, block s a (C, ...)
tensor on ``shard_devices(mesh, axes)[s]``. No function here builds a
tensor of S·C rows. The two collectives are explicit and ordered, so their
results do not depend on where the shards live: :func:`all_gather_rows`
concatenates blocks in linear shard order, :func:`ordered_sum` adds in
that order. Each, and :func:`gather_rows`, adds its bytes to the open cost
tallies (``kernels/cost.py::collective``): the dry run's collectives. (The reference's GSPMD logical-axis rules serve its LM and
training paths and wait for them.) :func:`constrain` and
:func:`shard_batch_full`, the recsys models' sharding annotations, are
identities here.
"""
from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..kernels import cost

Blocks = List[torch.Tensor]


def cf_row_axes(mesh, row_axes=("pod", "data")) -> Tuple[str, ...]:
    """The subset of ``row_axes`` that exists on ``mesh`` (order kept)."""
    return tuple(a for a in row_axes if a in mesh.axis_names)


def cf_shard_count(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def shard_linear_index(mesh, axes, coords) -> int:
    """The linear index over ``axes`` of the mesh position at ``coords``
    (axis name -> index)."""
    lin = 0
    for a in axes:
        lin = lin * mesh.shape[a] + int(coords[a])
    return lin


def shard_devices(mesh, axes) -> Tuple[torch.device, ...]:
    """The device of each row shard: shard s sits at the mesh position
    whose ``axes`` coordinates linearize to s and whose other coordinates
    are 0 (a row shard is replicated over the other axes)."""
    out = []
    for s in range(cf_shard_count(mesh, axes)):
        coords, rest = {}, s
        for a in reversed(axes):
            coords[a] = rest % mesh.shape[a]
            rest //= mesh.shape[a]
        pos = 0
        for a, size in zip(mesh.axis_names, mesh.sizes):
            pos = pos * size + coords.get(a, 0)
        out.append(mesh.devices[pos])
    return tuple(out)


def dense_to_sharded_ids(ids, u_per: int, capacity: int):
    """Map contiguous fitted row ids to the block-partitioned id space."""
    return (ids // u_per) * capacity + ids % u_per


def remap_block_ids(ids, old_capacity: int, new_capacity: int):
    """Re-express sharded row ids after a per-shard capacity regrow."""
    return (ids // old_capacity) * new_capacity + ids % old_capacity


def pack_row_blocks(x, n_shards: int, u_per: int, capacity: int,
                    devices: Sequence[torch.device]) -> Blocks:
    """(U, ...) dense rows -> S zero-padded (C, ...) blocks, block s holding
    rows ``[s*u_per, (s+1)*u_per)`` on ``devices[s]``."""
    x = torch.as_tensor(x)
    u = x.shape[0]
    out = []
    for s in range(n_shards):
        lo, hi = min(s * u_per, u), min((s + 1) * u_per, u)
        blk = x.new_zeros((capacity,) + tuple(x.shape[1:]),
                          device=devices[s])
        blk[:hi - lo] = x[lo:hi].to(devices[s])
        out.append(blk)
    return out


def repack_row_blocks(blocks: Blocks, new_capacity: int) -> Blocks:
    """Grow every block from C_old to ``new_capacity`` rows, zero-padded,
    each on its own device (the reference's ``repack_row_blocks_device``:
    the payload never leaves its shard)."""
    out = []
    for b in blocks:
        if new_capacity < b.shape[0]:
            raise ValueError(f"capacity shrinks: {b.shape[0]} -> "
                             f"{new_capacity}")
        grown = b.new_zeros((new_capacity,) + tuple(b.shape[1:]))
        grown[:b.shape[0]] = b
        out.append(grown)
    return out


def shard_local_append(blocks: Blocks, rows: torch.Tensor,
                       n_valid: Sequence[int], target: int) -> Blocks:
    """Write ``rows`` into block ``target`` at its fill offset
    ``n_valid[target]``, in place — the shard-local append of the sharded
    fold-in. Other blocks are untouched; the caller guarantees the room
    (``lifecycle.buckets.ensure_capacity_sharded``)."""
    at = int(n_valid[target])
    blk = blocks[target]
    if at + rows.shape[0] > blk.shape[0]:
        raise ValueError(f"shard {target}: {at} + {rows.shape[0]} rows "
                         f"exceed capacity {blk.shape[0]}")
    blk[at:at + rows.shape[0]] = rows.to(device=blk.device, dtype=blk.dtype)
    return blocks


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather_rows(blocks: Blocks, dst) -> torch.Tensor:
    """The all-gather: every block's rows concatenated on ``dst`` in linear
    shard order."""
    cost.collective("all-gather", sum(map(_nbytes, blocks)))
    return torch.cat([b.to(dst) for b in blocks])


def ordered_sum(values: Sequence[torch.Tensor], dst) -> torch.Tensor:
    """The reduction: the shards' values added on ``dst`` in linear shard
    order (a fixed order, so the result is the same bits wherever the
    shards live)."""
    cost.collective("all-reduce", _nbytes(values[0]))
    total = values[0].to(dst)
    for v in values[1:]:
        total = total + v.to(dst)
    return total


def gather_rows(blocks: Blocks, ids, capacity: int, dst) -> torch.Tensor:
    """(len(ids), ...) rows named by sharded ``ids``, each read from its
    owner shard and gathered on ``dst`` in the order of ``ids``. The ids are
    read on the host once; a shard reads only the rows named on it."""
    ids_h = np.asarray(torch.as_tensor(ids).cpu(), dtype=np.int64).ravel()
    owner, slot = ids_h // capacity, ids_h % capacity
    if len(ids_h) and (owner.min() < 0 or owner.max() >= len(blocks)):
        raise IndexError(f"sharded ids outside {len(blocks)} shards of "
                         f"capacity {capacity}")
    out = blocks[0].new_empty((len(ids_h),) + tuple(blocks[0].shape[1:]),
                              device=dst)
    cost.collective("all-to-all", _nbytes(out))
    for s, blk in enumerate(blocks):
        pos = np.nonzero(owner == s)[0]
        if len(pos):
            rows = blk[torch.as_tensor(slot[pos], device=blk.device)]
            out[torch.as_tensor(pos, device=out.device)] = rows.to(dst)
    return out


def constrain(x: torch.Tensor, logical=None, rules=None, mesh=None
              ) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical axes. It is
    a no-op outside a mesh context there; the port places every tensor of a
    model on its one device and has no such context, so ``x`` is returned
    as it is. The logical-axis layer waits for the multi-process launcher
    (ROADMAP queue 1, item 4)."""
    return x


def shard_batch_full(x: torch.Tensor, mesh=None, axis: int = 0
                     ) -> torch.Tensor:
    """The reference's constraint of dim ``axis`` over every mesh axis (a
    recsys batch split over all chips). A sharding constraint moves no
    value, and the port's recsys models run on one device, so ``x`` is
    returned as it is."""
    return x


def materializations(run: Callable[[], object],
                     is_bad: Callable[[Tuple[int, ...]], bool]):
    """Run ``run()`` under a dispatch mode that sees every tensor an aten
    op returns; ``(n_tensors_scanned, offenders)`` where ``is_bad(shape)``
    names an offending shape. The proofs that a sharded path never builds
    a row-space tensor (the fold-in, the query router, the write path) are
    made with it. The kernels' own launches are no aten ops, but every
    buffer they write is allocated through one."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    seen, bad = [], []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    shp = tuple(t.shape)
                    seen.append(shp)
                    if is_bad(shp):
                        bad.append((str(func), shp))
            return out

    with Watch():
        run()
    return len(seen), bad
