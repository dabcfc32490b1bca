"""Sharding: the reference's logical-axis rules on DTensor, and CF
row-block sharding over a :class:`~repro_torch.launch.mesh.Mesh`
(``repro.distributed.sharding``).

**Logical axes.** Every parameter and activation declares a tuple of
*logical* axis names; a rules dict maps each name to mesh axes
(:data:`DEFAULT_RULES`, overridden per arch in ``configs/registry.py``).
:func:`spec_for` gives the reference's per-tensor-dim entries (its
``PartitionSpec``) as a plain tuple; :func:`placements` turns one into
DTensor placements over a ``torch.distributed`` ``DeviceMesh``
(``launch/mesh.py::device_mesh``): ``Shard(d)`` on each mesh dim that
names tensor dim d, ``Replicate()`` elsewhere. A tuple of axes shards one
tensor dim over those mesh dims in mesh order, JAX's major-to-minor order,
so mesh position (pod, data) holds block ``pod · |data| + data``. Where a
dim does not divide, DTensor gives the first ranks ceil-sized blocks, as a
padded JAX array would. :func:`constrain` and :func:`shard_batch_full`
redistribute a DTensor to a rule's placements (the reference's
``with_sharding_constraint``; DTensor emits the collective) and are the
identity on a plain tensor, the reference's no-op outside a mesh.

**CF row blocks.** The serving artifact block-partitions user rows over the mesh's row axes:
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
tallies (``kernels/cost.py::collective``): the dry run's collectives.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels import cost

Blocks = List[torch.Tensor]
LogicalAxes = Tuple[Optional[str], ...]

# Default rules; configs may override per arch.
DEFAULT_RULES: Dict[str, Any] = {
    "fsdp": ("pod", "data"),
    "tp": "model",
    "expert": "model",
    "batch": ("pod", "data"),
    "seq": "model",  # sequence-parallel residual: gathered at block entry
    "kv_seq": "model",
    "kv_seq_all": ("data", "model"),  # long-context batch 1: seq everywhere
    "edge": ("pod", "data", "model"),
    "rows": "model",
    "layers": None,
    "null": None,
    "vocab": "model",
}


# the reference's axes that a torch DeviceMesh holds as one mesh dim
MERGED = ("pod", "data")


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size (the reference's axes, ``pod`` and ``data`` apart
    where a ``DeviceMesh`` merges them) of a ``DeviceMesh``, of the port's
    single-process :class:`~repro_torch.launch.mesh.Mesh`, or of a
    ``{name: size}`` dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a torch DeviceMesh
        out = {}
        for name, size in zip(names, mesh.mesh.shape):
            parts = name.split("*")
            if len(parts) > 1:  # a merged dim: its axes' sizes
                out.update(getattr(mesh, "_merged_sizes")[name])
            else:
                out[name] = size
        return out
    return dict(mesh.shape)


def mesh_dims(mesh) -> Dict[str, int]:
    """Each reference axis's mesh dim in a ``DeviceMesh`` (``pod`` and
    ``data`` share one where they are merged); for a dict, its order."""
    names = getattr(mesh, "mesh_dim_names", None) or list(mesh_axes(mesh))
    return {a: i for i, name in enumerate(names) for a in name.split("*")}


def filter_rules(rules: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Drop mesh axes that don't exist (a single-pod mesh has no 'pod')."""
    names = set(mesh_axes(mesh))

    def fix(v):
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in names else None
        kept = tuple(a for a in v if a in names)
        return kept if kept else None

    return {k: fix(v) for k, v in rules.items()}


def spec_for(logical: LogicalAxes, rules: Dict[str, Any]) -> tuple:
    """The reference's ``PartitionSpec`` entries, one per tensor dim."""
    return tuple(rules.get(ax) if ax is not None else None for ax in logical)


def placements(spec: Sequence, device_mesh) -> tuple:
    """DTensor placements of ``spec`` over ``device_mesh``: ``Shard(d)`` on
    each mesh dim that names tensor dim d, ``Replicate()`` elsewhere. Axes
    the mesh lacks are dropped. A merged mesh dim (``pod*data``) shards a
    dim whose entry names both its axes, in order, as the two would; an
    entry naming one of them alone raises (:func:`splits_merged`: such a
    spec is placed on ``launch/mesh.py::apart(mesh)``)."""
    dims = mesh_dims(device_mesh)
    names = list(getattr(device_mesh, "mesh_dim_names", None) or dims)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in dims:
                continue
            i = dims[a]
            if not set(names[i].split("*")) <= set(axes):
                raise ValueError(
                    f"spec {tuple(spec)} names {a!r} without the rest of "
                    f"mesh dim {names[i]!r}: place it on "
                    f"launch/mesh.py::apart(mesh)")
            if out[i] == Shard(d):  # the merged dim's second axis
                continue
            if out[i] != Replicate():
                raise ValueError(f"spec {tuple(spec)} maps mesh axis {a!r} "
                                 f"to two dims")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec laid over a mesh (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: tuple

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The fullest rank's local shape: each dim over the product of
        its axes' sizes, rounded up (DTensor's first blocks)."""
        sizes = mesh_axes(self.mesh)
        out = []
        for d, n in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            k = math.prod(sizes[a] for a in axes if a in sizes)
            out.append(-(-n // k))
        return tuple(out)


def splits_merged(logical_tree, rules: Dict[str, Any], mesh) -> bool:
    """Whether a spec of ``logical_tree`` under ``rules`` names one axis
    of a merged mesh dim of ``mesh`` (``pod*data``) without the other,
    which :func:`placements` cannot place there."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    merged = [set(n.split("*")) for n in names if "*" in n]
    found = []

    def visit(la):
        for entry in spec_for(la, filter_rules(rules, mesh)):
            axes = set(() if entry is None else (entry,)
                       if isinstance(entry, str) else entry)
            found.extend(m for m in merged if axes & m and not m <= axes)
        return la

    tree_map_logical(visit, logical_tree)
    return bool(found)


def sharding_for(logical: LogicalAxes, mesh, rules: Dict[str, Any]
                 ) -> Sharding:
    return Sharding(mesh, spec_for(logical, filter_rules(rules, mesh)))


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_map_logical(fn: Callable, tree):
    """``fn`` over every logical-axes tuple of a dict/list tree."""
    if _is_logical(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_logical(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_logical(fn, v) for v in tree)
    raise TypeError(f"not a logical-axes tree leaf: {tree!r}")


def tree_shardings(logical_tree, mesh, rules: Dict[str, Any]):
    """A tree of logical-axes tuples as a tree of :class:`Sharding`."""
    rules = filter_rules(rules, mesh)
    return tree_map_logical(lambda la: Sharding(mesh, spec_for(la, rules)),
                            logical_tree)


def divisible(dim: int, axes, mesh) -> bool:
    """Can ``dim`` be sharded over ``axes`` of ``mesh``?"""
    if axes is None:
        return True
    axes = (axes,) if isinstance(axes, str) else axes
    sizes = mesh_axes(mesh)
    return dim % math.prod(sizes[a] for a in axes if a in sizes) == 0


def distribute(t: torch.Tensor, device_mesh, spec: Sequence) -> DTensor:
    """``t`` (the same whole tensor on every rank) as a DTensor of
    ``spec``'s placements: each rank keeps a copy of its own block, nothing
    is sent."""
    from torch.distributed.tensor import distribute_tensor

    pls = placements(spec, device_mesh)
    dt = distribute_tensor(t, device_mesh, pls, src_data_rank=None)
    # the block copied out: a view would keep the whole tensor's storage
    return DTensor.from_local(dt.to_local().clone(), device_mesh, pls,
                              run_check=False, shape=dt.shape,
                              stride=dt.stride())


def replicated_like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t``, the same on every rank, as a replicated DTensor on ``ref``'s
    mesh when ``ref`` is a DTensor; else ``t`` itself."""
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def constrain(x: torch.Tensor, logical: LogicalAxes, rules, mesh=None
              ) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical axes: a
    DTensor is redistributed to the rule's placements over its own mesh
    (DTensor issues the all-gather, reduce-scatter or all-to-all that
    GSPMD would insert); a plain tensor, or no rules, is returned as it
    is, the reference's no-op outside a mesh."""
    if not isinstance(x, DTensor) or rules is None:
        return x
    dm = x.device_mesh
    # redistributed even when already placed so: as JAX's constraint
    # binds the cotangent too, the gradient comes back in these placements
    return x.redistribute(
        dm, placements(spec_for(logical, filter_rules(rules, dm)), dm))


def shard_batch_full(x: torch.Tensor, mesh=None, axis: int = 0
                     ) -> torch.Tensor:
    """Dim ``axis`` of a DTensor over every mesh axis (a recsys batch split
    over all chips), where it divides; a plain tensor, or a dim that does
    not divide, is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    dm = x.device_mesh
    if x.shape[axis] % dm.size():
        return x
    return x.redistribute(dm, [Shard(axis)] * dm.ndim)


def local_over(fn: Callable, args: Sequence, in_logical: Sequence,
               out_logical, rules, partial_grads: Sequence[int] = ()):
    """``fn(*args)`` on each rank's blocks (the kernels' and the
    attention's form under DTensor, ``local_map``): a DTensor argument is
    first redistributed to its entry of ``in_logical`` (logical axes, or
    None for a non-tensor), ``fn`` runs on the local tensors, and each
    output becomes a DTensor of its ``out_logical`` entry (a logical
    tuple; a tuple of them for several outputs; ``"sum"`` for a value
    each rank computed over its batch block, to be summed over the batch
    axes). Where no argument is a DTensor this is ``fn(*args)``. An
    argument whose position is in ``partial_grads`` is replicated over the
    batch axes while ``fn``'s other inputs are not, so each rank's
    gradient of it is a partial sum over those axes, which it is declared
    as."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    ref = next((a for a in args if isinstance(a, DTensor)), None)
    if ref is None:
        return fn(*args)
    dm = ref.device_mesh
    r = filter_rules(rules, dm)
    # the mesh dims the batch is split over
    batch = [isinstance(p, Shard)
             for p in placements(spec_for(("batch",), r), dm)]

    def place(la):
        if la is None:
            return None
        if la == "sum":
            return tuple(Partial() if b else Replicate() for b in batch)
        return placements(spec_for(la, r), dm)

    inp = tuple(place(la) for la in in_logical)
    multi = isinstance(out_logical, list)
    outp = (tuple(place(la) for la in out_logical) if multi
            else (place(out_logical),))
    grads = None
    if partial_grads:
        grads = tuple(
            tuple(Partial() if b else p for b, p in zip(batch, pl))
            if i in partial_grads else pl for i, pl in enumerate(inp))
    return local_map(fn, out_placements=outp, in_placements=inp,
                     in_grad_placements=grads, device_mesh=dm,
                     redistribute_inputs=True)(*args)


def rowwise(fn: Callable, *args):
    """``fn(*args)`` on each rank's rows: where the first argument is a
    DTensor placed over dim 0 (``Shard(0)`` or ``Replicate`` on each mesh
    dim: a batch), every DTensor argument is redistributed to its
    placements, ``fn`` runs on the local blocks and its output gets the
    same placements; the gradients come back in them. ``fn(*args)`` itself on plain tensors.
    For the batch-parallel steps whose ops DTensor has no rule for
    (attention's recurrence, a gather by per-row positions)."""
    from torch.distributed.tensor.experimental import local_map

    ref = args[0]
    if not isinstance(ref, DTensor):
        return fn(*args)
    pl = tuple(ref.placements)
    if any(p != Shard(0) and p != Replicate() for p in pl):
        raise ValueError(f"rowwise: placements {pl} are not over dim 0")
    inp = tuple(pl if isinstance(a, DTensor) else None for a in args)
    return local_map(fn, out_placements=(pl,), in_placements=inp,
                     in_grad_placements=inp, device_mesh=ref.device_mesh,
                     redistribute_inputs=True)(*args)


def zeros_rows(ref: torch.Tensor, shape: Sequence[int],
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Zeros of ``shape`` whose dim 0 is ``ref``'s rows: on ``ref``'s
    device, and where ``ref`` is a DTensor placed over dim 0, a DTensor of
    its placements (each rank's block of zeros)."""
    dtype = dtype or ref.dtype
    if not isinstance(ref, DTensor):
        return torch.zeros(tuple(shape), dtype=dtype, device=ref.device)
    local = ref.to_local()
    block = (local.shape[0],) + tuple(shape[1:])
    return DTensor.from_local(
        torch.zeros(block, dtype=dtype, device=local.device),
        ref.device_mesh, ref.placements, run_check=False,
        shape=torch.Size(shape),
        stride=torch.empty(tuple(shape), device="meta").stride())


def mesh_size(x, axis: str) -> int:
    """The size of mesh axis ``axis`` under DTensor ``x`` (1 for a plain
    tensor or an axis the mesh lacks)."""
    if not isinstance(x, DTensor):
        return 1
    return mesh_axes(x.device_mesh).get(axis, 1)


def mesh_size_of(x, logical: LogicalAxes, rules) -> int:
    """How many ranks DTensor ``x``'s mesh splits the logical axes over
    (1 for a plain tensor)."""
    if not isinstance(x, DTensor):
        return 1
    sizes = mesh_axes(x.device_mesh)
    r = filter_rules(rules, x.device_mesh)
    n = 1
    for entry in spec_for(logical, r):
        for a in (() if entry is None else (entry,) if isinstance(entry, str)
                  else entry):
            n *= sizes[a]
    return n


def cf_row_sharding(mesh, axes, ndim: int = 2) -> Sharding:
    """Rows block-partitioned over ``axes``, trailing dims replicated."""
    return Sharding(mesh, (tuple(axes),) + (None,) * (ndim - 1))


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


def repack_row_blocks_device(blocks: Blocks, n_shards: int,
                             old_capacity: int, new_capacity: int
                             ) -> Blocks:
    """The reference's device-side regrow: every block from
    ``old_capacity`` to ``new_capacity`` rows on its own device
    (:func:`repack_row_blocks`), checking the blocks' count and size."""
    if len(blocks) != n_shards or any(b.shape[0] != old_capacity
                                      for b in blocks):
        raise ValueError(f"expected {n_shards} blocks of {old_capacity} "
                         f"rows, got {[b.shape[0] for b in blocks]}")
    return repack_row_blocks(blocks, new_capacity)


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
