"""Checkpoints with atomic commit, keep-k garbage collection and row
shards.

The on-disk layout is the reference's (``repro.train.checkpoint``), so an
artifact written by either package loads in the other:

  <dir>/step_00000100.tmp/          # written first
      manifest.json                 # step, leaf count, shapes, dtypes, shards
      leaf_0000/shard_0000.npy      # one .npy per (leaf, row shard)
      state.json                    # sidecar (LandmarkState artifacts)
  <dir>/step_00000100/              # atomic rename on success

A leaf saved in row shards (``row_shards`` of :func:`save_checkpoint`)
stores one file per block of rows, with the block's global index range in
the manifest, as the reference stores the addressable shards of a
row-sharded array; a restore reassembles the leaf from the ranges, so the
shard count on disk need not match the mesh that loads it.

:class:`AsyncCheckpointer` writes a training checkpoint in a background
thread after copying it to the host (one write in flight).

A tree of DTensors (a model sharded over a ``torch.distributed`` mesh)
is written by all its ranks together, as the reference writes a jax
array's addressable shards: each block once (by the rank at coordinate 0
of every mesh dim the block is replicated over), one file each, with its
global index range; rank 0 writes the manifest and commits after a
barrier. A restore reads every leaf whole and re-places it like the
``tree_like`` leaf it fills: as a DTensor on that leaf's mesh and
placements (any mesh), or on one device. Such a save runs on the calling
thread (its barriers are collectives of the training's group).

A tree is a dict (or list/tuple) of tensors or arrays, flattened the way
``jax.tree_util`` flattens it: dict keys in sorted order, sequences in
order, depth first. bfloat16 leaves are stored as their uint16 bits and
named ``bfloat16`` in the manifest.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree) -> List:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _flatten(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in _flatten(sub)]
    return [tree]


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        return next(it)

    return build(like)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the numpy array that goes to disk (bf16 as uint16 bits)
    and the dtype name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _row_blocks(rows: int, n_shards: int):
    """The [lo, hi) row ranges of ``n_shards`` blocks of ceil(rows/S) rows
    (the mesh's row linearization); empty trailing blocks are dropped."""
    per = -(-rows // max(n_shards, 1)) if rows else 0
    return [(lo, min(lo + per, rows)) for lo in range(0, rows, per)
            ] if per else [(0, 0)]


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _blocks(shape, placements, mesh_shape):
    """Every mesh coordinate's block of a DTensor of global ``shape``:
    ``(coord, [(lo, hi) per dim], owner)`` where owner says the coordinate
    writes the block (it is 0 on every mesh dim not splitting the
    tensor). A dim split over several mesh dims is split in mesh order,
    each split ``torch.chunk``'s (ceil-sized blocks, the last ones short
    or empty)."""
    from itertools import product

    from torch.distributed.tensor import Shard

    out = []
    for coord in product(*(range(n) for n in mesh_shape)):
        ranges = [[0, n] for n in shape]
        for md, pl in enumerate(placements):
            if isinstance(pl, Shard):
                d = pl.dim % len(shape)
                lo, hi = ranges[d]
                per = -(-(hi - lo) // mesh_shape[md])
                a = min(lo + coord[md] * per, hi)
                ranges[d] = [a, min(a + per, hi)]
        owner = all(c == 0 for c, pl in zip(coord, placements)
                    if not isinstance(pl, Shard))
        out.append((coord, ranges, owner))
    return out


def _save_sharded(tmp: Path, leaves: List) -> Dict[str, Any]:
    """Each rank writes the blocks it owns of every leaf; returns the
    manifest (the same on every rank)."""
    import torch.distributed as dist

    rank = dist.get_rank()
    manifest: Dict[str, Any] = {"n_leaves": len(leaves), "leaves": []}
    for i, leaf in enumerate(leaves):
        leaf_dir = tmp / f"leaf_{i:04d}"
        leaf_dir.mkdir(exist_ok=True)
        if not _is_dtensor(leaf):
            host, dtype = _to_host(leaf)
            if rank == 0:
                np.save(leaf_dir / "shard_0000.npy", host)
            manifest["leaves"].append({
                "shape": list(host.shape), "dtype": dtype,
                "shards": [{"file": "shard_0000.npy",
                            "index": [[0, d] for d in host.shape]}]})
            continue
        mesh = leaf.device_mesh
        me = tuple(mesh.get_coordinate())
        host, dtype = _to_host(leaf.to_local())
        shards = []
        for j, (coord, ranges, owner) in enumerate(_blocks(
                tuple(leaf.shape), leaf.placements, tuple(mesh.mesh.shape))):
            if not owner or any(hi <= lo for lo, hi in ranges):
                continue
            name = f"shard_{j:04d}.npy"
            if coord == me:
                np.save(leaf_dir / name, host)
            shards.append({"file": name, "index": ranges})
        manifest["leaves"].append({"shape": list(leaf.shape), "dtype": dtype,
                                   "shards": shards})
    return manifest


def save_checkpoint(directory: str, step: int, tree: Any, keep: int = 3,
                    extra_files: Optional[Dict[str, str]] = None,
                    row_shards: Optional[Dict[int, int]] = None) -> Path:
    """Write ``tree`` as step ``step``; atomic via a tmp dir + rename, then
    drop all but the newest ``keep`` committed steps. ``extra_files``
    (name → text) land in the tmp dir before the rename, so sidecars commit
    with the tensors. ``row_shards`` (leaf position in flatten order →
    shard count) stores those leaves as blocks of rows, one file each. A
    tree holding DTensors is written by every rank of their group (see
    the module's notes)."""
    if any(_is_dtensor(x) for x in _flatten(tree)):
        return _save_dist(Path(directory), step, tree, keep, extra_files)
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = _flatten(tree)
    manifest: Dict[str, Any] = {"step": step, "n_leaves": len(leaves),
                                "leaves": []}
    for i, leaf in enumerate(leaves):
        host, dtype = _to_host(leaf)
        leaf_dir = tmp / f"leaf_{i:04d}"
        leaf_dir.mkdir()
        blocks = ([(0, host.shape[0] if host.ndim else 0)]
                  if not host.ndim or i not in (row_shards or {})
                  else _row_blocks(host.shape[0], row_shards[i]))
        shards = []
        for j, (lo, hi) in enumerate(blocks):
            name = f"shard_{j:04d}.npy"
            np.save(leaf_dir / name, host[lo:hi] if host.ndim else host)
            shards.append({"file": name, "index": (
                [[lo, hi]] + [[0, d] for d in host.shape[1:]]
                if host.ndim else [])})
        manifest["leaves"].append({"shape": list(host.shape), "dtype": dtype,
                                   "shards": shards})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    for name, text in (extra_files or {}).items():
        (tmp / name).write_text(text)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    ckpts = sorted(p for p in directory.glob("step_*")
                   if not p.name.endswith(".tmp"))
    for old in ckpts[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    return final


def _save_dist(directory: Path, step: int, tree: Any, keep: int,
               extra_files: Optional[Dict[str, str]]) -> Path:
    import torch.distributed as dist

    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if dist.get_rank() == 0:
        directory.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
    dist.barrier()
    manifest = {"step": step, **_save_sharded(tmp, _flatten(tree))}
    dist.barrier()  # every block on disk
    if dist.get_rank() == 0:
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        for name, text in (extra_files or {}).items():
            (tmp / name).write_text(text)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        ckpts = sorted(p for p in directory.glob("step_*")
                       if not p.name.endswith(".tmp"))
        for old in ckpts[:-keep]:
            shutil.rmtree(old, ignore_errors=True)
    dist.barrier()  # committed before any rank goes on
    return final


def latest_step(directory: str) -> Optional[int]:
    """Highest committed step: past the rename (no ``.tmp``) and holding a
    ``manifest.json`` — a partial directory left by a crash is invisible."""
    d = Path(directory)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")
             if not p.name.endswith(".tmp") and (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _load_leaf(leaf_dir: Path, meta: Dict) -> np.ndarray:
    is_bf16 = meta["dtype"] == "bfloat16"
    full = np.zeros(meta["shape"], dtype=np.uint16 if is_bf16
                    else np.dtype(meta["dtype"]))
    for shard in meta["shards"]:
        data = np.load(leaf_dir / shard["file"])
        idx = tuple(slice(a, b) for a, b in shard["index"]) or ...
        full[idx] = data
    return full


def _to_tensor(host: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(host.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(host).to(device)


def restore_checkpoint(directory: str, tree_like: Any,
                       step: Optional[int] = None, device="cuda") -> Any:
    """Restore step ``step`` (default: the latest) into the structure of
    ``tree_like``, every leaf a tensor on ``device``, or, where the
    ``tree_like`` leaf is a DTensor, a DTensor of its mesh and placements
    (each rank keeps its block of the whole leaf). Shards written by a
    multi-device save are reassembled from their index ranges."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    d = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    n = len(_flatten(tree_like))
    if n != manifest["n_leaves"]:
        raise ValueError(f"tree structure changed: {n} leaves vs "
                         f"{manifest['n_leaves']} on disk")
    leaves = []
    for i, (meta, like) in enumerate(zip(manifest["leaves"],
                                         _flatten(tree_like))):
        dev = like.to_local().device if _is_dtensor(like) else device
        t = _to_tensor(_load_leaf(d / f"leaf_{i:04d}", meta), meta["dtype"],
                       dev)
        if _is_dtensor(like):
            from torch.distributed.tensor import distribute_tensor

            t = distribute_tensor(t, like.device_mesh, like.placements,
                                  src_data_rank=None)
        leaves.append(t)
    return _unflatten(tree_like, leaves)


def _host_copy(leaf):
    """A leaf copied to host memory: the caller may update the original in
    place as soon as this returns."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


class AsyncCheckpointer:
    """Overlap checkpoint writes with the next train steps, one write in
    flight (the reference's ``AsyncCheckpointer``).

    ``save`` waits for the previous write, copies every leaf of ``tree`` to
    the host in the caller's thread — the port's optimizer updates the
    parameters and its state in place, so the copy is finished before
    ``save`` returns — and writes it with :func:`save_checkpoint` in a
    background thread; ``wait`` joins that thread."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        if any(_is_dtensor(x) for x in _flatten(tree)):
            save_checkpoint(self.directory, step, tree, self.keep)
            return
        host = _unflatten(tree, [_host_copy(x) for x in _flatten(tree)])
        self._thread = threading.Thread(
            target=save_checkpoint, args=(self.directory, step, host,
                                          self.keep), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None


# --------------------------------------------------------------- CF artifacts
# A fitted LandmarkState is stored as a field-named dict (sorted-key flatten
# order) plus a state.json sidecar recording which fields exist, so a
# restore needs no fitted template.


ROW_FIELDS = ("graph_indices", "graph_weights", "ratings", "representation",
              "sims")


def save_landmark_state(directory: str, state, *, compact: bool = False,
                        step: int = 0, keep: int = 3,
                        row_shards: int = 1) -> Path:
    """Persist a fitted ``LandmarkState`` (graph ids and weights included).

    ``compact=True`` stores the graph as uint16 ids + bf16 weights (half the
    artifact bytes; U < 65536). Landmark ids are stored as int32, as the
    reference stores them. ``row_shards`` > 1 (a state fitted on a mesh,
    ``fit_distributed``) stores every row-indexed field as that many
    blocks of rows, one file each, and records the count in the sidecar;
    ``load_landmark_state(..., mesh=)`` places the rows onto whatever mesh
    serves next."""
    graph = state.graph
    if compact and graph is not None:
        graph = graph.to_compact()
    tree = {
        "landmark_idx": state.landmark_idx.to(torch.int32),
        "representation": state.representation,
        "ratings": state.ratings,
    }
    if graph is not None:
        tree["graph_indices"] = graph.indices
        tree["graph_weights"] = graph.weights
    if state.sims is not None:
        tree["sims"] = state.sims
    fields = sorted(tree)
    meta = {"kind": "landmark_state", "fields": fields,
            "compact": bool(compact and graph is not None),
            "row_shards": int(row_shards)}
    return save_checkpoint(
        directory, step, tree, keep=keep,
        extra_files={"state.json": json.dumps(meta)},
        row_shards={i: row_shards for i, f in enumerate(fields)
                    if f in ROW_FIELDS and row_shards > 1})


def landmark_state_meta(directory: str, step: Optional[int] = None) -> Dict:
    """The state.json sidecar of a saved LandmarkState."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    return json.loads(
        (Path(directory) / f"step_{step:08d}" / "state.json").read_text())


def load_landmark_state(directory: str, step: Optional[int] = None, *,
                        widen: bool = True, device="cuda", mesh=None,
                        row_axes=("pod", "data"), min_bucket: int = 32):
    """Rebuild a ``LandmarkState`` on ``device`` from
    ``save_landmark_state`` output (either package's). ``widen=True``
    returns the int32/f32 graph even from a compact artifact.

    With ``mesh`` the rows are placed block-partitioned over the mesh's
    ``row_axes`` instead: a ``ShardedLandmarkState``
    (``lifecycle.buckets.from_state_sharded``, per-shard buckets from
    ``min_bucket``). Elastic: the shard count on disk need not match the
    mesh's, smaller or larger."""
    from ..core.landmark_cf import LandmarkState
    from ..core.types import NeighborGraph

    step = step if step is not None else latest_step(directory)
    meta = landmark_state_meta(directory, step)
    tree = restore_checkpoint(directory, {f: 0 for f in meta["fields"]},
                              step=step, device=device)
    graph = None
    if "graph_indices" in tree:
        graph = NeighborGraph(tree["graph_indices"], tree["graph_weights"])
        if widen and graph.is_compact:
            graph = graph.to_full()
    state = LandmarkState(tree["landmark_idx"].to(torch.int64),
                          tree["representation"], tree["ratings"],
                          graph=graph, sims=tree.get("sims"))
    if mesh is None:
        return state
    from ..lifecycle.buckets import from_state_sharded

    return from_state_sharded(state, mesh, row_axes, min_bucket)
