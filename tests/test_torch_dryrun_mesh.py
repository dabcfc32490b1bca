"""The dry run's mesh flags (``launch/dryrun.py``): the LM cells placed
over an in-process ``fake`` group and counted per device, on the CPU.

- ``--debug-mesh`` (2×4) and ``--multi-pod`` (2×16×16) run SmolLM's smoke
  cells (train, prefill, decode, the landmark decode) and exit 0, every
  record with its mesh's ``n_devices``, per-device memory and
  collectives; the fake group is gone after the run.
- ``llama3-405b``/``train_4k``'s per-device argument bytes at 16×16, and
  its ``long_500k`` decode's at 2×16×16 (the cache's sequence over data
  and model, replicated over pod), equal the sum of the reference's shard
  shapes (``repro.launch.steps`` on an ``AbstractMesh``).
- The collectives the dry run counts for the smoke train cell on a fake
  ``data=2, model=2`` group equal, kind by kind in count and bytes, what
  4 spawned gloo ranks move in the same cell's step (``launch/dist.py``:
  both count each functional collective's output bytes).
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch.steps import build_cell as jbuild_cell
from repro_torch.configs import registry
from repro_torch.launch import dist, dryrun, mesh_run
from repro_torch.launch.mesh import MULTI_POD, PRODUCTION, device_mesh
from repro_torch.launch.step_costs import storage_bytes
from repro_torch.launch.steps import build_cell

MESH = (("data", "model"), (2, 2))


@pytest.mark.parametrize("flag,n", [("--debug-mesh", 8), ("--multi-pod",
                                                           512)])
def test_mesh_flags_run_the_lm_smoke_cells(flag, n):
    recs = dryrun.main(["--all", "--arch", "smollm-360m", "--smoke", flag])
    assert not torch.distributed.is_initialized()
    cells = {(r["shape"], r["variant"]) for r in recs}
    assert cells == {("train_4k", "base"), ("prefill_32k", "base"),
                     ("decode_32k", "base"), ("long_500k", "base"),
                     ("long_500k", "landmark")}
    for r in recs:
        assert r["n_devices"] == n
        assert math.prod(map(int, r["mesh"].split("x"))) == n
        mem = r["memory"]
        assert mem["argument_size_in_bytes"] > 0
        assert mem["temp_size_in_bytes"] > 0
        moved = sum(v for k, v in r["collectives"].items()
                    if not k.startswith("_"))
        assert moved > 0, r["shape"]
        assert r["flops"] > 0


def test_llama_train_argument_bytes_per_device_equal_the_reference():
    names, sizes = PRODUCTION
    jm = jax.sharding.AbstractMesh(sizes, names)
    jcell = jbuild_cell(jregistry.get("llama3-405b"), "train_4k", jm)
    want = sum(int(np.prod(leaf.sharding.shard_shape(leaf.shape)))
               * np.dtype(leaf.dtype).itemsize
               for leaf in jax.tree_util.tree_leaves(jcell.args))
    with dist.fake_group(math.prod(sizes)):
        cell = build_cell(registry.get("llama3-405b"), "train_4k",
                          mesh=device_mesh(names, sizes, "cpu"))
        got = storage_bytes(cell.args)
    assert got == want


def test_long_context_decode_argument_bytes_at_multi_pod_equal_the_reference():
    """The long_500k cache's sequence is split over data and model and
    replicated over pod (``kv_seq_all``): its cell is placed on the mesh
    with pod and data apart, so each device holds the reference's block."""
    names, sizes = MULTI_POD
    jm = jax.sharding.AbstractMesh(sizes, names)
    jcell = jbuild_cell(jregistry.get("llama3-405b"), "long_500k", jm)
    jcache = jcell.args[1]
    want = sum(int(np.prod(leaf.sharding.shard_shape(leaf.shape)))
               * np.dtype(leaf.dtype).itemsize
               for leaf in jax.tree_util.tree_leaves(jcell.args))
    with dist.fake_group(math.prod(sizes)):
        cell = build_cell(registry.get("llama3-405b"), "long_500k",
                          mesh=device_mesh(names, sizes, "cpu"))
        got = storage_bytes(cell.args)
        cache = cell.args[1]
        for key in ("k", "v"):
            leaf = jcache[key]
            assert tuple(cache[key].to_local().shape) == tuple(
                leaf.sharding.shard_shape(leaf.shape)), key
    assert got == want


def _arch():
    return mesh_run.smoke_arch("smollm-360m", dtype=torch.float32,
                               backend="landmark", batch=4, seq=64)


def _rank(launch, arch):
    return mesh_run.train(launch, arch, mesh_axes=MESH)["collectives"][0]


def test_dry_run_collectives_equal_the_ranks_traffic():
    arch = _arch()
    with dist.fake_group(4):
        costs, _, _ = dryrun.count_cell(arch, "train",
                                        mesh=device_mesh(*MESH, "cpu"))
    ranks = dist.spawn(_rank, 4, arch, timeout=300)
    counts = costs.collectives["_counts"]
    for got in ranks:
        assert got == ranks[0]
        for kind, c in counts.items():
            assert got.get(kind, {"count": 0})["count"] == c, kind
            assert got.get(kind, {"bytes": 0})["bytes"] == \
                costs.collectives[kind], kind
    assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
