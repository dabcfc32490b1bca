"""The port's sharded IVF (``repro_torch.retrieval.sharded``) on a mesh of
CPU shards, against the port's one-device index and the JAX reference's
one-device ``build_index`` / ``search``.

- against the port's one-device functions: bitwise (``search_sharded`` and
  ``search_early_exit_sharded`` at full probe, ``append_sharded``, the
  built index);
- against the reference (its centroids handed to the port, as in
  tests/test_torch_retrieval.py): posting lists equal, search lists under
  the cross-framework rule (scores within rtol=1e-5, atol=1e-6, ids equal
  except where the reference's scores tie within it at the cut).

The reference's sharded retrieval is not used: its tests fail from run to
run (ROADMAP B1).
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.retrieval as JR
import repro_torch.retrieval as R
from repro_torch.core.topk import list_mismatches
from repro_torch.distributed.sharding import materializations
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_mesh

RTOL, ATOL = 1e-5, 1e-6
MESHES = {"pod=2,data=4": (("pod", "data"), (2, 4)),
          "data=3": (("data",), (3,))}


def _mesh(name):
    names, sizes = MESHES[name]
    return make_mesh(names, sizes, "cpu"), names


def _rep(u, n, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).normal(
        size=(u, n)).astype(np.float32))


def _index(mesh, axes, u=300, n=12, payload="f32", seed=0):
    rep = _rep(u, n, seed)
    spec = R.resolve_ivf_sharded(R.IVFSpec(payload_dtype=payload), u,
                                 mesh.size)
    idx = R.build_index(rep, spec, "cosine")
    return rep, spec, idx, R.shard_index(idx, mesh, axes)


@pytest.mark.parametrize("u,s,want", [(300, 8, 24), (300, 3, 18),
                                      (10, 4, 4), (100, 1, 10)])
def test_resolve_ivf_sharded_rounds_cells_to_the_shards(u, s, want):
    spec = R.resolve_ivf_sharded(None, u, s)
    assert spec.n_clusters == want and spec.n_clusters % s == 0
    assert spec.spill_choices == spec.n_clusters
    assert 1 <= spec.nprobe <= spec.n_clusters


def test_shard_index_refuses_indivisible_cells():
    mesh, axes = _mesh("data=3")
    idx = R.build_index(_rep(40, 6), R.resolve_ivf(R.IVFSpec(
        n_clusters=4), 40), "cosine")
    with pytest.raises(ValueError, match="not divisible"):
        R.shard_index(idx, mesh, axes)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("scorer", ["plain", "kernel", "fused"])
@pytest.mark.parametrize("payload", ["f32", "int8"])
def test_search_sharded_full_probe_bitwise_one_device(mesh_name, scorer,
                                                      payload):
    mesh, axes = _mesh(mesh_name)
    rep, spec, idx, six = _index(mesh, axes, payload=payload)
    assert torch.equal(six.gathered().lists, idx.lists)
    q, sid = rep[:50], torch.arange(50, dtype=torch.int32)
    v1, i1 = R.search(idx, q, 13, spec.n_clusters, "cosine", self_ids=sid,
                      scorer=scorer)
    v2, i2, probed = R.search_sharded(six, q, 13, spec.n_clusters, "cosine",
                                      self_ids=sid, scorer=scorer)
    assert torch.equal(v1, v2)
    assert torch.equal(torch.where(torch.isinf(v1), 0, i1).to(torch.int32),
                       i2)
    assert bool((probed == spec.n_clusters).all())  # each cell once


def test_search_sharded_matches_reference_search():
    """From the reference's index (its k-means), the port's sharded search
    at full probe against the reference's exact search."""
    mesh, axes = _mesh("pod=2,data=4")
    rep = _rep(240, 10, seed=3)
    jspec = JR.resolve_ivf(JR.IVFSpec(n_clusters=16), 240)
    jidx = JR.build_index(jnp.asarray(rep.numpy()), jspec, "cosine",
                          key=jax.random.PRNGKey(0))
    spec = R.resolve_ivf_sharded(R.IVFSpec(n_clusters=16), 240, 8)
    idx = R.build_index(rep, spec, "cosine",
                        centroids=torch.as_tensor(np.asarray(
                            jidx.centroids)))
    np.testing.assert_array_equal(idx.lists.numpy(), np.asarray(jidx.lists))
    np.testing.assert_array_equal(idx.fill.numpy(), np.asarray(jidx.fill))
    six = R.shard_index(idx, mesh, axes)
    sid = np.arange(60, dtype=np.int32)
    jv, ji = JR.search(jidx, jnp.asarray(rep.numpy()[:60]), 13, 16,
                       "cosine", self_ids=jnp.asarray(sid))
    v, i, _ = R.search_sharded(six, rep[:60], 13, 16, "cosine",
                               self_ids=torch.as_tensor(sid))
    bad = list_mismatches(np.asarray(jv), np.asarray(ji), v, i, RTOL, ATOL)
    assert bad.size == 0


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_early_exit_sharded_full_probe_equals_one_device(mesh_name):
    mesh, axes = _mesh(mesh_name)
    rep, spec, idx, six = _index(mesh, axes, seed=4)
    q, sid = rep[:40], torch.arange(40, dtype=torch.int32)
    c = spec.n_clusters
    v1, i1, p1 = R.search_early_exit(idx, q, 13, c, "cosine", self_ids=sid,
                                     patience=c)
    v2, i2, p2 = R.search_early_exit_sharded(six, q, 13, c, "cosine",
                                             self_ids=sid, patience=c)
    assert torch.equal(v1, v2) and torch.equal(i1, i2)
    assert torch.equal(p1, p2)
    # and the exact search's lists
    v3, i3, _ = R.search_sharded(six, q, 13, c, "cosine", self_ids=sid)
    assert torch.equal(v2, v3) and torch.equal(i2, i3)


def test_local_budget_caps_per_shard_work():
    mesh, axes = _mesh("pod=2,data=4")
    rep, spec, idx, six = _index(mesh, axes, seed=5)
    q = rep[:64]
    nprobe = 12
    _, _, free = R.search_sharded(six, q, 13, nprobe, "cosine")
    assert bool((free == nprobe).all())  # no budget: every probe scored
    for budget in (1, 2):
        v, i, probed = R.search_sharded(six, q, 13, nprobe, "cosine",
                                        local_budget=budget)
        assert bool((probed <= 8 * budget).all())
        assert bool((probed < free).any())
        _, _, ee = R.search_early_exit_sharded(six, q, 13, nprobe, "cosine",
                                               local_budget=budget,
                                               patience=100)
        assert torch.equal(ee, probed)
    # recall by the partial probe stays measurable against the exact
    ve, ie, _ = R.search_sharded(six, q, 13, spec.n_clusters, "cosine")
    assert 0.0 < R.recall_at_k(i, ie, v, ve) <= 1.0


@pytest.mark.parametrize("payload", ["f32", "bf16", "int8"])
def test_append_and_capacity_growth_bitwise_one_device(payload):
    mesh, axes = _mesh("pod=2,data=4")
    rep, spec, idx, six = _index(mesh, axes, payload=payload, seed=6)
    new = _rep(90, 12, seed=7)
    ids = torch.arange(300, 390)
    six, grew = R.ensure_index_capacity_sharded(six, 90)
    one, grew1 = R.ensure_index_capacity(idx, 90)
    assert grew == grew1 and six.capacity == one.capacity
    a1 = R.append(one, new, ids, "cosine", spill_choices=spec.spill_choices)
    a2 = R.append_sharded(six, new, ids, "cosine",
                          spill_choices=spec.spill_choices).gathered()
    for x, y in ((a1.lists, a2.lists), (a1.rows, a2.rows),
                 (a1.fill, a2.fill)):
        assert torch.equal(x, y)
    if payload == "int8":
        assert torch.equal(a1.scale, a2.scale)


def test_probe_path_builds_no_candidate_tensor():
    mesh, axes = _mesh("pod=2,data=4")
    rep, spec, idx, six = _index(mesh, axes, u=600, seed=8)
    n, bad = serve._ivf_materialization_check(six, 64, 13, 8, "cosine", 2)
    assert n > 50 and bad == []
    # without a budget the gathered scorer does build one: the check sees it
    bound = 8 * six.capacity
    _, caught = materializations(
        lambda: R.search_sharded(six, rep[:64], 13, 8, "cosine",
                                 scorer="plain"),
        lambda shp: len(shp) >= 2 and shp[0] == 64 and shp[1] >= bound)
    assert caught
