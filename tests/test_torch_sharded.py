"""The port's sharded landmark CF on a single-process mesh of CPU shards
(``repro_torch.launch.mesh``, ``repro_torch.distributed.sharding``, the
sharded core, buckets, monitor, refresh and checkpoints), against the
port's own single-device functions and the JAX reference's single-device
ones.

The reference's sharded functions are not used: its sharded tests fail
from run to run on the forced 8-device host platform (ROADMAP B1). So:
- against the port's one-device functions: bitwise (fit, fold-in, pair
  predictions, top-N, the refresh artifact);
- against the reference's one-device functions, under the cross-framework
  rule: predictions and weights within rtol=1e-5, atol=1e-6, ids equal
  except where the reference's weights tie within that tolerance at the
  cut (``core.topk.list_mismatches``).

Meshes: ``pod=2,data=4`` (8 shards) and the 1-axis ``data=3``.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.lifecycle import buckets as jbuckets
from repro.train.checkpoint import load_landmark_state as j_load
import repro_torch.core as T
from repro_torch.core.convert import landmark_state_from_numpy
from repro_torch.core.landmark_cf import fit_distributed, fold_in_sharded
from repro_torch.core.topk import list_mismatches
from repro_torch.data.synthetic import drifting_ratings
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import knn_topk
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_mesh, mesh_devices
from repro_torch.lifecycle import buckets, monitor
from repro_torch.lifecycle.refresh import RefreshManager
from repro_torch.train.checkpoint import (landmark_state_meta,
                                          load_landmark_state,
                                          save_landmark_state)

RTOL, ATOL = 1e-5, 1e-6
SPEC = T.LandmarkSpec(n_landmarks=8, selection="popularity", k_neighbors=5)
JSPEC = J.LandmarkSpec(n_landmarks=8, selection="popularity", k_neighbors=5)
AXES = ("pod", "data")
MESHES = {"pod=2,data=4": (("pod", "data"), (2, 4)),
          "data=3": (("data",), (3,))}


def _mesh(name):
    names, sizes = MESHES[name]
    return make_mesh(names, sizes, "cpu"), names


def _ratings(u, p, density=0.35, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    return r * (rng.random((u, p)) < density)


def _gen():
    return torch.Generator().manual_seed(0)


def _graph_equal(a, b):
    return (torch.equal(a.graph.indices, b.graph.indices)
            and torch.equal(a.graph.weights, b.graph.weights))


def _sharded_ids(sst, shards, slots):
    return torch.as_tensor(np.asarray(shards, np.int64) * sst.capacity
                           + np.asarray(slots, np.int64))


def _dense_ids(u, n_shards):
    u_per = -(-u // n_shards)
    return np.arange(u) // u_per, np.arange(u) % u_per


# ------------------------------------------------------------ mesh, helpers
def test_mesh_places_shards_and_describes_them():
    mesh = make_mesh(("pod", "data"), (2, 4), "cpu")
    assert mesh.size == 8 and mesh.shape == {"pod": 2, "data": 4}
    assert mesh.describe() == "pod=2,data=4: 8 shards on 1 device(s): cpu x8"
    assert mesh_devices(3, "cpu") == (torch.device("cpu"),) * 3
    assert make_mesh(("data", "model"), (1, 1), "cpu").size == 1
    with pytest.raises(ValueError):
        make_mesh(("data",), (0,), "cpu")


def test_row_axes_linearization_and_shard_devices():
    mesh = make_mesh(("pod", "data", "model"), (2, 2, 2), "cpu")
    axes = shd.cf_row_axes(mesh, ("pod", "data", "absent"))
    assert axes == ("pod", "data") and shd.cf_shard_count(mesh, axes) == 4
    assert shd.shard_linear_index(mesh, axes, {"pod": 1, "data": 1}) == 3
    assert len(shd.shard_devices(mesh, axes)) == 4


def test_id_maps_and_block_packing():
    ids = np.arange(23)
    sh = shd.dense_to_sharded_ids(ids, 6, 8)
    np.testing.assert_array_equal(sh // 8, ids // 6)
    np.testing.assert_array_equal(sh % 8, ids % 6)
    np.testing.assert_array_equal(
        shd.remap_block_ids(sh, 8, 16) % 16, sh % 8)
    x = torch.arange(23 * 2, dtype=torch.float32).reshape(23, 2)
    devs = (torch.device("cpu"),) * 4
    blocks = shd.pack_row_blocks(x, 4, 6, 8, devs)
    assert [tuple(b.shape) for b in blocks] == [(8, 2)] * 4
    live = torch.as_tensor(sh)
    assert torch.equal(shd.all_gather_rows(blocks, "cpu")[live], x)
    grown = shd.repack_row_blocks(blocks, 16)
    assert torch.equal(shd.all_gather_rows(grown, "cpu")[
        torch.as_tensor(shd.remap_block_ids(sh, 8, 16))], x)
    assert torch.equal(shd.gather_rows(blocks, torch.as_tensor(sh[::-1]
                                                               .copy()), 8,
                                       "cpu"), x.flip(0))
    shd.shard_local_append(blocks, torch.ones(2, 2), [6, 6, 6, 5], 3)
    assert torch.equal(blocks[3][5:7], torch.ones(2, 2))
    with pytest.raises(ValueError):
        shd.shard_local_append(blocks, torch.ones(3, 2), [6, 6, 6, 7], 3)
    assert torch.equal(shd.ordered_sum([torch.tensor(1.0)] * 3, "cpu"),
                       torch.tensor(3.0))


# ---------------------------------------------------------------- A6 guard
@pytest.mark.parametrize("name", ["kmeans_lloyd", "fused_probe_topk",
                                  "score_candidates"])
def test_ivf_kernel_width_guard(name):
    """Kernels 4-6 take any landmark count, as the scan does: n = 100 and
    104 on the narrow routes, 105, 128 (``web_fit``'s) and 256 on the wide
    ones; n = 0 raises with the scan's message."""
    assert knn_topk.NARROW_WIDTH == 104
    for n in (100, 104, 105, 128, 256):
        knn_topk.check_width(name, n)
    with pytest.raises(ValueError, match=f"{name}: width 0 outside"):
        knn_topk.check_width(name, 0)


# --------------------------------------------------------- fit_distributed
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("u", [96, 101])
def test_fit_distributed_bitwise_single_device_fit(mesh_name, u):
    """Ragged U included: the same landmarks, representation and graph as
    ``fit``, bit for bit."""
    mesh, axes = _mesh(mesh_name)
    r = torch.as_tensor(_ratings(u, 40, seed=u))
    spec = dataclasses.replace(SPEC, selection="coresets")
    st = fit_distributed(r, spec, mesh, axes, generator=_gen())
    one = T.fit(T.RatingMatrix(r, u, 40), spec, generator=_gen())
    assert torch.equal(st.landmark_idx, one.landmark_idx)
    assert torch.equal(st.representation, one.representation)
    assert _graph_equal(st, one)


def test_fit_distributed_matches_reference_fit():
    mesh, axes = _mesh("pod=2,data=4")
    r = _ratings(101, 40, seed=5)
    st = fit_distributed(torch.as_tensor(r), SPEC, mesh, axes)
    jst = J.fit(jax.random.PRNGKey(0), J.RatingMatrix(jnp.asarray(r), 101,
                                                      40), JSPEC)
    np.testing.assert_array_equal(st.landmark_idx.numpy(),
                                  np.asarray(jst.landmark_idx))
    np.testing.assert_allclose(st.representation.numpy(),
                               np.asarray(jst.representation), RTOL, ATOL)
    bad = list_mismatches(np.asarray(jst.graph.weights),
                          np.asarray(jst.graph.indices), st.graph.weights,
                          st.graph.indices, RTOL, ATOL)
    assert bad.size == 0


def test_fit_distributed_dense_sims_branch():
    mesh, axes = _mesh("data=3")
    r = torch.as_tensor(_ratings(50, 30, seed=2))
    st = fit_distributed(r, SPEC, mesh, axes, dense_sims=True)
    one = T.fit(T.RatingMatrix(r, 50, 30), SPEC, dense_sims=True)
    assert st.graph is None and st.sims.shape == (50, 50)
    torch.testing.assert_close(st.sims, one.sims, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------- sharded fold-in
def _replay(mesh, axes, r0, waves, bq=16, arrivals=24, min_bucket=8,
            spec=SPEC, seed=0):
    """Fold the same arrival waves into a sharded state and its
    single-device shadow; yields both states and the id map after each
    wave."""
    st = T.fit(T.RatingMatrix(torch.as_tensor(r0), *r0.shape), spec)
    sst = buckets.from_state_sharded(st, mesh, axes, min_bucket)
    bst = buckets.from_state(st, 32)
    shards, slots = _dense_ids(r0.shape[0], sst.shard_count)
    for w in range(waves):
        arr = drifting_ratings(seed, w + 1, arrivals, r0.shape[1],
                               n_waves=waves + 1, drift=1.0)
        sst, fsh, fsl = buckets.fold_in_rows_sharded(sst, arr, bq, spec,
                                                     min_bucket)
        bst = buckets.fold_in_rows(bst, arr, bq, spec, 32)
        shards = np.concatenate([shards, fsh])
        slots = np.concatenate([slots, fsl])
        yield sst, bst, shards, slots


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_fold_in_bitwise_single_device(mesh_name):
    """Every wave: pair predictions and top-N on the sharded state equal
    the bucketed single-device state's bits (ragged U, capacity growth)."""
    mesh, axes = _mesh(mesh_name)
    r0 = drifting_ratings(0, 0, 75, 48, n_waves=5, drift=1.0)
    rng = np.random.default_rng(1)
    caps = set()
    for sst, bst, shards, slots in _replay(mesh, axes, r0, 4):
        caps.add(sst.capacity)
        u = len(shards)
        pu = rng.integers(0, u, 64)
        pi = torch.as_tensor(rng.integers(0, 48, 64))
        sid = _sharded_ids(sst, shards[pu], slots[pu])
        assert torch.equal(buckets.predict_pairs_sharded(sst, sid, pi),
                           buckets.predict_pairs(bst, torch.as_tensor(pu),
                                                 pi))
        ta, sa = buckets.recommend_topn_sharded(sst, sid, 6)
        tb, sb = buckets.recommend_topn(bst, torch.as_tensor(pu), 6)
        assert torch.equal(ta, tb) and torch.equal(sa, sb)
    first = buckets.bucket_capacity(-(-75 // sst.shard_count), 8)
    assert max(caps) > first  # a capacity regrow happened on the way


def test_capacity_growth_on_one_shard_regrows_every_shard():
    mesh, axes = _mesh("pod=2,data=4")
    st = T.fit(T.RatingMatrix(torch.as_tensor(_ratings(40, 32)), 40, 32),
               SPEC)
    sst = buckets.from_state_sharded(st, mesh, axes, 8)
    before = sst.capacity
    grown, did = buckets.ensure_capacity_sharded(sst, 3, before, 8)
    assert did and grown.capacity > before
    assert {b.shape[0] for b in grown.ratings + grown.representation
            + grown.row_rank} == {grown.capacity}
    assert grown.n_valid == sst.n_valid
    ids = torch.arange(5)
    old = (shd.gather_rows(sst.representation, ids * before, before, "cpu"))
    new = (shd.gather_rows(grown.representation, ids * grown.capacity,
                           grown.capacity, "cpu"))
    assert torch.equal(old, new)
    assert torch.equal(grown.landmark_idx % grown.capacity,
                       sst.landmark_idx % before)
    assert buckets.ensure_capacity_sharded(grown, 3, 1, 8)[1] is False


def test_sharded_fold_in_matches_reference_fold_in_rows():
    """Against the reference's one-device ``buckets.fold_in_rows`` from the
    same fitted state: neighbor lists under the tie rule."""
    mesh, axes = _mesh("pod=2,data=4")
    r0 = _ratings(60, 40, seed=3)
    new = _ratings(40, 40, seed=4)
    jst = J.fit(jax.random.PRNGKey(0), J.RatingMatrix(jnp.asarray(r0), 60,
                                                      40), JSPEC)
    st = landmark_state_from_numpy({
        "landmark_idx": np.asarray(jst.landmark_idx),
        "representation": np.asarray(jst.representation),
        "ratings": np.asarray(jst.ratings),
        "graph.indices": np.asarray(jst.graph.indices),
        "graph.weights": np.asarray(jst.graph.weights)}, device="cpu")
    jb = jbuckets.fold_in_rows(jbuckets.from_state(jst, 128), new, 16,
                               JSPEC, 128)
    sst = buckets.from_state_sharded(st, mesh, axes, 8)
    sst, fsh, fsl = buckets.fold_in_rows_sharded(sst, new, 16, SPEC, 8)
    shards, slots = _dense_ids(60, 8)
    shards, slots = np.concatenate([shards, fsh]), np.concatenate([slots,
                                                                   fsl])
    sid = _sharded_ids(sst, shards, slots)
    gi = shd.gather_rows([g.indices for g in sst.graph], sid, sst.capacity,
                         "cpu").long()
    gw = shd.gather_rows([g.weights for g in sst.graph], sid, sst.capacity,
                         "cpu")
    # sharded neighbor ids back to logical ids
    to_logical = {int(s): i for i, s in enumerate(sid)}
    logical = torch.as_tensor([[to_logical.get(int(x), -1) for x in row]
                               for row in gi])
    jw = np.asarray(jb.state.graph.weights)[:100]
    ji = np.asarray(jb.state.graph.indices)[:100]
    live = gw != 0
    assert bool((logical[live] >= 0).all())
    bad = list_mismatches(jw, ji, gw, torch.where(live, logical, 0), RTOL,
                          ATOL)
    assert bad.size == 0
    items = torch.as_tensor(np.random.default_rng(5).integers(0, 40, 100))
    want = np.asarray(jbuckets.predict_pairs(jb, jnp.arange(100),
                                             jnp.asarray(items.numpy())))
    got = buckets.predict_pairs_sharded(sst, sid, items)
    np.testing.assert_allclose(got.numpy(), want, RTOL, ATOL)


def test_canonical_merge_under_weight_ties():
    """Duplicate rows on every shard tie exactly; the cross-shard merge
    breaks the ties by logical rank, as the one-device scan does."""
    mesh, axes = _mesh("pod=2,data=4")
    base = _ratings(12, 24, seed=6)
    r0 = np.concatenate([base] * 5)  # every row five times
    st = T.fit(T.RatingMatrix(torch.as_tensor(r0), 60, 24), SPEC)
    sst = buckets.from_state_sharded(st, mesh, axes, 8)
    bst = buckets.from_state(st, 64)
    new = np.concatenate([base[:4]] * 4)
    sst, fsh, fsl = buckets.fold_in_rows_sharded(sst, new, 8, SPEC, 8)
    bst = buckets.fold_in_rows(bst, new, 8, SPEC, 64)
    shards, slots = _dense_ids(60, 8)
    sid = _sharded_ids(sst, np.concatenate([shards, fsh]),
                       np.concatenate([slots, fsl]))
    gw = shd.gather_rows([g.weights for g in sst.graph], sid, sst.capacity,
                         "cpu")
    assert bool((gw[:, :-1] == gw[:, 1:]).any())  # ties are present
    pi = torch.as_tensor(np.random.default_rng(7).integers(0, 24, 76))
    assert torch.equal(buckets.predict_pairs_sharded(sst, sid, pi),
                       buckets.predict_pairs(bst, torch.arange(76), pi))


def test_back_patch_reaches_rows_on_other_shards():
    """Old rows on shards other than the target take new rows into their
    lists (ids in the target shard's block)."""
    mesh, axes = _mesh("pod=2,data=4")
    r0 = _ratings(64, 32, seed=8)
    st = T.fit(T.RatingMatrix(torch.as_tensor(r0), 64, 32), SPEC)
    sst = buckets.from_state_sharded(st, mesh, axes, 8)
    batch = torch.as_tensor(r0[:8])  # near-duplicates of shard 0's rows
    sst2, _ = buckets.ensure_capacity_sharded(sst, 5, 8, 8)
    out = fold_in_sharded(sst2, batch, 8, 5, SPEC)
    c = out.capacity
    new_ids = set(range(5 * c + 8, 5 * c + 16))
    patched = [s for s in range(8) if s != 5 and any(
        int(x) in new_ids for x in out.graph[s].indices[:out.n_valid[s]]
        .flatten())]
    assert patched, "no old row off the target shard was back-patched"
    assert out.n_valid[5] == sst2.n_valid[5] + 8


@pytest.mark.parametrize("measure", ["cosine", "pearson", "euclidean"])
def test_backpatch_sims_is_the_shared_scorer_form(measure):
    """The back-patch scores every old row against the batch with kernel
    6's shared form, whose plain version is ``gathered_sims``: a score
    depends on its two rows alone, so a shard's block and the one-device
    block agree bit for bit, row by row."""
    from repro_torch.core.graph import backpatch_sims
    from repro_torch.kernels import ref, score_candidates

    rng = np.random.default_rng(11)
    rep = torch.as_tensor(rng.normal(size=(40, 9)).astype(np.float32))
    new = torch.as_tensor(rng.normal(size=(6, 9)).astype(np.float32))
    got = backpatch_sims(rep, new, measure)
    assert got.shape == (40, 6)
    assert torch.equal(got, ref.gathered_sims(rep, new, measure))
    assert torch.equal(got, score_candidates.score_candidates(rep, new,
                                                              measure))
    assert torch.equal(backpatch_sims(rep[13:29], new, measure), got[13:29])


def test_fold_in_never_builds_an_sc_row_tensor():
    mesh, axes = _mesh("pod=2,data=4")
    st = T.fit(T.RatingMatrix(torch.as_tensor(_ratings(90, 32)), 90, 32),
               SPEC)
    sst = buckets.from_state_sharded(st, mesh, axes, 8)
    n, bad, row_sharded = serve._foldin_replication_check(sst, 8, SPEC)
    assert n > 100 and bad == [] and row_sharded == 5
    # the check sees a replicated (S·C)-row tensor when one is built
    rows = sst.shard_count * sst.capacity
    _, caught = shd.materializations(
        lambda: torch.zeros((rows, 2)),
        lambda shp: len(shp) > 1 and shp[0] >= rows)
    assert len(caught) == 1


# ---------------------------------------------------- monitor and refresh
def test_holdout_snapshot_sharded_equals_single_device():
    mesh, axes = _mesh("pod=2,data=4")
    r0 = drifting_ratings(0, 0, 70, 40, n_waves=4, drift=1.0)
    *_, (sst, bst, shards, slots) = _replay(mesh, axes, r0, 2)
    u = len(shards)
    mon = monitor.init_monitor(32, u, 0.5, "cpu")
    rng = np.random.default_rng(2)
    users, items = rng.integers(0, u, 40), rng.integers(0, 40, 40)
    vals = rng.integers(1, 6, 40).astype(np.float32)
    mon = monitor.reservoir_add(mon, torch.Generator().manual_seed(0),
                                torch.as_tensor(users),
                                torch.as_tensor(items),
                                torch.as_tensor(vals), 40)
    id_map = shards.astype(np.int64) * sst.capacity + slots
    a = monitor.holdout_snapshot_sharded(mon, sst, id_map)
    b = monitor.holdout_snapshot(mon, bst)
    assert (a.mae, a.rmse, a.holdout_count) == (b.mae, b.rmse,
                                                b.holdout_count)
    assert a.shard_skew == monitor.shard_skew(sst.n_valid) >= 1.0


def test_refresh_on_mesh_is_oracle_exact_and_row_sharded(tmp_path):
    """RefreshManager(mesh=): the committed artifact is the one-device
    fit's, stored as 8 row shards; it loads elastically onto a 2-shard
    mesh, and the reference's loader reads it."""
    mesh, axes = _mesh("pod=2,data=4")
    r = drifting_ratings(0, 3, 83, 40, n_waves=4, drift=1.0)
    spec = dataclasses.replace(SPEC, selection="coresets")
    m = RefreshManager(str(tmp_path), spec, device="cpu", mesh=mesh,
                       row_axes=axes)
    assert m.request(r, 1)
    m.join(60)
    gen, st = m.poll()
    assert gen == 1
    oracle = T.fit(T.RatingMatrix(torch.as_tensor(r), 83, 40), spec,
                   generator=torch.Generator().manual_seed(1))
    loaded = load_landmark_state(str(tmp_path), device="cpu")
    assert _graph_equal(loaded, oracle) and _graph_equal(st, oracle)
    assert landmark_state_meta(str(tmp_path))["row_shards"] == 8
    leaf = tmp_path / "step_00000001" / "leaf_0003"  # ratings
    assert len(list(leaf.glob("shard_*.npy"))) == 8
    small = make_mesh(("data",), (2,), "cpu")
    sst = load_landmark_state(str(tmp_path), device="cpu", mesh=small,
                              row_axes=("data",))
    assert sst.shard_count == 2 and sst.total_valid == 83
    ids = shd.dense_to_sharded_ids(torch.arange(83), 42, sst.capacity)
    assert torch.equal(shd.gather_rows(sst.ratings, ids, sst.capacity,
                                       "cpu"), oracle.ratings)
    jst = j_load(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(jst.graph.indices),
                                  oracle.graph.indices.numpy())
    np.testing.assert_array_equal(np.asarray(jst.ratings), r)


def test_row_sharded_checkpoint_round_trip(tmp_path):
    st = T.fit(T.RatingMatrix(torch.as_tensor(_ratings(29, 16)), 29, 16),
               SPEC)
    save_landmark_state(str(tmp_path), st, row_shards=4, compact=True)
    meta = landmark_state_meta(str(tmp_path))
    assert meta["row_shards"] == 4 and meta["compact"]
    back = load_landmark_state(str(tmp_path), device="cpu")
    assert torch.equal(back.ratings, st.ratings)
    assert torch.equal(back.graph.indices, st.graph.indices)
