"""The port's query router (``serving.router``) and ``ShardedBackend`` on
meshes of CPU shards: the reference's router cases
(tests/test_serving_engine.py, "router + sharded engine") held to the
port's one-device backend, and through it to the reference's.

The reference's sharded functions are not used (ROADMAP B1). So:
- routed reads against the port's one-device ``LocalBackend``: bitwise,
  pairs and top-N, at every batch shape and on a ragged population;
- against the reference's one-device ``LocalBackend`` on the reference's
  fit: pair predictions within rtol=1e-5, atol=1e-6, top-N lists under the
  tie rule (``core.topk.list_mismatches``).

Meshes: ``pod=2,data=4`` (8 shards) and the one-axis ``data=4``.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.landmark_cf import fit as jfit
from repro.core.types import LandmarkSpec as JSpec
from repro.core.types import RatingMatrix as JRatings
from repro.lifecycle import buckets as jbuckets
from repro.serving import LocalBackend as JLocalBackend
from repro_torch import obs as obslib
from repro_torch.core.convert import landmark_state_from_numpy
from repro_torch.core.topk import list_mismatches
from repro_torch.core.types import LandmarkSpec
from repro_torch.distributed.sharding import all_gather_rows
from repro_torch.launch.mesh import make_mesh
from repro_torch.lifecycle import buckets
from repro_torch.serving import (EngineConfig, LocalBackend, RequestEngine,
                                 ShardedBackend, router)

RTOL, ATOL = 1e-5, 1e-6
U, P = 96, 40
KW = dict(n_landmarks=8, selection="popularity", k_neighbors=5, d2="cosine")
JSPEC, SPEC = JSpec(**KW), LandmarkSpec(**KW)
MESHES = {"pod=2,data=4": (("pod", "data"), (2, 4)),
          "data=4": (("data",), (4,))}
CFG = EngineConfig(max_batch=32, min_shape=8, fold_bq=8)


def _ratings(u, p, seed=0, density=0.35):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    return r * (rng.random((u, p)) < density)


def _carry(jst):
    return landmark_state_from_numpy({
        "landmark_idx": np.asarray(jst.landmark_idx),
        "representation": np.asarray(jst.representation),
        "ratings": np.asarray(jst.ratings),
        "graph.indices": np.asarray(jst.graph.indices),
        "graph.weights": np.asarray(jst.graph.weights)}, device="cpu")


def _fit(u, seed):
    jst = jfit(jax.random.PRNGKey(0),
               JRatings(jnp.asarray(_ratings(u, P, seed=seed)), u, P), JSPEC)
    return jst, _carry(jst)


@pytest.fixture(scope="module")
def fitted():
    """The reference's fit of a (96, 40) block, carried into the port."""
    return _fit(U, 3)


def _mesh(name):
    names, sizes = MESHES[name]
    return make_mesh(names, sizes, "cpu"), names


def _sharded_backend(st, name, cls=ShardedBackend, **kw):
    mesh, axes = _mesh(name)
    u = st.ratings.shape[0]
    sst = buckets.from_state_sharded(st, mesh, axes, min_bucket=8)
    u_per = -(-u // sst.shard_count)
    return cls(sst, np.arange(u) // u_per, np.arange(u) % u_per, SPEC,
               min_bucket=8, **kw)


def _same_reads(a, b, users, items, n=5):
    pa, pb = a.snapshot(), b.snapshot()
    if not np.array_equal(a.predict_pairs(pa, users, items),
                          b.predict_pairs(pb, users, items)):
        return False
    return all(np.array_equal(x, y) for x, y in zip(
        a.recommend_topn(pa, users, n), b.recommend_topn(pb, users, n)))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_routed_reads_bitwise_vs_single_device(fitted, mesh_name):
    """Routed pair predictions and top-N equal the one-device backend's bit
    for bit at every batch shape, and the reference's one-device backend's
    under the parity rule."""
    jst, st = fitted
    backend = _sharded_backend(st, mesh_name)
    local = LocalBackend(buckets.from_state(st, min_bucket=32), SPEC)
    rng = np.random.default_rng(4)
    for b in CFG.batch_shapes():
        users, items = rng.integers(0, U, b), rng.integers(0, P, b)
        assert _same_reads(backend, local, users, items), b
    users, items = rng.integers(0, U, 32), rng.integers(0, P, 32)
    jbe = JLocalBackend(jbuckets.from_state(jst, min_bucket=32), JSPEC)
    want = np.asarray(jbe.predict_pairs(jbe.snapshot(), users, items))
    got = backend.predict_pairs(backend.snapshot(), users, items)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    wi, ws = jbe.recommend_topn(jbe.snapshot(), users, 5)
    gi, gs = backend.recommend_topn(backend.snapshot(), users, 5)
    assert list_mismatches(np.asarray(ws), np.asarray(wi), gs, gi).size == 0


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_routed_reads_on_a_ragged_population(mesh_name):
    """U = 93 does not divide over the shards: the last blocks hold fewer
    rows (and padded slots), and the reads are still the one-device bits."""
    _, st = _fit(93, 8)
    backend = _sharded_backend(st, mesh_name)
    fills = backend.snapshot()[0].n_valid
    assert len(set(fills)) > 1 and sum(fills) == 93
    local = LocalBackend(buckets.from_state(st, min_bucket=32), SPEC)
    rng = np.random.default_rng(9)
    users, items = rng.integers(0, 93, 64), rng.integers(0, P, 64)
    assert _same_reads(backend, local, users, items)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_routed_reads_mask_tombstoned_neighbors(fitted, mesh_name):
    """With a tombstone bitmap the routed reads zero the tombstoned
    neighbors' weights as ``core.knn`` does on one device: the same bits as
    the one-device reads with the bitmap at the dense ids."""
    from repro_torch.core import knn

    _, st = fitted
    backend = _sharded_backend(st, mesh_name)
    sst, id_shard, id_slot, _ = backend.snapshot()
    dead = np.array([0, 7, 40, 41, 95])
    tomb = torch.zeros(sst.shard_count * sst.capacity, dtype=torch.bool)
    tomb[torch.as_tensor(id_shard[dead] * sst.capacity + id_slot[dead])] = 1
    dense_tomb = torch.zeros(U, dtype=torch.bool)
    dense_tomb[torch.as_tensor(dead)] = True
    rng = np.random.default_rng(5)
    users = torch.as_tensor(rng.integers(0, U, 40))
    items = torch.as_tensor(rng.integers(0, P, 40))
    sids = backend.sharded_ids(backend.snapshot(), users.numpy())
    got = router.predict_pairs_routed(sst, sids, items, tomb=tomb)
    want = knn.predict_pairs_graph(st.graph, st.ratings, users, items,
                                   tomb=dense_tomb)
    assert torch.equal(got, want)
    assert not torch.equal(got, router.predict_pairs_routed(sst, sids, items))
    gi, gs = router.recommend_topn_routed(sst, sids, 5, tomb=tomb)
    wi, ws = knn.recommend_topn_graph(st.graph, st.ratings, users, 5,
                                      tomb=dense_tomb)
    assert torch.equal(gi, wi) and torch.equal(gs, ws)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_router_materializes_no_row_space_intermediates(fitted, mesh_name):
    """The routed pair and top-N batches build no tensor of S·C rows and no
    (b, >= S·C) score tensor, with and without a tombstone operand; the
    check refuses a batch at which a gather could not be told from a
    row-space tensor."""
    _, st = fitted
    sst = _sharded_backend(st, mesh_name).snapshot()[0]
    rows = sst.shard_count * sst.capacity
    b = router.check_batch(sst, 128)
    assert 1 <= b < 128 and b * sst.k < rows
    n, bad = router.materialization_check(sst, b, 5)
    assert n > 0 and bad == []
    tomb = torch.zeros(rows, dtype=torch.bool)
    n_t, bad_t = router.materialization_check(sst, b, 5, tomb=tomb)
    assert n_t > 0 and bad_t == []
    with pytest.raises(ValueError, match="vacuous"):
        router.materialization_check(sst, 128, 5)


def test_the_watcher_flags_a_row_space_tensor(fitted):
    """The dispatch-mode watcher sees a replicated row space: gathering
    every shard's ratings block onto shard 0 is an offender."""
    from repro_torch.distributed.sharding import materializations

    _, st = fitted
    sst = _sharded_backend(st, "pod=2,data=4").snapshot()[0]
    rows = sst.shard_count * sst.capacity
    n, bad = materializations(lambda: all_gather_rows(sst.ratings, "cpu"),
                              lambda shp: len(shp) >= 1 and shp[0] >= rows)
    assert n >= 1 and bad and bad[0][1] == (rows, P)


def test_routed_launches_are_counted_through_obs(fitted):
    """Each routed call bumps ``exec.router.<family>`` launches and rows
    when an observability instance is installed, and nothing otherwise."""
    _, st = fitted
    backend = _sharded_backend(st, "data=4")
    pub = backend.snapshot()
    z = np.zeros(8, np.int64)
    backend.predict_pairs(pub, z, z)  # nothing installed: no counter
    o = obslib.Observability()
    obslib.install(o)
    try:
        backend.predict_pairs(pub, z, z)
        backend.recommend_topn(pub, np.zeros(16, np.int64), 5)
        backend.recommend_topn(pub, z, 5)
    finally:
        obslib.uninstall()
    reg = o.registry
    assert reg.counter("exec.router.pair.launches").value == 1
    assert reg.counter("exec.router.pair.rows").value == 8
    assert reg.counter("exec.router.topn.launches").value == 2
    assert reg.counter("exec.router.topn.rows").value == 24


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_sharded_engine_micro_batching_and_fold(fitted, mesh_name):
    """Micro-batched routed reads re-run alone bitwise; a fold on the write
    lane publishes generation 1 with the new users readable, the same bits
    as a one-device backend after the same fold."""
    _, st = fitted
    backend = _sharded_backend(st, mesh_name)
    assert backend.serialize_folds is False
    eng = RequestEngine(backend, CFG)
    rng = np.random.default_rng(5)
    reqs = []
    for _ in range(8):
        m = int(rng.integers(1, 9))
        reqs.append(eng.submit("pair", users=rng.integers(0, U, m),
                               items=rng.integers(0, P, m)))
    eng.pump_reads()
    assert all(r.done.is_set() for r in reqs)
    checked, bad = eng.verify_sample()
    assert checked == len(reqs) and bad == 0
    rows = _ratings(8, P, seed=14)
    eng.submit("fold", rows=rows)
    eng.pump_folds()
    assert backend.generation == 1 and backend.n_users == U + 8
    local = LocalBackend(buckets.from_state(st, min_bucket=32), SPEC)
    local.fold_in(rows, CFG.fold_bq)
    new = np.arange(U, U + 8)
    r = eng.submit("pair", users=new, items=np.zeros(8, int))
    eng.pump_reads()
    assert np.isfinite(r.result).all()
    assert _same_reads(backend, local, np.concatenate([new, new[:4]]),
                       rng.integers(0, P, 12))


def test_sharded_backend_warms_a_new_capacity_before_the_publish(fitted):
    """Folds that overflow a shard regrow every block; the reads of the new
    capacity run (and record their geometries) before the publish, and
    the logical ids keep naming the same users."""
    _, st = fitted
    backend = _sharded_backend(st, "data=4", warm_shapes=(8, 16))
    cap0 = backend.snapshot()[0].capacity
    local = LocalBackend(buckets.from_state(st, min_bucket=32), SPEC)
    buckets.reset_geometries()
    rows = _ratings(40, P, seed=21)
    backend.fold_in(rows, 8)
    local.fold_in(rows, 8)
    cap1 = backend.snapshot()[0].capacity
    assert cap1 > cap0 and backend.caps_used == {cap0, cap1}
    assert {(cap1, 8), (cap1, 16)} <= buckets.GEOMETRIES["pair"]
    rng = np.random.default_rng(6)
    users = rng.integers(0, U + 40, 48)
    assert _same_reads(backend, local, users, rng.integers(0, P, 48))


def test_threaded_sharded_engine_overlaps_folds_with_reads(fitted):
    """The threaded engine on a 4-shard mesh: reads and folds run on their
    own threads at once (no lock between them), every admitted request
    completes, and the audit re-runs reads with 0 mismatches."""
    _, st = fitted
    backend = _sharded_backend(st, "data=4")
    eng = RequestEngine(backend, CFG)
    rng = np.random.default_rng(7)
    eng.start()
    try:
        reqs = [eng.submit("fold", rows=_ratings(8, P, seed=30 + i))
                for i in range(3)]
        for _ in range(30):
            m = int(rng.integers(1, 9))
            reqs.append(eng.submit("pair", users=rng.integers(0, U, m),
                                   items=rng.integers(0, P, m)))
        for r in reqs:
            assert r is not None and r.done.wait(timeout=60.0)
    finally:
        eng.stop()
    assert backend.generation == 3 and backend.n_users == U + 24
    for _ in range(4):
        m = int(rng.integers(1, 9))
        eng.submit("topn", users=rng.integers(0, U + 24, m))
    eng.pump_reads()
    checked, bad = eng.verify_sample()
    assert checked > 0 and bad == 0
