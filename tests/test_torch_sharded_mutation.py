"""The port's write path on a mesh (``repro_torch.mutation.sharded``), and
the ``tomb=`` operands of the sharded monitor and search, on meshes of CPU
shards.

The reference's mesh cases (tests/test_mutation.py::
test_sharded_mutation_parity) are held to the port's one-device write
path, not to the reference's sharded functions (ROADMAP B1):
- against the port's one-device ``mutation`` functions: bitwise, through
  the sharded-id bijection — every pair prediction, top-N list and graph
  row, after an update, a removal, their repairs, a compaction and a
  fold-in, for every d2 measure and both rescan backends;
- against the reference's one-device ``repro.mutation`` on the reference's
  fit: pair predictions within rtol=1e-5, atol=1e-6.

Meshes: ``pod=2,data=4`` (8 shards) and the one-axis ``data=4``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import mutation as JM
from repro.core.landmark_cf import fit as jfit
from repro.core.types import LandmarkSpec as JSpec
from repro.core.types import RatingMatrix as JRatings
import repro_torch.core as T
import repro_torch.retrieval as R
from repro_torch import mutation as TM
from repro_torch.core.convert import landmark_state_from_numpy
from repro_torch.distributed.sharding import materializations
from repro_torch.launch.mesh import make_mesh
from repro_torch.lifecycle import buckets, monitor
from repro_torch.mutation import sharded as MS

RTOL, ATOL = 1e-5, 1e-6
U, P = 96, 40
MEASURES = ("cosine", "pearson", "euclidean")
MESHES = {"pod=2,data=4": (("pod", "data"), (2, 4)),
          "data=4": (("data",), (4,))}
UPDATED = np.array([3, 50, 95, 0])
DEAD = np.array([10, 11, 95, 20, 33, 40, 41, 77])


def _ratings(u, p, seed=0, density=0.35):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    return r * (rng.random((u, p)) < density)


def _spec(d2="cosine"):
    return T.LandmarkSpec(n_landmarks=8, selection="popularity",
                          k_neighbors=5, d2=d2)


def _mesh(name):
    names, sizes = MESHES[name]
    return make_mesh(names, sizes, "cpu"), names


class Pair:
    """A one-device mutable state and its mesh twin, fed the same writes
    (logical ids: the one-device row ids until a compaction)."""

    def __init__(self, st, mesh_name, spec, backend="auto"):
        mesh, axes = _mesh(mesh_name)
        u = st.ratings.shape[0]
        self.spec, self.backend = spec, backend
        self.one = TM.from_fitted(st, min_bucket=32)
        self.msst = MS.from_sharded(buckets.from_state_sharded(
            st, mesh, axes, min_bucket=8))
        u_per = -(-u // self.msst.shard_count)
        self.shard, self.slot = np.arange(u) // u_per, np.arange(u) % u_per
        self.dense = np.arange(u)  # logical id -> one-device row id

    def sids(self, logical):
        logical = np.asarray(logical)
        return self.shard[logical] * self.msst.capacity + self.slot[logical]

    def padded(self, logical, b=8):
        ids, sids = np.full(b, -1), np.full(b, -1)
        ids[:len(logical)] = self.dense[logical]
        sids[:len(logical)] = self.sids(logical)
        return ids, sids

    def update(self, logical, rows):
        ids, sids = self.padded(logical)
        prows = np.zeros((8, P), np.float32)
        prows[:len(logical)] = rows
        self.one = TM.update_ratings(self.one, ids, prows, len(logical),
                                     self.spec)
        self.msst = MS.update_ratings_sharded(self.msst, sids, prows,
                                              len(logical), self.spec)

    def remove(self, logical):
        ids, sids = self.padded(logical)
        self.one = TM.remove_users(self.one, ids, len(logical))
        self.msst = MS.remove_users_sharded(self.msst, sids, len(logical))

    def drain(self):
        self.one = TM.drain_repairs(self.one, self.spec, 16,
                                    backend=self.backend)
        self.msst = MS.drain_repairs_sharded(self.msst, self.spec, 16,
                                             backend=self.backend)

    def compact(self):
        table, _, _ = MS.compact_tables(self.msst)
        live = ~self.one.tomb.numpy()[:self.one.n_valid]
        dense = np.full(len(self.dense), -1)
        dense[live[self.dense]] = np.arange(int(live.sum()))
        new_sid = table[self.sids(np.arange(len(self.dense)))]
        self.one = TM.compact_tombstones(self.one)
        self.msst = MS.compact_tombstones_sharded(self.msst)
        self.dense = dense
        self.slot = new_sid % self.msst.capacity

    def fold(self, rows):
        n0 = self.one.n_valid
        self.one = TM.fold_in_rows(self.one, rows, 8, self.spec)
        self.msst, sh, sl = MS.fold_in_rows_sharded(self.msst, rows, 8,
                                                    self.spec, min_bucket=8)
        self.shard = np.concatenate([self.shard, sh])
        self.slot = np.concatenate([self.slot, sl])
        self.dense = np.concatenate([self.dense, n0 + np.arange(len(rows))])

    def live(self):
        return np.flatnonzero((self.dense >= 0)
                              & ~self.one.tomb.numpy()[np.maximum(
                                  self.dense, 0)])

    def reads_equal(self, logical, items):
        a = TM.predict_pairs(self.one, torch.as_tensor(self.dense[logical]),
                             torch.as_tensor(items))
        b = MS.predict_pairs(self.msst, torch.as_tensor(self.sids(logical)),
                             torch.as_tensor(items))
        ai, av = TM.recommend_topn(self.one,
                                   torch.as_tensor(self.dense[logical]), 5)
        bi, bv = MS.recommend_topn(self.msst,
                                   torch.as_tensor(self.sids(logical)), 5)
        return (torch.equal(a, b) and torch.equal(ai, bi)
                and torch.equal(av, bv))

    def graphs_equal(self):
        """Every live row's list, ids mapped to one-device ids, and every
        bitmap bit, as one device's."""
        sid_to_dense = np.full(self.msst.shard_count * self.msst.capacity,
                               -1)
        ok = self.dense >= 0
        sid_to_dense[self.sids(np.flatnonzero(ok))] = self.dense[ok]
        g1 = self.one.bstate.state.graph
        c = self.msst.capacity
        for u in np.flatnonzero(ok):
            s, sl = divmod(int(self.sids(u)), c)
            g = self.msst.sstate.graph[s]
            gi = sid_to_dense[g.indices[sl].numpy()]
            d = self.dense[u]
            inert = g.weights[sl].numpy() == 0
            gi = np.where(inert & (g.indices[sl].numpy() == 0), 0, gi)
            if not (np.array_equal(gi, g1.indices[d].numpy())
                    and np.array_equal(g.weights[sl].numpy(),
                                       g1.weights[d].numpy())):
                return False
        sid = self.sids(np.flatnonzero(ok))
        return (np.array_equal(self.msst.tomb.numpy()[sid],
                               self.one.tomb.numpy()[self.dense[ok]])
                and np.array_equal(self.msst.dirty.numpy()[sid],
                                   self.one.dirty.numpy()[self.dense[ok]]))


def _fit(measure, seed=12, u=U):
    return T.fit(T.RatingMatrix(torch.as_tensor(_ratings(u, P, seed)), u, P),
                 _spec(measure))


def _check(pair, rng):
    live = pair.live()
    users = live[rng.integers(0, len(live), 64)]
    assert pair.reads_equal(users, rng.integers(0, P, 64))
    assert pair.graphs_equal()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("measure", MEASURES)
def test_sharded_mutation_parity(measure, mesh_name):
    """update / remove / their repairs / compact / fold-in on the mesh give
    the one-device mutable path's reads and graph rows bit for bit."""
    pair = Pair(_fit(measure), mesh_name, _spec(measure))
    rng = np.random.default_rng(13)
    pair.update(UPDATED, _ratings(4, P, seed=14))
    assert pair.msst.dirty_count() == pair.one.dirty_count() > 0
    assert pair.graphs_equal()
    pair.drain()
    assert pair.msst.dirty_count() == 0
    _check(pair, rng)
    pair.remove(DEAD)
    assert pair.msst.tombstone_frac() == pair.one.tombstone_frac() > 0
    assert pair.graphs_equal()
    pair.drain()
    _check(pair, rng)
    pair.compact()
    assert pair.msst.tombstone_frac() == 0.0
    assert pair.msst.sstate.total_valid == U - len(DEAD)
    _check(pair, rng)
    pair.fold(_ratings(12, P, seed=15))
    pair.drain()
    _check(pair, rng)
    new = np.arange(U, U + 12)
    assert pair.reads_equal(new, rng.integers(0, P, 12))


@pytest.mark.parametrize("measure", MEASURES)
def test_kernel_rescan_on_the_mesh_matches_one_device(measure):
    """``backend="kernel"`` (the fold-in scan's plain version on CPU
    tensors): each shard's top-(k+1) over its live rows, self dropped,
    merged by rank, is the one-device kernel rescan's list."""
    pair = Pair(_fit(measure, seed=5), "pod=2,data=4", _spec(measure),
                backend="kernel")
    rng = np.random.default_rng(2)
    pair.update(UPDATED, _ratings(4, P, seed=6))
    pair.remove(DEAD)
    pair.drain()
    _check(pair, rng)


def test_sharded_mutation_parity_with_the_reference():
    """From the reference's fit: the reference's one-device write path and
    the port's mesh, the same update and removal drained, then compacted:
    pair predictions of the live users within the parity rule."""
    kw = dict(n_landmarks=8, selection="popularity", k_neighbors=5,
              d2="cosine")
    r = _ratings(U, P, seed=16)
    jst = jfit(jax.random.PRNGKey(0), JRatings(jnp.asarray(r), U, P),
               JSpec(**kw))
    st = landmark_state_from_numpy({
        "landmark_idx": np.asarray(jst.landmark_idx),
        "representation": np.asarray(jst.representation),
        "ratings": np.asarray(jst.ratings),
        "graph.indices": np.asarray(jst.graph.indices),
        "graph.weights": np.asarray(jst.graph.weights)}, device="cpu")
    pair = Pair(st, "data=4", T.LandmarkSpec(**kw))
    jspec = JSpec(**kw)
    jm = JM.from_fitted(jst)
    rows = _ratings(4, P, seed=17)
    ids = np.full(8, -1, np.int32)
    ids[:4] = UPDATED
    prows = np.zeros((8, P), np.float32)
    prows[:4] = rows
    jm = JM.drain_repairs(JM.update_ratings(
        jm, jnp.asarray(ids), jnp.asarray(prows), jnp.int32(4), jspec),
        jspec, bq=16)
    jm = JM.drain_repairs(JM.remove_users(
        jm, jnp.asarray(DEAD.astype(np.int32)), jnp.int32(8)), jspec, bq=16)
    pair.update(UPDATED, rows)
    pair.remove(DEAD)
    pair.drain()
    rng = np.random.default_rng(18)
    live = pair.live()
    users = live[rng.integers(0, len(live), 80)]
    items = rng.integers(0, P, 80)
    want = np.asarray(JM.predict_pairs(jm, jnp.asarray(users, jnp.int32),
                                       jnp.asarray(items, jnp.int32)))
    got = MS.predict_pairs(pair.msst, torch.as_tensor(pair.sids(users)),
                           torch.as_tensor(items)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    jc = JM.compact_tombstones(jm)
    pair.compact()
    want = np.asarray(JM.predict_pairs(
        jc, jnp.asarray(pair.dense[users], jnp.int32),
        jnp.asarray(items, jnp.int32)))
    got = MS.predict_pairs(pair.msst, torch.as_tensor(pair.sids(users)),
                           torch.as_tensor(items)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_repair_merge_breaks_cross_shard_ties_by_rank():
    """Users duplicated across shards score exactly equal: a repaired
    row's list holds tied weights whose ids sit on different shards, in
    logical-rank order (not sharded-id order), as one device lists them."""
    r = _ratings(64, P, seed=3)
    r[40:48] = r[0:8]  # each twin on another shard of the 4
    r[56:64] = r[0:8]
    st = T.fit(T.RatingMatrix(torch.as_tensor(r), 64, P), _spec())
    pair = Pair(st, "data=4", _spec())
    pair.remove(np.array([1, 2]))
    pair.drain()
    assert pair.graphs_equal()
    c = pair.msst.capacity
    tied_across = 0
    for u in pair.live():
        s, sl = divmod(int(pair.sids(u)), c)
        g = pair.msst.sstate.graph[s]
        w, gi = g.weights[sl].numpy(), g.indices[sl].numpy().astype(int)
        ranks = pair.msst.rank.numpy()[gi]
        for j in range(len(w) - 1):
            if w[j] == w[j + 1] and w[j] != 0:
                assert ranks[j] < ranks[j + 1]
                tied_across += gi[j] // c != gi[j + 1] // c
    assert tied_across > 0
    _check(pair, np.random.default_rng(4))


def test_ineffective_ids_are_dropped():
    """Filler (-1), unfilled slots and tombstoned ids take no effect: the
    same state as a batch without them."""
    pair = Pair(_fit("cosine"), "pod=2,data=4", _spec())
    pair.remove(np.array([7]))
    c = pair.msst.capacity
    fills = pair.msst.sstate.n_valid
    bad = np.array([pair.sids(7), c - 1 if fills[0] < c else -1, -1,
                    pair.sids(9)])
    rows = _ratings(4, P, seed=9)
    m = MS.update_ratings_sharded(pair.msst, bad, rows, 4, _spec())
    want = MS.update_ratings_sharded(pair.msst, bad[3:], rows[3:], 1,
                                     _spec())
    for a, b in zip(m.sstate.ratings + m.sstate.representation,
                    want.sstate.ratings + want.sstate.representation):
        assert torch.equal(a, b)
    assert torch.equal(m.dirty, want.dirty)


def test_writes_leave_the_given_state_untouched():
    """Every write returns a new state; the published one keeps its bits
    (the engine serves reads from it while the write runs)."""
    pair = Pair(_fit("pearson"), "pod=2,data=4", _spec("pearson"))

    def snap(msst):
        sst = msst.sstate
        return [t.clone() for t in sst.ratings + sst.representation
                + [g.indices for g in sst.graph]
                + [g.weights for g in sst.graph]
                + [msst.tomb, msst.dirty, msst.rank]]

    for step in (lambda: pair.update(UPDATED, _ratings(4, P, seed=1)),
                 lambda: pair.remove(DEAD), pair.drain,
                 lambda: pair.fold(_ratings(9, P, seed=2)), pair.drain,
                 pair.compact):
        before = pair.msst
        kept = snap(before)
        step()
        assert all(torch.equal(a, b) for a, b in zip(kept, snap(before)))


def test_write_path_builds_no_row_space_tensor():
    """An update, a removal and a repair build no tensor of rows (two or
    more dimensions) with S·C rows or more: the payload stays in its
    shard's blocks. The replicated (S·C,) bitmaps and rank table are the
    only row-sized tensors, one entry a row."""
    pair = Pair(_fit("cosine"), "pod=2,data=4", _spec())
    msst = pair.msst
    rows_sc = msst.shard_count * msst.capacity
    assert rows_sc > 8 * msst.sstate.k  # a gather could not pass for one
    ids, sids = pair.padded(UPDATED)
    prows = np.zeros((8, P), np.float32)
    prows[:4] = _ratings(4, P, seed=3)
    out = []

    def run():
        m = MS.update_ratings_sharded(msst, sids, prows, 4, _spec())
        m = MS.remove_users_sharded(m, pair.padded(DEAD)[1], 8)
        out.append(MS.repair_sharded(m, 16, _spec()))

    n, bad = materializations(
        run, lambda shp: len(shp) > 1 and shp[0] >= rows_sc)
    assert n > 100 and bad == []
    assert out[0][1] > 0


def test_compaction_renumbers_slots_ranks_and_fills():
    pair = Pair(_fit("euclidean"), "pod=2,data=4", _spec("euclidean"))
    pair.remove(DEAD)
    with pytest.raises(ValueError, match="drain"):
        MS.compact_tombstones_sharded(pair.msst)
    pair.drain()
    before = pair.msst
    table, fills, new_rank = MS.compact_tables(before)
    pair.compact()
    after = pair.msst
    c = after.capacity
    assert after.sstate.n_valid == fills
    assert sum(fills) == U - len(DEAD) and after.capacity == before.capacity
    live = np.setdiff1d(np.arange(U), DEAD)
    ranks = after.rank.numpy()[pair.sids(live)]
    np.testing.assert_array_equal(ranks, np.arange(len(live)))
    for s in range(after.shard_count):  # rows never change owner
        moved = table[s * c:(s + 1) * c]
        assert ((moved // c == s) | (moved == 0)).all()
        assert torch.equal(after.sstate.row_rank[s].long(),
                           after.rank[s * c:(s + 1) * c])
    assert not after.tomb.any() and not after.dirty.any()


def test_holdout_snapshot_sharded_with_tomb():
    """The drift monitor on the mesh with the write path's bitmap: deleted
    users' triples leave the holdout and their rows every neighbor list,
    the one-device snapshot's MAE and RMSE exactly."""
    pair = Pair(_fit("cosine", seed=19), "pod=2,data=4", _spec())
    pair.remove(DEAD)
    pair.drain()
    mon = monitor.init_monitor(32, U, 0.5, "cpu")
    rng = np.random.default_rng(2)
    users, items = rng.integers(0, U, 40), rng.integers(0, P, 40)
    users[:6] = DEAD[:6]
    vals = rng.integers(1, 6, 40).astype(np.float32)
    mon = monitor.reservoir_add(mon, torch.Generator().manual_seed(0),
                                torch.as_tensor(users),
                                torch.as_tensor(items),
                                torch.as_tensor(vals), 40)
    id_map = pair.sids(np.arange(U))
    a = monitor.holdout_snapshot_sharded(mon, pair.msst.sstate, id_map,
                                         tomb=pair.msst.tomb,
                                         tombstone_frac=0.25)
    b = monitor.holdout_snapshot(mon, pair.one.bstate, tomb=pair.one.tomb)
    assert (a.mae, a.rmse, a.holdout_count) == (b.mae, b.rmse,
                                                b.holdout_count)
    assert a.tombstone_frac == 0.25
    untombed = monitor.holdout_snapshot_sharded(mon, pair.msst.sstate,
                                                id_map)
    assert untombed.mae != a.mae


def _index(mesh_name, seed=0, u=300, n=12):
    mesh, axes = _mesh(mesh_name)
    rep = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(u, n)).astype(np.float32))
    spec = R.resolve_ivf_sharded(R.IVFSpec(n_clusters=16), u, 8)
    idx = R.build_index(rep, spec, "cosine")
    return rep, spec, idx, R.shard_index(idx, mesh, axes)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("scorer", ["plain", "kernel", "fused"])
def test_search_sharded_with_tomb_at_full_probe(mesh_name, scorer):
    """``search_sharded(tomb=)`` at full probe is the one-device
    ``search(tomb=)`` bit for bit, with every scorer (``fused`` gives way
    to ``kernel`` under a tomb operand on both), and lists no tombstoned
    id."""
    rep, spec, idx, six = _index(mesh_name, seed=1)
    tomb = torch.zeros(300, dtype=torch.bool)
    tomb[torch.as_tensor(np.random.default_rng(2).choice(300, 40,
                                                          replace=False))] = 1
    q, sid = rep[:50], torch.arange(50, dtype=torch.int32)
    c = spec.n_clusters
    v1, i1 = R.search(idx, q, 13, c, "cosine", self_ids=sid, scorer=scorer,
                      tomb=tomb)
    v2, i2, _ = R.search_sharded(six, q, 13, c, "cosine", self_ids=sid,
                                 scorer=scorer, tomb=tomb)
    assert torch.equal(v1, v2)
    assert torch.equal(torch.where(torch.isinf(v1), 0, i1).to(torch.int32),
                       i2)
    assert not tomb[i2.long()][torch.isfinite(v2)].any()
    v3, i3, _ = R.search_sharded(six, q, 13, c, "cosine", self_ids=sid,
                                 scorer=scorer)
    assert not torch.equal(i2, i3)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_early_exit_sharded_with_tomb(mesh_name):
    """``search_early_exit_sharded(tomb=)`` at full probe without early
    exits: the one-device ``search_early_exit(tomb=)`` lists, and the
    exact sharded search's under the same tomb."""
    rep, spec, idx, six = _index(mesh_name, seed=4)
    tomb = torch.zeros(300, dtype=torch.bool)
    tomb[::7] = True
    q, sid = rep[:40], torch.arange(40, dtype=torch.int32)
    c = spec.n_clusters
    v1, i1, p1 = R.search_early_exit(idx, q, 13, c, "cosine", self_ids=sid,
                                     patience=c, tomb=tomb)
    v2, i2, p2 = R.search_early_exit_sharded(six, q, 13, c, "cosine",
                                             self_ids=sid, patience=c,
                                             tomb=tomb)
    assert torch.equal(v1, v2) and torch.equal(i1, i2)
    assert torch.equal(p1, p2)
    v3, i3, _ = R.search_sharded(six, q, 13, c, "cosine", self_ids=sid,
                                 tomb=tomb)
    assert torch.equal(v2, v3) and torch.equal(i2, i3)
    assert not tomb[i2.long()][torch.isfinite(v2)].any()
