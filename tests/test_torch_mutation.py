"""The port's write path (``repro_torch.mutation``) on the CPU, against the
reference's ``repro.mutation`` — the single-device cases of
``tests/test_mutation.py`` (the mesh ones wait for the multi-GPU slice).

Every operation starts both packages from the same reference state
(``core.convert.mutable_state_from_numpy``) and compares the port's output
with what the reference's function actually returns (not with a refit:
the reference's own update does not always reproduce one). The parity
rule: ratings, representation, landmarks, ``tomb`` and ``dirty`` bitwise;
graph lists within rtol=1e-5, atol=1e-6 with ids equal except where the
reference's weights tie within that tolerance at the cut
(``core.topk.list_mismatches``).
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import mutation as JM
from repro import retrieval as JR
from repro.core import graph as jgraph
from repro.core.landmark_cf import fit as jfit
from repro.core.types import LandmarkSpec as JSpec
from repro.core.types import NeighborGraph as JGraph
from repro.core.types import RatingMatrix as JRatings
from repro.data.synthetic import mutation_events as j_mutation_events
from repro.lifecycle import monitor as jmonitor
from repro_torch import mutation as TM
from repro_torch import retrieval as TR
from repro_torch.core import graph as tgraph
from repro_torch.core import knn
from repro_torch.core.convert import (ivf_index_from_numpy,
                                      mutable_state_from_numpy,
                                      mutable_state_to_numpy)
from repro_torch.core.graph import kernel_rows
from repro_torch.core.topk import canonical_topk, list_mismatches
from repro_torch.core.types import LandmarkSpec, NeighborGraph
from repro_torch.data.synthetic import mutation_events
from repro_torch.kernels import ops, ref
from repro_torch.lifecycle import monitor

RTOL, ATOL = 1e-5, 1e-6
U, P = 96, 40
MEASURES = ("cosine", "pearson", "euclidean")
DEAD = np.array([3, 8, 17, 20, 40, 41, 77, 95], np.int32)
OPS = ("update", "drain_update", "remove", "drain_remove", "compact",
       "fold_in")


def _ratings(u, p, seed=0, density=0.35):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    return r * (rng.random((u, p)) < density)


def _specs(d2="cosine", k=7, n=12):
    kw = dict(n_landmarks=n, selection="popularity", k_neighbors=k, d2=d2)
    return JSpec(**kw), LandmarkSpec(**kw)


def _to_np(jm):
    """A reference MutableState as numpy arrays under the converter's keys."""
    st = jm.bstate.state
    return {"landmark_idx": np.asarray(st.landmark_idx),
            "representation": np.asarray(st.representation),
            "ratings": np.asarray(st.ratings),
            "graph.indices": np.asarray(st.graph.indices),
            "graph.weights": np.asarray(st.graph.weights),
            "landmarks": np.asarray(jm.landmarks),
            "tomb": np.asarray(jm.tomb), "dirty": np.asarray(jm.dirty),
            "n_valid": int(jm.bstate.n_valid)}


def _port(jm):
    return mutable_state_from_numpy(_to_np(jm), device="cpu")


def _assert_parity(jm, tm):
    want, got = _to_np(jm), mutable_state_to_numpy(tm)
    assert got["n_valid"] == want["n_valid"]
    for key in ("ratings", "representation", "landmarks", "tomb", "dirty",
                "landmark_idx"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    bad = list_mismatches(want["graph.weights"], want["graph.indices"],
                          got["graph.weights"], got["graph.indices"],
                          RTOL, ATOL)
    assert bad.size == 0, f"graph rows {bad[:8]} beyond the tie rule"


def _update_batch(seed=2):
    """An 8-row padded update batch: 4 real rows (id 0 may be a landmark
    user, 95 the last row), filler id -1."""
    rng = np.random.default_rng(seed)
    ids = np.full(8, -1, np.int32)
    ids[:4] = [0, 3, 50, 95]
    rows = np.zeros((8, P), np.float32)
    rows[:4] = (rng.integers(0, 6, (4, P)) * (rng.random((4, P)) < 0.4))
    return ids, rows, 4


_CHAINS = {}


def _chain(d2):
    """The reference's states along update → drain → remove → drain →
    compact, and a fold-in after the removal, computed once per measure."""
    if d2 not in _CHAINS:
        js, _ = _specs(d2)
        st = jfit(jax.random.PRNGKey(0),
                  JRatings(jnp.asarray(_ratings(U, P, seed=1)), U, P), js)
        s = {"fitted": JM.from_fitted(st)}
        ids, rows, m = _update_batch()
        s["update"] = JM.update_ratings(s["fitted"], jnp.asarray(ids),
                                        jnp.asarray(rows), jnp.int32(m), js)
        s["drain_update"] = JM.drain_repairs(s["update"], js, bq=32)
        s["remove"] = JM.remove_users(s["drain_update"], jnp.asarray(DEAD),
                                      jnp.int32(8))
        s["drain_remove"] = JM.drain_repairs(s["remove"], js, bq=32)
        s["compact"] = JM.compact_tombstones(s["drain_remove"])
        s["fold_in"] = JM.fold_in_rows(s["remove"], _ratings(8, P, seed=8),
                                       8, js)
        _CHAINS[d2] = s
    return _CHAINS[d2]


INPUT_OF = {"update": "fitted", "drain_update": "update",
            "remove": "drain_update", "drain_remove": "remove",
            "compact": "drain_remove", "fold_in": "remove"}


def _port_op(op, tm, spec, **kw):
    if op == "update":
        ids, rows, m = _update_batch()
        return TM.update_ratings(tm, ids, rows, m, spec)
    if op.startswith("drain"):
        return TM.drain_repairs(tm, spec, bq=32, **kw)
    if op == "remove":
        return TM.remove_users(tm, DEAD, 8)
    if op == "compact":
        return TM.compact_tombstones(tm)
    return TM.fold_in_rows(tm, _ratings(8, P, seed=8), 8, spec)


def _tensors(tm):
    st = tm.bstate.state
    return (st.landmark_idx, st.representation, st.ratings, st.graph.indices,
            st.graph.weights, tm.landmarks, tm.tomb, tm.dirty)


# ------------------------------------------------------------ op by op
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("d2", MEASURES)
def test_op_matches_the_reference(d2, op):
    """Each write-path step from the reference's input state gives the
    reference's output state under the parity rule, and writes no tensor
    of its input (a published generation may still be serving reads)."""
    chain = _chain(d2)
    _, spec = _specs(d2)
    tm = _port(chain[INPUT_OF[op]])
    before = [t.clone() for t in _tensors(tm)]
    out = _port_op(op, tm, spec)
    _assert_parity(chain[op], out)
    for a, b in zip(before, _tensors(tm)):
        assert torch.equal(a, b), "a mutation wrote its input state"
    if op == "remove":  # erased and absent before any repair
        assert not out.bstate.state.ratings[DEAD].any()
        assert not out.bstate.state.representation[DEAD].any()
        _assert_no_tomb_citations(out, DEAD)
        assert out.tombstone_frac() == pytest.approx(8 / 96)
        assert out.n_live() == 88
    if op.startswith("drain") or op == "compact":
        assert out.dirty_count() == 0
    if op == "compact":
        assert out.tombstone_frac() == 0.0 and out.n_valid == 88


def _assert_no_tomb_citations(tm, dead):
    g = tm.bstate.state.graph
    gi, gw = g.indices.numpy(), g.weights.numpy()
    tomb = tm.tomb.numpy()
    live = np.nonzero(~tomb[:tm.n_valid])[0]
    cit = np.isin(gi[live], dead) & ~((gi[live] == 0) & (gw[live] == 0.0))
    assert not cit.any(), "tombstoned id cited by a live neighbor list"


@pytest.mark.parametrize("state", ["update", "remove"])
@pytest.mark.parametrize("d2", MEASURES)
def test_kernel_backend_rescan_on_the_cpu(d2, state):
    """The kernel backend's rescan arithmetic (live rows gathered, the scan
    kernel's plain version for k+1, ids mapped back, self dropped) agrees
    with the streaming masked rescan and with the reference's repair, with
    no tombstone and with 8 dead rows; and its lists are bitwise the same
    pipeline spelled out here."""
    chain = _chain(d2)
    _, spec = _specs(d2)
    tm = _port(chain[state])
    kern = TM.drain_repairs(tm, spec, bq=32, backend="kernel")
    stream = TM.drain_repairs(tm, spec, bq=32, backend="streaming")
    _assert_parity(chain["drain_" + state], kern)
    gk, gs = kern.bstate.state.graph, stream.bstate.state.graph
    # euclidean: the streaming epilogue's |u|² − 2z + |v|² cancels between
    # close rows (ROADMAP B3) where the kernel sums (u − v)² in one fixed
    # order; 2e-3 is B3's bound (tests/test_torch_graph.py, exact copies)
    atol = 2e-3 if d2 == "euclidean" else ATOL
    bad = list_mismatches(gs.weights, gs.indices, gk.weights, gk.indices,
                          RTOL, atol)
    assert bad.size == 0

    rep, tomb, k = tm.bstate.state.representation, tm.tomb, gk.k
    sel = torch.nonzero(tm.dirty & ~tomb
                        & (torch.arange(tm.capacity) < tm.n_valid)).flatten()
    live = torch.nonzero(~tomb[:tm.n_valid]).flatten()
    v, i = ref.foldin_topk_ref(kernel_rows(rep[sel], d2),
                               kernel_rows(rep[live], d2), k + 1, None,
                               live.numel(), d2)
    ids = torch.where(torch.isfinite(v), live[i.long()], 0).to(torch.int32)
    want = tgraph.finalize_topk(*tgraph.filter_self_from_topk(v, ids, sel,
                                                              k))
    assert torch.equal(gk.indices[sel], want.indices)
    assert torch.equal(gk.weights[sel], want.weights)


def test_kernel_rescan_raises_past_the_scan_kernels_list_length():
    """k+1 must fit the scan kernel's list (MAX_K): refused, never a
    silent plain rescan."""
    tm = _port(_chain("cosine")["update"])
    rep = tm.bstate.state.representation
    with pytest.raises(ValueError, match="k\\+1"):
        TM.mutate._rescan_kernel(rep[:2], rep, "cosine", 32, tm.n_valid,
                                 tm.tomb, torch.arange(2))


# ------------------------------------------------------ ineffective ids
@pytest.mark.parametrize("kind", ["update", "remove"])
def test_ineffective_ids_are_dropped(kind):
    """Filler, out-of-range, negative and tombstoned ids take no effect: a
    noisy batch gives bitwise the state of its one effective entry, and the
    reference's state for the same noisy batch."""
    js, spec = _specs()
    jbase = JM.remove_users(_chain("cosine")["fitted"],
                            jnp.arange(5, 13, dtype=jnp.int32), jnp.int32(8))
    base = _port(jbase)
    row = _ratings(1, P, seed=5, density=0.4)
    noisy = np.array([5, 10_000, -3, 7, 9, 0, 0, 0], np.int32)  # 9: dead
    clean = np.array([7, -1, -1, -1, -1, -1, -1, -1], np.int32)
    if kind == "update":
        rows = np.repeat(row, 8, axis=0)
        a = TM.update_ratings(base, noisy, rows, 5, spec)
        b = TM.update_ratings(base, clean, rows, 1, spec)
        want = JM.update_ratings(jbase, jnp.asarray(noisy),
                                 jnp.asarray(rows), jnp.int32(5), js)
        assert not a.bstate.state.ratings[5].any(), "resurrected a dead row"
    else:
        a = TM.remove_users(base, noisy, 5)
        b = TM.remove_users(base, clean, 1)
        want = JM.remove_users(jbase, jnp.asarray(noisy), jnp.int32(5))
    for x, y in zip(_tensors(a), _tensors(b)):
        assert torch.equal(x, y)
    _assert_parity(want, a)


def test_update_with_exact_ties_and_a_smallest_changed_id():
    """Duplicated users make exact-weight ties everywhere; updating user 0
    (smaller than every listed id) into a copy of another row makes the
    back-patch merge tie incumbents by value: the port gives the
    reference's lists, and after the drain the state equals the port's own
    build over the mutated matrix with the frozen basis."""
    js, spec = _specs("cosine", k=7, n=8)
    base = _ratings(24, P, seed=12)
    r = np.concatenate([base] * 4)  # every row four times over
    st = jfit(jax.random.PRNGKey(0), JRatings(jnp.asarray(r), U, P), js)
    jm = JM.from_fitted(st)
    ids = np.full(8, -1, np.int32)
    ids[:2] = [0, 30]
    rows = np.zeros((8, P), np.float32)
    rows[:2] = r[[5, 7]]
    want = JM.update_ratings(jm, jnp.asarray(ids), jnp.asarray(rows),
                             jnp.int32(2), js)
    got = TM.update_ratings(_port(jm), ids, rows, 2, spec)
    _assert_parity(want, got)
    _assert_parity(JM.drain_repairs(want, js, bq=32),
                   TM.drain_repairs(got, spec, bq=32))

    drained = TM.drain_repairs(got, spec, bq=32)
    rm = r.copy()
    rm[[0, 30]] = rows[:2]
    mat = torch.as_tensor(rm)
    rep = ops.masked_similarity(mat, drained.landmarks, spec.d1)
    oracle = tgraph.build_neighbor_graph(rep, spec.d2, spec.k_neighbors)
    st2 = drained.bstate.state
    assert torch.equal(st2.ratings[:U], mat)
    assert torch.equal(st2.representation[:U], rep)
    bad = list_mismatches(oracle.weights, oracle.indices,
                          st2.graph.weights[:U], st2.graph.indices[:U],
                          RTOL, ATOL)
    assert bad.size == 0


# ------------------------------------------------------- graph helpers
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_merge_canonical_topk_matches_full_sort(seed):
    """The rank-count merge of two canonical lists equals the canonical
    top-k of their concatenation and the reference's merge, on a small
    value alphabet (heavy ties) with ids disjoint across the lists."""
    rng = np.random.default_rng(seed)
    rows, ka, kb, k = 64, 7, 5, 7
    ids = np.stack([rng.choice(200, ka + kb, replace=False)
                    for _ in range(rows)]).astype(np.int32)
    ids[:8, ka] = 0  # a list-b id below every list-a id
    ids[:8, :ka] = np.where(ids[:8, :ka] == 0, 201, ids[:8, :ka])
    vals = rng.integers(0, 4, (rows, ka + kb)).astype(np.float32) / 2.0

    def canon(v, i):
        o = np.lexsort((i, -v), axis=-1)
        return (np.take_along_axis(v, o, axis=-1),
                np.take_along_axis(i, o, axis=-1))

    av, ai = canon(vals[:, :ka], ids[:, :ka])
    bv, bi = canon(vals[:, ka:], ids[:, ka:])
    mv, mi = tgraph.merge_canonical_topk(*map(torch.as_tensor,
                                              (av, ai, bv, bi)), k)
    rv, ri = canonical_topk(torch.as_tensor(vals), k,
                            ids=torch.as_tensor(ids))
    assert torch.equal(mv, rv) and torch.equal(mi, ri)
    jv, ji = jgraph.merge_canonical_topk(*map(jnp.asarray,
                                              (av, ai, bv, bi)), k)
    np.testing.assert_array_equal(mv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))


def _graph_with_inert(seed):
    rng = np.random.default_rng(seed)
    rows, k = 48, 6
    vals = np.sort(rng.integers(-2, 4, (rows, k)).astype(np.float32) / 2.0,
                   axis=1)[:, ::-1].copy()
    ids = np.stack([rng.choice(np.arange(1, 60), k, replace=False)
                    for _ in range(rows)]).astype(np.int32)
    o = np.lexsort((ids, -vals), axis=-1)
    vals = np.take_along_axis(vals, o, axis=-1)
    ids = np.take_along_axis(ids, o, axis=-1)
    ids[::5, -1], vals[::5, -1] = 0, 0.0  # inert tail slots
    return ids, vals


@pytest.mark.parametrize("dead0", [False, True])
def test_evict_neighbors_matches_the_reference(dead0):
    """Evicting dead ids keeps the survivors' canonical order, makes
    emptied slots inert and flags the rows that lost an entry; a dead
    row 0 flags every row holding an inert slot, as in the reference."""
    ids, vals = _graph_with_inert(3)
    dead = np.zeros(64, bool)
    dead[[4, 9, 17, 33, 58]] = True
    dead[0] = dead0
    g, hit = tgraph.evict_neighbors(NeighborGraph(torch.as_tensor(ids),
                                                  torch.as_tensor(vals)),
                                    torch.as_tensor(dead))
    jg, jhit = jgraph.evict_neighbors(JGraph(jnp.asarray(ids),
                                             jnp.asarray(vals)),
                                      jnp.asarray(dead))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(g.indices.numpy(), np.asarray(jg.indices))
    np.testing.assert_array_equal(g.weights.numpy(), np.asarray(jg.weights))
    assert hit.any()


def test_filter_self_from_topk_matches_the_reference():
    rng = np.random.default_rng(4)
    rows, k = 40, 6
    vals = -np.sort(-rng.integers(0, 3, (rows, k + 1)).astype(np.float32),
                    axis=1)
    idx = np.stack([rng.choice(50, k + 1, replace=False)
                    for _ in range(rows)]).astype(np.int32)
    row_ids = np.where(rng.random(rows) < 0.7, idx[np.arange(rows),
                       rng.integers(0, k + 1, rows)], 99).astype(np.int32)
    v, i = tgraph.filter_self_from_topk(torch.as_tensor(vals),
                                        torch.as_tensor(idx),
                                        torch.as_tensor(row_ids), k)
    jv, ji = jgraph.filter_self_from_topk(jnp.asarray(vals), jnp.asarray(idx),
                                          jnp.asarray(row_ids), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert not (i.numpy() == row_ids[:, None]).any()


def test_remap_matches_the_reference():
    ids, vals = _graph_with_inert(5)
    ids[1, 2], vals[1, 2] = 0, 0.5  # a genuine citation of row 0
    table = np.random.default_rng(6).permutation(64).astype(np.int32)
    got = NeighborGraph(torch.as_tensor(ids),
                        torch.as_tensor(vals)).remap(torch.as_tensor(table))
    want = JGraph(jnp.asarray(ids), jnp.asarray(vals)).remap(
        jnp.asarray(table))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    assert got.indices.dtype == torch.int32
    assert torch.equal(got.weights, torch.as_tensor(vals))


@pytest.mark.parametrize("payload", ["f32", "int8"])
def test_purge_matches_the_reference(payload):
    rep = np.random.default_rng(7).normal(size=(120, 12)).astype(np.float32)
    spec = JR.resolve_ivf(JR.IVFSpec(n_clusters=8, payload_dtype=payload),
                          120)
    jidx = JR.build_index(jnp.asarray(rep), spec, "cosine",
                          key=jax.random.PRNGKey(0))
    tomb = np.zeros(120, bool)
    tomb[np.random.default_rng(8).choice(120, 30, replace=False)] = True
    want = JR.purge(jidx, jnp.asarray(tomb))
    fields = [f.name for f in dataclasses.fields(JR.IVFIndex)]
    idx = ivf_index_from_numpy(
        {key: (None if getattr(jidx, key) is None
               else np.asarray(getattr(jidx, key))) for key in fields},
        device="cpu")
    got = TR.purge(idx, torch.as_tensor(tomb))
    for key in fields:
        w = getattr(want, key)
        if w is None:
            assert getattr(got, key) is None
            continue
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(w), err_msg=key)
    assert int(got.fill.sum()) == 90


@pytest.mark.parametrize("seed,wave", [(13, 0), (13, 5), (0, 1), (7, 31)])
def test_mutation_events_bitwise_the_reference(seed, wave):
    kw = dict(n_events=8, rerate_frac=0.3, unrate_frac=0.2, delete_frac=0.5)
    got = mutation_events(seed, wave, 256, 96, **kw)
    want = j_mutation_events(seed, wave, 256, 96, **kw)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


# -------------------------------------------------------- fold and IVF
def test_fold_in_mutable_excludes_tombstoned_candidates():
    """A fold-in after removals must not cite tombstones — euclidean is the
    trap: a zeroed representation still scores positive. The folded rows
    serve finite predictions."""
    js, spec = _specs("euclidean")
    st = jfit(jax.random.PRNGKey(0),
              JRatings(jnp.asarray(_ratings(U, P, seed=7)), U, P), js)
    dead = np.arange(8, dtype=np.int32)
    jm = JM.remove_users(JM.from_fitted(st), jnp.asarray(dead), jnp.int32(8))
    new_rows = _ratings(8, P, seed=8)
    tm = TM.fold_in_rows(_port(jm), new_rows, 8, spec)
    _assert_parity(JM.fold_in_rows(jm, new_rows, 8, js), tm)
    _assert_no_tomb_citations(tm, dead)
    tm = TM.drain_repairs(tm, spec, bq=32)
    _assert_no_tomb_citations(tm, dead)
    preds = TM.predict_pairs(tm, torch.arange(U, U + 8),
                             torch.arange(8))
    assert torch.isfinite(preds).all()


@pytest.mark.parametrize("nprobe", [None, 3])
def test_repair_through_an_ivf_index(nprobe):
    """The IVF-backed repair gives the reference's (same index, converted);
    at full probe (None) it also agrees with the port's own rescan."""
    js, spec = _specs("cosine", k=5, n=8)
    st = jfit(jax.random.PRNGKey(0),
              JRatings(jnp.asarray(_ratings(U, P, seed=9)), U, P), js)
    jm = JM.from_fitted(st)
    ids = np.full(8, -1, np.int32)
    ids[:3] = [5, 30, 60]
    rows = np.zeros((8, P), np.float32)
    rows[:3] = _ratings(3, P, seed=10)
    jm = JM.update_ratings(jm, jnp.asarray(ids), jnp.asarray(rows),
                           jnp.int32(3), js)
    jm = JM.remove_users(jm, jnp.asarray(DEAD), jnp.int32(8))
    ivf_spec = JR.resolve_ivf(JR.IVFSpec(n_clusters=8, nprobe=8),
                              jm.capacity)
    jidx = JR.build_index(jm.bstate.state.representation, ivf_spec, "cosine",
                          n_valid=jm.bstate.n_valid,
                          key=jax.random.PRNGKey(0))
    fields = [f.name for f in dataclasses.fields(JR.IVFIndex)]
    idx = ivf_index_from_numpy(
        {key: (None if getattr(jidx, key) is None
               else np.asarray(getattr(jidx, key))) for key in fields},
        device="cpu")
    got = TM.drain_repairs(_port(jm), spec, bq=16, ivf_index=idx,
                           nprobe=nprobe)
    _assert_parity(JM.drain_repairs(jm, js, bq=16, ivf_index=jidx,
                                    nprobe=nprobe), got)
    _assert_no_tomb_citations(got, DEAD)
    if nprobe is None:
        _assert_parity(JM.drain_repairs(jm, js, bq=16),
                       TM.drain_repairs(_port(jm), spec, bq=16))


@pytest.mark.parametrize("scorer", ["fused", "kernel"])
def test_tombstone_search_takes_the_gathered_scorer(scorer, monkeypatch):
    """A tombstone-masked partial-probe search gives way from the fused
    kernel (which takes no tombstones) to the gathered scorer — the kernel
    wrapper, never the plain sums — and lists no tombstoned id."""
    from repro_torch.retrieval import index as tindex

    rep = torch.as_tensor(np.random.default_rng(16).normal(
        size=(120, 12)).astype(np.float32))
    idx = TR.build_index(rep, TR.resolve_ivf(TR.IVFSpec(n_clusters=8), 120),
                         "cosine")
    tomb = torch.zeros(120, dtype=torch.bool)
    tomb[::7] = True
    calls = []
    real = tindex.score_candidates
    monkeypatch.setattr(tindex, "score_candidates",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    vals, ids = TR.search(idx, rep[:16], 5, 3, "cosine",
                          self_ids=torch.arange(16), tomb=tomb,
                          scorer=scorer)
    assert calls, "the gathered scorer did not run"
    hit = torch.isfinite(vals)
    assert not tomb[ids[hit].long()].any()


# -------------------------------------------------------------- reads
@pytest.mark.parametrize("d2", MEASURES)
def test_reads_mask_tombstones_as_the_reference(d2):
    """Pair and top-N reads after a removal (before any repair) match the
    reference's ``mutation.predict_pairs`` / ``recommend_topn``; with no
    tombstone the tomb operand changes no bit of the plain graph reads."""
    chain = _chain(d2)
    jm, tm = chain["remove"], _port(chain["remove"])
    rng = np.random.default_rng(14)
    users = rng.integers(0, U, 32).astype(np.int32)
    items = rng.integers(0, P, 32).astype(np.int32)
    got = TM.predict_pairs(tm, torch.as_tensor(users), torch.as_tensor(items))
    want = JM.predict_pairs(jm, jnp.asarray(users), jnp.asarray(items))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    ti, ts = TM.recommend_topn(tm, torch.as_tensor(users), n=5)
    ji, js_ = JM.recommend_topn(jm, jnp.asarray(users), n=5)
    bad = list_mismatches(np.asarray(js_), np.asarray(ji), ts, ti, RTOL, ATOL)
    assert bad.size == 0

    clean = _port(chain["drain_update"])
    st = clean.bstate.state
    u, it = torch.as_tensor(users), torch.as_tensor(items)
    assert torch.equal(
        knn.predict_pairs_graph(st.graph, st.ratings, u, it,
                                n_valid=clean.n_valid),
        knn.predict_pairs_graph(st.graph, st.ratings, u, it,
                                n_valid=clean.n_valid, tomb=clean.tomb))
    for x, y in zip(
            knn.recommend_topn_graph(st.graph, st.ratings, u, n=5,
                                     n_valid=clean.n_valid),
            knn.recommend_topn_graph(st.graph, st.ratings, u, n=5,
                                     n_valid=clean.n_valid,
                                     tomb=clean.tomb)):
        assert torch.equal(x, y)


def test_holdout_snapshot_drops_deleted_users_as_the_reference():
    """The drift monitor's holdout with a tomb bitmap: deleted users'
    triples leave the count and their rows every neighbor list."""
    chain = _chain("cosine")
    jm, tm = chain["remove"], _port(chain["remove"])
    rng = np.random.default_rng(15)
    r_cap, filled = 64, 50
    users = rng.integers(0, U, r_cap).astype(np.int32)
    users[:6] = DEAD[:6]
    items = rng.integers(0, P, r_cap).astype(np.int32)
    vals = rng.integers(1, 6, r_cap).astype(np.float32)
    mon = dataclasses.replace(
        monitor.init_monitor(r_cap, U, 0.5, device="cpu"),
        res_users=torch.as_tensor(users), res_items=torch.as_tensor(items),
        res_ratings=torch.as_tensor(vals), res_filled=filled)
    jmon = dataclasses.replace(
        jmonitor.init_monitor(r_cap, U, 0.5),
        res_users=jnp.asarray(users), res_items=jnp.asarray(items),
        res_ratings=jnp.asarray(vals), res_filled=jnp.int32(filled))
    got = monitor.holdout_snapshot(mon, tm.bstate, tomb=tm.tomb,
                                   tombstone_frac=tm.tombstone_frac())
    want = jmonitor.holdout_snapshot(jmon, jm.bstate, tomb=jm.tomb,
                                     tombstone_frac=jm.tombstone_frac())
    assert got.holdout_count == want.holdout_count == filled
    assert got.tombstone_frac == pytest.approx(want.tombstone_frac)
    assert got.mae == pytest.approx(want.mae, rel=RTOL, abs=ATOL)
    assert got.rmse == pytest.approx(want.rmse, rel=RTOL, abs=ATOL)
    plain = monitor.holdout_snapshot(mon, tm.bstate)
    assert plain.mae != got.mae  # the deleted users' triples counted
