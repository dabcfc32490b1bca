"""Parity of the port's IVF retrieval (``repro_torch.retrieval``) with the
JAX reference, on the CPU.

The same numpy inputs go through both packages. Where the reference draws
from ``jax.random`` (the k-means initialization), its centroids are handed
to the port (``kmeans(init=...)``, ``build_index(centroids=...)``), so the
two pack around the same quantizer. The port's kernel wrappers run their
plain versions on CPU tensors; the reference's Pallas kernels run in
interpret mode.

Tolerances:
- scores: rtol=1e-5, atol=1e-6 (f32 sums in different orders);
- ids and assignments: equal, except where the reference's own scores tie
  within that tolerance at the cut (``core.topk.list_mismatches``);
- posting lists built or appended from the same centroids: ids, fills and
  payload rows equal (f32 and bf16 bitwise, int8 codes and scales equal);
- k-means over eight Lloyd steps from the reference's initialization:
  centroids bitwise equal (on the CPU ``index_add_`` adds each cell's
  members in ascending row order, as ``jax.ops.segment_sum`` does) and
  assignments equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.retrieval as JR
from repro.retrieval.index import score_candidates_kernel
from repro.retrieval.kmeans import assign_clusters_kernel
from repro.retrieval.kmeans import init_centroids as j_init_centroids
from repro.retrieval.kmeans import kmeans as j_kmeans
import repro_torch.core as T
import repro_torch.retrieval as R
from repro_torch.core.convert import ivf_index_from_numpy, ivf_index_to_numpy
from repro_torch.core.graph import kernel_rows, resolve_backend
from repro_torch.core.topk import list_mismatches
from repro_torch.kernels import ref

RTOL, ATOL = 1e-5, 1e-6
MEASURES = T.MEASURES


def _rep(u, n, seed=0):
    return np.random.default_rng(seed).normal(size=(u, n)).astype(np.float32)


def _port(jidx):
    """A reference IVFIndex as the port's (CPU)."""
    fields = [f.name for f in dataclasses.fields(R.IVFIndex)]
    return ivf_index_from_numpy(
        {key: (None if getattr(jidx, key) is None
               else np.asarray(getattr(jidx, key))) for key in fields},
        device="cpu")


def _jax_index(rep, measure, c=8, payload="f32", n_valid=None, seed=0):
    spec = JR.resolve_ivf(JR.IVFSpec(n_clusters=c, payload_dtype=payload),
                          rep.shape[0])
    nv = None if n_valid is None else jnp.int32(n_valid)
    return spec, JR.build_index(jnp.asarray(rep), spec, measure, n_valid=nv,
                                key=jax.random.PRNGKey(seed))


def _assert_lists_agree(ref_v, ref_i, v, i):
    bad = list_mismatches(np.asarray(ref_v), np.asarray(ref_i), v, i, RTOL,
                          ATOL)
    assert bad.size == 0, f"rows disagree beyond the tie rule: {bad[:10]}"


def _assert_same_index(jidx, idx):
    np.testing.assert_array_equal(np.asarray(jidx.lists),
                                  idx.lists.numpy())
    np.testing.assert_array_equal(np.asarray(jidx.fill), idx.fill.numpy())
    got = ivf_index_to_numpy(idx)
    want = np.asarray(jidx.rows)
    if want.dtype.name == "bfloat16":
        want = want.view(np.uint16)
    np.testing.assert_array_equal(want, got["rows"])
    if jidx.scale is None:
        assert idx.scale is None
    else:
        np.testing.assert_array_equal(np.asarray(jidx.scale),
                                      idx.scale.numpy())


# ------------------------------------------------------- kernel 4: assign
@pytest.mark.parametrize("measure", MEASURES)
def test_assign_kernel_plain_version_matches_reference_kernel(measure):
    """Kernel 4's plain version against ``assign_clusters_kernel`` in
    interpret mode, on the same (normalized for cosine) rows: equal ids."""
    rep, cent = _rep(200, 12, seed=1), _rep(11, 12, seed=2)
    want = assign_clusters_kernel(
        jnp.asarray(kernel_rows(torch.as_tensor(rep), measure).numpy()),
        jnp.asarray(kernel_rows(torch.as_tensor(cent), measure).numpy()),
        measure, interpret=True)
    for backend in ("kernel", "auto", "plain"):
        got = R.assign_clusters(torch.as_tensor(rep), torch.as_tensor(cent),
                                measure, backend)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("measure", MEASURES)
def test_kmeans_from_reference_init_within_tolerance(measure):
    """One assignment from the reference's centroids is equal; the whole
    k-means from its initialization gives bitwise the same centroids."""
    u, c = 160, 6
    rep = _rep(u, 10, seed=3)
    key = jax.random.PRNGKey(4)
    init = np.asarray(j_init_centroids(key, jnp.asarray(rep), c,
                                        jnp.int32(150)))
    for iters in (0, 1, 8):
        jc, ja = j_kmeans(key, jnp.asarray(rep), c, measure, iters=iters,
                           n_valid=jnp.int32(150), backend="jnp")
        pc, pa = R.kmeans(torch.as_tensor(rep), c, measure, iters=iters,
                          n_valid=150, init=torch.as_tensor(init))
        np.testing.assert_array_equal(pc.numpy().view(np.int32),
                                      np.asarray(jc).view(np.int32))
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))


def test_kmeans_is_deterministic_per_generator_seed():
    rep = torch.as_tensor(_rep(120, 8, seed=5))
    a = R.kmeans(rep, 7, generator=torch.Generator().manual_seed(3))
    b = R.kmeans(rep, 7, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.isfinite(a[0]).all() and a[0].shape == (7, 8)
    cent = R.init_centroids(torch.Generator().manual_seed(0), rep, 7, 100)
    rows = {tuple(r) for r in rep[:100].tolist()}
    assert all(tuple(r) in rows for r in cent.tolist())  # valid rows only
    assert len({tuple(r) for r in cent.tolist()}) == 7  # distinct


# --------------------------------------------------- build / append parity
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("payload", ["f32", "bf16", "int8"])
def test_build_index_from_reference_centroids_is_equal(measure, payload):
    rep = _rep(150, 12, seed=6)
    spec, jidx = _jax_index(rep, measure, payload=payload, n_valid=140)
    pspec = R.resolve_ivf(R.IVFSpec(n_clusters=8, payload_dtype=payload), 150)
    for field in ("n_clusters", "nprobe", "iters", "slack", "spill_choices",
                  "seed", "payload_dtype"):
        assert getattr(pspec, field) == getattr(spec, field), field
    idx = R.build_index(torch.as_tensor(rep), pspec, measure, n_valid=140,
                        centroids=torch.as_tensor(np.asarray(jidx.centroids)))
    _assert_same_index(jidx, idx)
    ids = sorted(int(i) for c in range(8)
                 for i in idx.lists[c, :int(idx.fill[c])])
    assert ids == list(range(140))  # every valid row exactly once


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("spill", [0, 2])
def test_append_matches_reference_through_overflow(measure, spill):
    """Appends into a tight index (cap 8 per cell for 60 rows in 8 cells),
    so rows overflow into next-nearest cells and, with a two-cell
    preference depth, into the free-slot spill: equal lists and fills."""
    rep = _rep(60, 10, seed=7)
    spec = JR.resolve_ivf(JR.IVFSpec(n_clusters=8, slack=1.0), 40)
    jidx = JR.build_index(jnp.asarray(rep[:40]), spec, measure,
                          key=jax.random.PRNGKey(0))
    idx = _port(jidx)
    new, ids = rep[40:], np.arange(40, 60, dtype=np.int32)
    jout = JR.append(jidx, jnp.asarray(new), jnp.asarray(ids), measure,
                     b_valid=jnp.int32(18), spill_choices=spill)
    out = R.append(idx, torch.as_tensor(new), torch.as_tensor(ids), measure,
                   b_valid=18, spill_choices=spill)
    _assert_same_index(jout, out)
    assert int(out.fill.sum()) == 58


def test_capacity_regrow_keeps_search_results():
    rep = torch.as_tensor(_rep(90, 8, seed=8))
    spec = R.resolve_ivf(R.IVFSpec(n_clusters=6), 90)
    idx = R.build_index(rep, spec)
    grown, grew = R.ensure_index_capacity(idx, 200)
    assert grew and grown.capacity >= int(idx.fill.max()) + 200
    assert grown.capacity % 8 == 0
    same, grew2 = R.ensure_index_capacity(idx, 0)
    assert not grew2 and same is idx
    for a, b in zip(R.search(idx, rep, 5, 3), R.search(grown, rep, 5, 3)):
        assert torch.equal(a, b)


def test_compact_index_roundtrip_and_search_identical():
    rep = torch.as_tensor(_rep(70, 8, seed=9))
    idx = R.build_index(rep, R.resolve_ivf(R.IVFSpec(n_clusters=5), 70))
    small = idx.to_compact()
    assert small.is_compact and small.lists.dtype == torch.uint16
    assert torch.equal(small.to_full().lists, idx.lists)
    for scorer in ("plain", "fused"):
        a = R.search(idx, rep, 6, 2, scorer=scorer)
        b = R.search(small, rep, 6, 2, scorer=scorer)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("payload", ["bf16", "int8"])
def test_quantize_payload_matches_reference(payload):
    """Against the compiled reference, as its build and append run it."""
    x = _rep(400, 12, seed=10)
    x[3] = 0.0  # a zero row: scale 0, codes 0
    jq, js = jax.jit(JR.quantize_payload, static_argnums=1)(jnp.asarray(x),
                                                            payload)
    q, s = R.quantize_payload(torch.as_tensor(x), payload)
    if payload == "bf16":
        np.testing.assert_array_equal(np.asarray(jq).view(np.uint16),
                                      q.view(torch.int16).numpy().view(
                                          np.uint16))
    else:
        np.testing.assert_array_equal(np.asarray(jq), q.numpy())
        np.testing.assert_array_equal(np.asarray(js), s.numpy())
        np.testing.assert_array_equal(
            np.asarray(JR.dequantize_payload(jq, js)),
            R.dequantize_payload(q, s).numpy())


# ------------------------------------------------------------------ search
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("scorer,jscorer", [("plain", "jnp"),
                                            ("kernel", "pallas"),
                                            ("fused", "fused")])
@pytest.mark.parametrize("nprobe", [3, 8])
def test_search_matches_reference(measure, scorer, jscorer, nprobe):
    """Every scorer against its reference counterpart on one index, at a
    partial and at full probe; ids under the tie rule."""
    rep = _rep(120, 12, seed=11)
    _, jidx = _jax_index(rep, measure)
    idx = _port(jidx)
    q = rep[::8]  # 15 queries (the fused reference runs in interpret mode)
    sids = np.arange(0, 120, 8, dtype=np.int32)
    jv, ji = JR.search(jidx, jnp.asarray(q), 9, nprobe, measure,
                       self_ids=jnp.asarray(sids), scorer=jscorer)
    v, i = R.search(idx, torch.as_tensor(q), 9, nprobe, measure,
                    self_ids=torch.as_tensor(sids), scorer=scorer)
    _assert_lists_agree(jv, ji, v, i)
    assert not (i == torch.as_tensor(sids)[:, None]).any()  # self excluded


@pytest.mark.parametrize("measure", MEASURES)
def test_full_probe_equals_streaming_under_the_tie_rule(measure):
    """At nprobe == C every scorer is exact: the streaming backend's lists
    up to near-ties within 1e-5 of the cut."""
    u, k = 150, 9
    rep = torch.as_tensor(_rep(u, 12, seed=12))
    idx = R.build_index(rep, R.resolve_ivf(R.IVFSpec(), u), measure)
    sv, si = T.streaming_knn_graph(rep, measure, k=k, chunk=64,
                                   exclude_self=True)
    for scorer in ("plain", "kernel", "fused"):
        v, i = R.search(idx, rep, k, idx.n_clusters, measure,
                        self_ids=torch.arange(u), scorer=scorer, qb=40)
        _assert_lists_agree(sv, si, v, i)


@pytest.mark.parametrize("measure", MEASURES)
def test_search_early_exit_matches_reference(measure):
    rep = _rep(120, 12, seed=13)
    _, jidx = _jax_index(rep, measure)
    idx = _port(jidx)
    q, sids = rep[1::6], np.arange(1, 120, 6, dtype=np.int32)
    jv, ji, jp = JR.search_early_exit(jidx, jnp.asarray(q), 9, 6, measure,
                                      self_ids=jnp.asarray(sids))
    v, i, p = R.search_early_exit(idx, torch.as_tensor(q), 9, 6, measure,
                                  self_ids=torch.as_tensor(sids))
    _assert_lists_agree(jv, ji, v, i)
    np.testing.assert_array_equal(np.asarray(jp), p.numpy())
    assert (p <= 6).all() and (p >= 2).all()  # patience 2 bounds it below
    # with every probe taken, the early-exit merge is the plain search
    v8, i8, p8 = R.search_early_exit(idx, torch.as_tensor(q), 9, 8, measure,
                                     self_ids=torch.as_tensor(sids),
                                     patience=100)
    pv, pi = R.search(idx, torch.as_tensor(q), 9, 8, measure,
                      self_ids=torch.as_tensor(sids), scorer="plain")
    _assert_lists_agree(pv, pi, v8, i8)
    assert (p8 == 8).all()


def test_recall_at_k_matches_reference():
    rng = np.random.default_rng(14)
    want = rng.integers(0, 30, (12, 5)).astype(np.int32)
    got = want.copy()
    got[:6, :2] = rng.integers(30, 60, (6, 2))
    wv = rng.random((12, 5)).astype(np.float32)
    wv[0, 3:] = -np.inf
    gv = rng.random((12, 5)).astype(np.float32)
    gv[1, :1] = -np.inf
    want_r = float(JR.recall_at_k(jnp.asarray(got), jnp.asarray(want),
                                  jnp.asarray(gv), jnp.asarray(wv)))
    got_r = R.recall_at_k(*(torch.as_tensor(x) for x in (got, want, gv, wv)))
    assert got_r == pytest.approx(want_r, rel=1e-6)
    assert R.recall_at_k(torch.as_tensor(want), torch.as_tensor(want)) == 1.0


# ----------------------------------------------------- kernel 6: the scorer
@pytest.mark.parametrize("measure", MEASURES)
def test_score_kernel_plain_version_matches_reference_kernel(measure):
    q = _rep(9, 16, seed=15)
    cand = _rep(9 * 37, 16, seed=16).reshape(9, 37, 16)
    want = score_candidates_kernel(jnp.asarray(q), jnp.asarray(cand), measure,
                                   interpret=True)
    got = ref.score_candidates_ref(torch.as_tensor(q), torch.as_tensor(cand),
                                   measure)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------------ graph wiring
@pytest.mark.parametrize("measure", MEASURES)
def test_extend_graph_ivf_matches_reference(measure):
    """``extend_neighbor_graph(backend="ivf")`` on the reference's index
    (new-vs-all through append + search, then the back-patch)."""
    rep = _rep(110, 12, seed=17)
    old, new = rep[:96], rep[96:]
    spec, jidx = _jax_index(old, measure, c=8)
    jg = J.build_neighbor_graph(jnp.asarray(old), measure, 7,
                                backend="streaming")
    ivf = JR.IVFSpec(n_clusters=8, nprobe=4)
    want = J.extend_neighbor_graph(jg, jnp.asarray(old), jnp.asarray(new),
                                   measure, backend="ivf", ivf=ivf,
                                   ivf_index=jidx)
    g = T.NeighborGraph(torch.as_tensor(np.asarray(jg.indices)),
                        torch.as_tensor(np.asarray(jg.weights)))
    got = T.extend_neighbor_graph(
        g, torch.as_tensor(old), torch.as_tensor(new), measure,
        backend="ivf", ivf=R.IVFSpec(n_clusters=8, nprobe=4),
        ivf_index=_port(jidx))
    _assert_lists_agree(want.weights, want.indices, got.weights, got.indices)


@pytest.mark.parametrize("measure", MEASURES)
def test_ivf_graph_and_fold_in_at_full_probe_equal_streaming(measure):
    """The ``ivf`` graph backend at nprobe == C equals the streaming build,
    and a full-probe ivf fold-in equals a streaming fold-in (the index is
    filled past its capacity, so the in-call regrow runs)."""
    r = np.random.default_rng(18).integers(1, 6, (140, 40)).astype(np.float32)
    r *= np.random.default_rng(19).random((140, 40)) < 0.4
    spec = T.LandmarkSpec(n_landmarks=8, k_neighbors=6, d2=measure)
    full = R.IVFSpec(n_clusters=5, nprobe=5, slack=1.0)
    a = T.fit(T.RatingMatrix(torch.as_tensor(r[:100]), 100, 40), spec,
              backend="ivf", ivf=full)
    b = T.fit(T.RatingMatrix(torch.as_tensor(r[:100]), 100, 40), spec,
              backend="streaming")
    _assert_lists_agree(b.graph.weights, b.graph.indices, a.graph.weights,
                        a.graph.indices)
    index = R.build_index(a.representation, R.resolve_ivf(full, 100),
                          measure)
    fa = T.fold_in(a, torch.as_tensor(r[100:]), spec, backend="ivf",
                   ivf=full, ivf_index=index)
    fb = T.fold_in(b, torch.as_tensor(r[100:]), spec, backend="streaming")
    _assert_lists_agree(fb.graph.weights, fb.graph.indices, fa.graph.weights,
                        fa.graph.indices)
    assert index.capacity * index.n_clusters < 140  # the regrow was needed


def test_backends_resolve_by_the_tensor_device():
    assert R.resolve_assign_backend("auto", "cpu") == "plain"
    assert R.resolve_assign_backend("auto", torch.device("cuda")) == "kernel"
    assert R.resolve_scorer("auto", "cpu") == "plain"
    assert R.resolve_scorer("auto", torch.device("cuda")) == "fused"
    assert R.resolve_scorer("kernel", "cpu") == "kernel"
    assert resolve_backend("ivf", "cpu") == "ivf"
    with pytest.raises(ValueError, match="unknown scorer"):
        R.resolve_scorer("pallas", "cpu")
    with pytest.raises(ValueError, match="unknown assignment backend"):
        R.resolve_assign_backend("jnp", "cpu")
    with pytest.raises(ValueError, match="resolved"):
        R.build_index(torch.zeros((4, 2)), R.IVFSpec())


def test_score_recall_counts_exact_ties_as_hits():
    """An equally scored neighbor in place of the exact list's tie: a miss
    by id, a hit by score; a worse score is a miss both ways; an exact
    list with fewer than k entries shrinks the denominator."""
    inf = float("inf")
    want_v = torch.tensor([[0.9, 0.8, 0.8], [0.7, -inf, -inf]])
    want_i = torch.tensor([[1, 2, 3], [5, 0, 0]])
    got_v = torch.tensor([[0.9, 0.8, 0.8], [0.7, -inf, -inf]])
    got_i = torch.tensor([[1, 2, 4], [5, 0, 0]])
    assert R.recall_at_k(got_i, want_i, got_v, want_v) == pytest.approx(
        (2 / 3 + 1) / 2)
    assert R.score_recall_at_k(got_v, want_v) == 1.0
    worse = torch.tensor([[0.9, 0.8, 0.7], [0.6, -inf, -inf]])
    assert R.score_recall_at_k(worse, want_v) == pytest.approx((2 / 3) / 2)


@pytest.mark.parametrize("measure", MEASURES)
def test_plain_scores_a_pair_alike_at_every_nprobe(measure):
    """The plain scorer sums a (query, candidate) pair in one order at
    partial and at full probe: every listed score is bitwise the pair's
    ``gathered_sims``. On near-parallel rows, whose top-k scores lie a few
    ulps apart, another order at full probe would make the exact search
    disagree with every partial probe by rounding alone."""
    rng = np.random.default_rng(21)
    rep = (rng.normal(size=12) + 1e-3 * rng.normal(size=(150, 12))
           ).astype(np.float32)
    rep_t = torch.as_tensor(rep)
    idx = R.build_index(rep_t, R.resolve_ivf(R.IVFSpec(n_clusters=8), 150),
                        measure)
    q, sids = rep_t[:40], torch.arange(40)
    for nprobe in (3, 8):
        v, i = R.search(idx, q, 9, nprobe, measure, self_ids=sids,
                        scorer="plain")
        assert torch.isfinite(v).all()
        want = ref.gathered_sims(q, rep_t[i.long()], measure)
        assert torch.equal(v, want), nprobe
