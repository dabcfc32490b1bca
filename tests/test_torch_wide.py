"""Kernels 2–6 past 104 landmarks, on the CPU: the port's plain versions
against the reference's functions at n in {105, 128, 256}, and the main
path at 128 landmarks (the reference registry's ``web_fit`` width).

On the card kernels 2–6 take their wide routes past 104 landmarks and are
held bitwise to these plain versions by ``tests/test_torch_gpu.py``; here
the plain versions are held to the reference, whose Pallas kernels run in
interpret mode as its own tests run them.

Tolerances:
- scores: rtol=1e-5, atol=1e-6 (f32 sums in other orders);
- ids: equal, except where the reference's own scores tie within that
  tolerance at the cut (``core.topk.list_mismatches``);
- k-means from the reference's initialization: centroids bitwise and
  assignments equal (both add each cell's members in row order);
- the main path: representations bitwise, graphs under the tie rule,
  predictions within the score tolerance (``test_torch_landmark_cf.py``'s
  rule).
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.kernels import ops as jops
from repro.kernels.ivf_probe import fused_probe_topk as j_fused
from repro.kernels.knn_topk import foldin_topk_kernel, topk_sim_kernel
from repro.retrieval.index import score_candidates_kernel
from repro.retrieval.kmeans import assign_clusters_kernel
from repro.retrieval.kmeans import init_centroids as j_init_centroids
from repro.retrieval.kmeans import kmeans as j_kmeans
import repro_torch.core as T
from repro_torch.configs import landmark_cf as tcfg
from repro_torch.core.graph import kernel_rows
from repro_torch.core.topk import list_mismatches
from repro_torch.data import ratings as tdata
from repro_torch.kernels import knn_topk, ops, ref

RTOL, ATOL = 1e-5, 1e-6
MEASURES = T.MEASURES
WIDE = (105, 128, 256)  # past the narrow routes' 104


def _rep(u, n, seed):
    return np.random.default_rng(seed).normal(size=(u, n)).astype(np.float32)


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _agree(want_v, want_i, got_v, got_i):
    want_v = np.asarray(want_v)
    order = np.lexsort((np.asarray(want_i), -want_v), axis=1)
    want_v = np.take_along_axis(want_v, order, 1)
    want_i = np.take_along_axis(np.asarray(want_i), order, 1)
    bad = list_mismatches(want_v, want_i, got_v, got_i, RTOL, ATOL)
    assert bad.size == 0, f"rows disagree beyond the tie rule: {bad[:10]}"


@pytest.mark.parametrize("n", WIDE)
def test_check_width_takes_any_landmark_count(n):
    """No upper bound: past ``NARROW_WIDTH`` the kernels take their wide
    routes; n = 0 is refused."""
    assert n > knn_topk.NARROW_WIDTH
    for name in ("topk_sim", "kmeans_lloyd", "fused_probe_topk",
                 "score_candidates"):
        knn_topk.check_width(name, n)
        with pytest.raises(ValueError, match=f"{name}: width 0"):
            knn_topk.check_width(name, 0)


# ------------------------------------------------------------ kernels 2-3
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("n", WIDE)
def test_scan_plain_matches_reference_kernels_at_wide_rows(n, measure):
    """``topk_sim`` (ragged ``n_valid``, self excluded) and ``foldin_topk``
    (the queries among the candidates) against ``topk_sim_kernel`` and
    ``foldin_topk_kernel`` in interpret mode."""
    rep = kernel_rows(torch.as_tensor(_rep(180, n, seed=n)), measure)
    v, i = ops.topk_sim(rep, rep, k=9, exclude_self=True, n_valid=171,
                        measure=measure)
    wv, wi = topk_sim_kernel(jnp.asarray(rep.numpy()),
                             jnp.asarray(rep.numpy()), k=9,
                             exclude_self=True, n_valid=171, measure=measure)
    _agree(wv, wi, v, i)
    q = rep[160:].contiguous()
    v, i = ops.foldin_topk(q, rep, k=9, self_offset=160, measure=measure)
    wv, wi = foldin_topk_kernel(jnp.asarray(q.numpy()),
                                jnp.asarray(rep.numpy()), k=9,
                                self_offset=160, measure=measure)
    _agree(wv, wi, v, i)


# --------------------------------------------------------------- kernel 4
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("n", WIDE)
def test_lloyd_plain_matches_reference_at_wide_rows(n, measure):
    """The assignment against ``assign_clusters_kernel`` (interpret), and a
    whole k-means from the reference's initialization against its
    ``kmeans(backend="pallas")``: centroids bitwise, assignments equal."""
    rep = _rep(240, n, seed=n + 1)
    cent = _rep(11, n, seed=n + 2)
    want = assign_clusters_kernel(
        jnp.asarray(kernel_rows(torch.as_tensor(rep), measure).numpy()),
        jnp.asarray(kernel_rows(torch.as_tensor(cent), measure).numpy()),
        measure, interpret=True)
    got = ops.assign_clusters(kernel_rows(torch.as_tensor(rep), measure),
                              kernel_rows(torch.as_tensor(cent), measure),
                              measure)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    key = jax.random.PRNGKey(n)
    nv = jnp.int32(220)
    init = np.array(j_init_centroids(key, jnp.asarray(rep), 9, nv))
    jc, ja = j_kmeans(key, jnp.asarray(rep), 9, measure, iters=3, n_valid=nv,
                      backend="pallas")
    pc, pa = ref.kmeans_lloyd_ref(torch.as_tensor(rep), torch.as_tensor(init),
                                  3, 220, measure)
    np.testing.assert_array_equal(_bits(pc), _bits(jc))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))


# --------------------------------------------------------------- kernel 5
@pytest.mark.parametrize("payload", ["f32", "int8"])
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("n", WIDE)
def test_fused_probe_plain_matches_reference_at_wide_rows(n, measure,
                                                          payload):
    """An empty cell, self ids, a probe mask: the fused probe's plain
    version against the reference's in interpret mode."""
    rng = np.random.default_rng(n)
    c, cap, b, nprobe, k = 5, 9, 6, 3, 7
    fill = rng.integers(1, cap + 1, c).astype(np.int32)
    fill[0] = 0
    ids = rng.permutation(int(fill.sum())).astype(np.int32)
    lists = np.zeros((c, cap), np.int32)
    rows = np.zeros((c, cap, n), np.float32)
    o = 0
    for j in range(c):
        lists[j, :fill[j]] = ids[o:o + fill[j]]
        rows[j, :fill[j]] = rng.normal(size=(fill[j], n))
        o += fill[j]
    scale = None
    if payload == "int8":
        scale = (np.abs(rows).max(-1) / np.float32(127)).astype(np.float32)
        rows = np.round(rows / np.maximum(scale, 1e-8)[..., None]).astype(
            np.int8)
    q = rng.normal(size=(b, n)).astype(np.float32)
    probe = np.stack([rng.permutation(c)[:nprobe] for _ in range(b)]
                     ).astype(np.int32)
    sids = lists[probe[:, 0], 0].copy()
    ok = rng.random((b, nprobe)) > 0.25
    wv, wi = j_fused(jnp.asarray(q), jnp.asarray(probe), jnp.asarray(lists),
                     jnp.asarray(rows),
                     None if scale is None else jnp.asarray(scale),
                     jnp.asarray(fill), k=k, measure=measure,
                     self_ids=jnp.asarray(sids), probe_ok=jnp.asarray(ok),
                     interpret=True)
    v, i = ops.fused_probe_topk(
        torch.as_tensor(q), torch.as_tensor(probe), torch.as_tensor(lists),
        torch.as_tensor(rows),
        None if scale is None else torch.as_tensor(scale),
        torch.as_tensor(fill), k=k, measure=measure,
        self_ids=torch.as_tensor(sids), probe_ok=torch.as_tensor(ok))
    bad = list_mismatches(np.asarray(wv), np.asarray(wi), v, i, RTOL, ATOL)
    assert bad.size == 0, bad
    assert not (i.numpy() == sids[:, None]).any()


# --------------------------------------------------------------- kernel 6
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("n", WIDE)
def test_scorer_plain_matches_reference_kernel_at_wide_rows(n, measure):
    """Both forms of the scorer's plain version against
    ``score_candidates_kernel`` (interpret): the per-query form as it is,
    the shared form against the one block repeated for every query."""
    q, cand = _rep(7, n, seed=n + 3), _rep(7 * 41, n, seed=n + 4)
    cand = cand.reshape(7, 41, n)
    want = score_candidates_kernel(jnp.asarray(q), jnp.asarray(cand), measure,
                                   interpret=True)
    got = ops.score_candidates(torch.as_tensor(q), torch.as_tensor(cand),
                               measure)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    block = cand[0]
    want = score_candidates_kernel(
        jnp.asarray(q), jnp.broadcast_to(jnp.asarray(block), cand.shape),
        measure, interpret=True)
    got = ops.score_candidates(torch.as_tensor(q), torch.as_tensor(block),
                               measure)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------- the main path
def test_main_path_at_web_fit_landmarks_matches_reference():
    """fit → fold-in of 16 rows → predict at ``web_fit``'s 128 landmarks, a
    300-user × 256-item cut of movielens100k: the reference with its Pallas
    kernels (interpret) against the port's defaults."""
    u, p, bq = 300, 256, 16
    n = dict(tcfg.WEB_FIT)["n_landmarks"]
    data = tdata.synthesize("movielens100k", seed=0)
    keep = (data.users < u) & (data.items < p)
    sub = tdata.RatingData(data.users[keep], data.items[keep],
                           data.ratings[keep], u, p)
    train, test = tdata.kfold_split(sub, 0)
    dense = np.asarray(sub.to_matrix(train, device="cpu").ratings.numpy())
    jspec = J.LandmarkSpec(n_landmarks=n, selection="popularity",
                           d1="cosine", d2="cosine", k_neighbors=13)
    tspec = dataclasses.replace(tcfg.MODEL, n_landmarks=n)
    u0 = u - bq
    jst = J.fit(jax.random.PRNGKey(0), J.RatingMatrix(
        jnp.asarray(dense[:u0]), u0, p), jspec,
        sim_fn=jops.masked_similarity, backend="pallas")
    tst = T.fit(T.RatingMatrix(torch.as_tensor(dense[:u0]), u0, p), tspec)
    assert tst.representation.shape == (u0, n)
    np.testing.assert_array_equal(tst.landmark_idx.numpy(),
                                  np.asarray(jst.landmark_idx))
    np.testing.assert_array_equal(tst.representation.numpy(),
                                  np.asarray(jst.representation))
    jgraph = J.build_neighbor_graph(jst.representation, "cosine", 13,
                                    "streaming")
    _agree(jgraph.weights, jgraph.indices, tst.graph.weights,
           tst.graph.indices)
    jf = J.fold_in(J.LandmarkState(jst.landmark_idx, jst.representation,
                                   jst.ratings, graph=jgraph),
                   jnp.asarray(dense[u0:]), jspec,
                   sim_fn=jops.masked_similarity, backend="pallas")
    tf = T.fold_in(tst, torch.as_tensor(dense[u0:]), tspec)
    np.testing.assert_array_equal(tf.representation.numpy(),
                                  np.asarray(jf.representation))
    _agree(jf.graph.weights, jf.graph.indices, tf.graph.weights,
           tf.graph.indices)
    users, items = sub.users[test], sub.items[test]
    got = T.predict(tf, torch.as_tensor(users), torch.as_tensor(items),
                    tspec).numpy()
    same = J.LandmarkState(jf.landmark_idx, jf.representation, jf.ratings,
                           graph=J.NeighborGraph(
                               jnp.asarray(tf.graph.indices.numpy()),
                               jnp.asarray(tf.graph.weights.numpy())))
    want = np.asarray(J.predict(same, jnp.asarray(users), jnp.asarray(items),
                                jspec))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.isfinite(got).all()


# ---------------------------------------------------------------- configs
def test_cf_shapes_match_the_reference_registry():
    """The port's copy of the registry's four ``landmark_cf`` shapes:
    names, kinds, dims and notes equal, in order."""
    from repro.configs import registry

    want = registry.get("landmark_cf").shapes
    assert [(s.name, s.kind, s.dims, s.note) for s in tcfg.SHAPES] == [
        (s.name, s.kind, s.dims, s.note) for s in want]
    by_name = {s.name: s.dims for s in tcfg.SHAPES}
    assert by_name["ml1m_fit"] == tcfg.ML1M_FIT
    assert by_name["netflix1m_fit"] == tcfg.NETFLIX1M_FIT
    assert by_name["web_fit"] == tcfg.WEB_FIT
    assert by_name["ml1m_predict"] == tcfg.ML1M_PREDICT
