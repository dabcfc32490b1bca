"""The port's whole slice against the JAX reference, on the CPU:
synthesize → fit → predict → top-N → fold-in.

The reference runs its Pallas kernels (d1, the graph build and the fold-in
search) in interpret mode; the port runs its kernel wrappers, which take
their plain versions on CPU tensors. Tolerances:
- landmark ids: equal;
- the representation (cosine d1 on integer ratings): equal;
- graph ids: equal except where the reference's weights tie within
  rtol=1e-5, atol=1e-6 at the cut-off; weights within that tolerance;
- predictions, MAE: rtol=1e-5, atol=1e-6 for Eq. (1) on the same graph.
  Against the reference's own graph, a row whose neighbor set differs by a
  tie at the cut may predict differently; predictions are compared
  directly for every user whose neighbor set is equal, and the rows that
  differ must be few (the d2 cosines cluster near 1.0, ~1e-7 apart);
- synthetic data: byte-identical (the same numpy generator and seed).
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.data import ratings as jdata
from repro.kernels import ops as jops
import repro_torch.core as T
from repro_torch.configs import landmark_cf as tcfg
from repro_torch.core.topk import list_mismatches
from repro_torch.data import ratings as tdata

RTOL, ATOL = 1e-5, 1e-6
U, P, B = 300, 256, 16  # rows, items, fold-in rows


def _assert_graphs_agree(ref, got):
    bad = list_mismatches(np.asarray(ref.weights), np.asarray(ref.indices),
                          got.weights, got.indices, RTOL, ATOL)
    assert bad.size == 0, f"rows disagree beyond the tie rule: {bad[:10]}"


@pytest.mark.parametrize("name,seed", [("movielens100k", 0),
                                       ("netflix100k", 3)])
def test_synthesize_is_byte_identical(name, seed):
    want = jdata.synthesize(name, seed=seed)
    got = tdata.synthesize(name, seed=seed)
    for field in ("users", "items", "ratings"):
        a, b = getattr(want, field), getattr(got, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    assert (got.n_users, got.n_items) == (want.n_users, want.n_items)
    for fold in (0, 7):
        for a, b in zip(jdata.kfold_split(want, fold),
                        tdata.kfold_split(got, fold)):
            np.testing.assert_array_equal(a, b)
    assert tdata.DATASETS == jdata.DATASETS


def test_to_matrix_matches_reference():
    data = tdata.synthesize("movielens100k", seed=0)
    train, _ = tdata.kfold_split(data, 0)
    want = jdata.synthesize("movielens100k", seed=0).to_matrix(train)
    got = data.to_matrix(train, device="cpu")
    assert (got.n_users, got.n_items) == (want.n_users, want.n_items)
    np.testing.assert_array_equal(got.ratings.numpy(), np.asarray(want.ratings))
    np.testing.assert_allclose(got.user_means().numpy(),
                               np.asarray(want.user_means()), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module")
def cut():
    """A 300-user × 256-item cut of movielens100k, fold 0 split."""
    data = tdata.synthesize("movielens100k", seed=0)
    keep = (data.users < U) & (data.items < P)
    sub = tdata.RatingData(data.users[keep], data.items[keep],
                           data.ratings[keep], U, P)
    train, test = tdata.kfold_split(sub, 0)
    dense = np.asarray(sub.to_matrix(train, device="cpu").ratings.numpy())
    return sub, dense, test


def _spec(pkg, **kw):
    return pkg.LandmarkSpec(n_landmarks=16, selection="popularity", d1="cosine",
                            d2="cosine", k_neighbors=13, **kw)


def _check_predictions(jst, tst, jspec, tspec, users, items, truth):
    """Eq. (1) on the port's graph equals the reference's Eq. (1) on that
    same graph; against the reference's own graph, predictions are equal
    for every user whose neighbor set is equal."""
    got = T.predict(tst, torch.as_tensor(users), torch.as_tensor(items),
                    tspec).numpy()
    same_graph = J.LandmarkState(
        jst.landmark_idx, jst.representation, jst.ratings,
        graph=J.NeighborGraph(jnp.asarray(tst.graph.indices.numpy()),
                              jnp.asarray(tst.graph.weights.numpy())))
    want = np.asarray(J.predict(same_graph, jnp.asarray(users),
                                jnp.asarray(items), jspec))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert abs(tdata.mae(got, truth) - jdata.mae(want, truth)) < RTOL

    same_ids = _same_sets(tst.graph, jst.graph)
    assert same_ids.mean() > 0.95, np.flatnonzero(~same_ids)
    rows = users if tspec.mode == "user" else items
    own = np.asarray(J.predict(jst, jnp.asarray(users), jnp.asarray(items),
                               jspec))
    keep = same_ids[rows]
    np.testing.assert_allclose(got[keep], own[keep], rtol=RTOL, atol=ATOL)


def _same_sets(tgraph, jgraph):
    """Rows whose neighbor id sets are equal (order aside)."""
    return (np.sort(tgraph.indices.numpy(), axis=1)
            == np.sort(np.asarray(jgraph.indices), axis=1)).all(axis=1)


def _test_pairs(sub, test, n_rows):
    keep = sub.users[test] < n_rows
    return (sub.users[test][keep], sub.items[test][keep],
            sub.ratings[test][keep])


def test_main_path_matches_reference(cut):
    """fit → predict → top-N → fold-in of 16 rows, user mode, with the
    reference's Pallas kernels (interpret) against the port's defaults."""
    sub, dense, test = cut
    u0 = U - B
    jspec, tspec = _spec(J), _spec(T)
    jm = J.RatingMatrix(jnp.asarray(dense[:u0]), u0, P)
    tm = T.RatingMatrix(torch.as_tensor(dense[:u0]), u0, P)
    jst = J.fit(jax.random.PRNGKey(0), jm, jspec,
                sim_fn=jops.masked_similarity, backend="pallas")
    tst = T.fit(tm, tspec)

    np.testing.assert_array_equal(tst.landmark_idx.numpy(),
                                  np.asarray(jst.landmark_idx))
    np.testing.assert_array_equal(tst.representation.numpy(),
                                  np.asarray(jst.representation))
    # the Pallas graph kernel leaves slot order; the reference's streaming
    # build is its canonical form
    _assert_graphs_agree(J.build_neighbor_graph(jst.representation, "cosine",
                                                13, "streaming"), tst.graph)
    jst = J.LandmarkState(jst.landmark_idx, jst.representation, jst.ratings,
                          graph=J.build_neighbor_graph(
                              jst.representation, "cosine", 13, "streaming"))

    _check_predictions(jst, tst, jspec, tspec, *_test_pairs(sub, test, u0))

    rec_users = np.arange(0, u0, 7)
    want_i, want_s = J.knn.recommend_topn_graph(jst.graph, jst.ratings,
                                                jnp.asarray(rec_users), n=10)
    got_i, got_s = T.knn.recommend_topn_graph(tst.graph, tst.ratings,
                                              torch.as_tensor(rec_users), n=10)
    assert list_mismatches(np.asarray(want_s), np.asarray(want_i), got_s,
                           got_i, RTOL, ATOL).size == 0

    new = dense[u0:]
    jf = J.fold_in(jst, jnp.asarray(new), jspec,
                   sim_fn=jops.masked_similarity, backend="pallas")
    tf = T.fold_in(tst, torch.as_tensor(new), tspec)
    np.testing.assert_array_equal(tf.representation.numpy(),
                                  np.asarray(jf.representation))
    _assert_graphs_agree(jf.graph, tf.graph)
    _check_predictions(jf, tf, jspec, tspec, *_test_pairs(sub, test, U))


def test_item_mode_matches_reference(cut):
    sub, dense, test = cut
    jspec, tspec = _spec(J, mode="item"), _spec(T, mode="item")
    jst = J.fit(jax.random.PRNGKey(0), J.RatingMatrix(jnp.asarray(dense), U, P),
                jspec)
    tst = T.fit(T.RatingMatrix(torch.as_tensor(dense), U, P), tspec)
    assert tst.ratings.shape == (P, U)
    np.testing.assert_array_equal(tst.landmark_idx.numpy(),
                                  np.asarray(jst.landmark_idx))
    _assert_graphs_agree(jst.graph, tst.graph)
    _check_predictions(jst, tst, jspec, tspec, *_test_pairs(sub, test, U))
    same_ids = _same_sets(tst.graph, jst.graph)
    np.testing.assert_allclose(
        T.predict_dense(tst, tspec).numpy()[:, same_ids],
        np.asarray(J.predict_dense(jst, jspec))[:, same_ids],
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("measure", ["cosine", "pearson"])
def test_fit_baseline_matches_reference(cut, measure):
    """The full-matrix kNN baseline and its dense predictions."""
    sub, dense, test = cut
    jspec, tspec = _spec(J), _spec(T)
    jst = J.fit_baseline(J.RatingMatrix(jnp.asarray(dense), U, P), measure)
    tst = T.fit_baseline(T.RatingMatrix(torch.as_tensor(dense), U, P), measure)
    assert tst.graph is None and tst.sims.shape == (U, U)
    users, items, _ = _test_pairs(sub, test, U)
    want = J.predict(jst, jnp.asarray(users), jnp.asarray(items), jspec)
    got = T.predict(tst, torch.as_tensor(users), torch.as_tensor(items), tspec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_dense_sims_fit_matches_reference(cut):
    _, dense, _ = cut
    jst = J.fit(jax.random.PRNGKey(0), J.RatingMatrix(jnp.asarray(dense), U, P),
                _spec(J), dense_sims=True)
    tst = T.fit(T.RatingMatrix(torch.as_tensor(dense), U, P), _spec(T),
                dense_sims=True)
    assert tst.graph is None
    np.testing.assert_allclose(tst.sims.numpy(), np.asarray(jst.sims),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="graph-backed"):
        T.fold_in(tst, torch.as_tensor(dense[:2]), _spec(T))


def test_configs_match_reference():
    from repro.configs import registry

    arch = registry.get("landmark_cf")
    assert dataclasses.asdict(tcfg.MODEL) == dataclasses.asdict(arch.model)
    assert dataclasses.asdict(tcfg.SMOKE) == dataclasses.asdict(
        arch.smoke_model)
    shapes = {s.name: s.dims for s in arch.shapes}
    assert tcfg.ML1M_FIT == shapes["ml1m_fit"]
    assert tcfg.ML1M_PREDICT == shapes["ml1m_predict"]


@pytest.mark.parametrize("strategy", ["random", "dist_ratings", "coresets",
                                      "coresets_random"])
def test_unported_selection_strategies_raise(strategy):
    """The random strategies, once waiting for their slice, now select;
    an unknown strategy still raises."""
    r = torch.ones((5, 4))
    idx = T.select_landmarks(r, 2, strategy,
                             torch.Generator().manual_seed(0))
    assert idx.shape == (2,) and len(set(idx.tolist())) == 2
    with pytest.raises(ValueError, match="unknown strategy"):
        T.select_landmarks(r, 2, "oracle")
