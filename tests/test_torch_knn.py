"""Parity of the port's Eq. (1) prediction with the JAX reference, on the CPU.

Both packages serve from the same fitted state: the reference fits, and
``core.convert`` carries its arrays across. Tolerances:
- predictions and scores: rtol=1e-5, atol=1e-6 (f32 sums in different
  orders);
- top-N item ids: equal, except where the reference's own scores tie
  within that tolerance at the cut-off (``core.topk.list_mismatches``).
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro_torch.core.convert import (landmark_state_from_numpy,
                                      landmark_state_to_numpy)
from repro_torch.core.topk import list_mismatches

RTOL, ATOL = 1e-5, 1e-6


def _ratings(u, p, density=0.35, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    return r * (rng.random((u, p)) < density)


@pytest.fixture(scope="module")
def fitted():
    """A reference fit and the same state carried into the port."""
    r = _ratings(120, 64, seed=1)
    spec = J.LandmarkSpec(n_landmarks=8, selection="popularity",
                          k_neighbors=5)
    st = J.fit(jax.random.PRNGKey(0), J.RatingMatrix(jnp.asarray(r), 120, 64),
               spec)
    arrays = {"landmark_idx": np.asarray(st.landmark_idx),
              "representation": np.asarray(st.representation),
              "ratings": np.asarray(st.ratings),
              "graph.indices": np.asarray(st.graph.indices),
              "graph.weights": np.asarray(st.graph.weights)}
    return st, landmark_state_from_numpy(arrays, device="cpu"), arrays


def _pairs(seed, u, p, n=300):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, u, n).astype(np.int32),
            rng.integers(0, p, n).astype(np.int32))


def test_convert_round_trip(fitted):
    _, ts, arrays = fitted
    back = landmark_state_to_numpy(ts)
    for key, value in arrays.items():
        np.testing.assert_array_equal(back[key], value)


def test_predict_pairs_graph_matches_reference(fitted):
    st, ts, _ = fitted
    users, items = _pairs(2, 120, 64)
    want = J.knn.predict_pairs_graph(st.graph, st.ratings, jnp.asarray(users),
                                     jnp.asarray(items))
    got = T.knn.predict_pairs_graph(ts.graph, ts.ratings,
                                    torch.as_tensor(users),
                                    torch.as_tensor(items))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_predict_all_graph_matches_reference(fitted):
    st, ts, _ = fitted
    want = J.knn.predict_all_graph(st.graph, st.ratings, block=32)
    got = T.knn.predict_all_graph(ts.graph, ts.ratings, block=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_recommend_topn_graph_matches_reference(fitted):
    st, ts, _ = fitted
    users = np.arange(0, 120, 3, dtype=np.int32)
    want_i, want_s = J.knn.recommend_topn_graph(st.graph, st.ratings,
                                                jnp.asarray(users), n=7)
    got_i, got_s = T.knn.recommend_topn_graph(ts.graph, ts.ratings,
                                              torch.as_tensor(users), n=7)
    assert got_i.dtype == torch.int32
    bad = list_mismatches(np.asarray(want_s), np.asarray(want_i), got_s,
                          got_i, RTOL, ATOL)
    assert bad.size == 0, bad


@pytest.mark.parametrize("n_valid", [60, 119])
def test_n_valid_masks_padded_neighbors(fitted, n_valid):
    """Neighbors with ids >= n_valid contribute nothing, as in the
    reference."""
    st, ts, _ = fitted
    users, items = _pairs(3, 60, 64)
    want = J.knn.predict_pairs_graph(st.graph, st.ratings, jnp.asarray(users),
                                     jnp.asarray(items), n_valid=n_valid)
    got = T.knn.predict_pairs_graph(ts.graph, ts.ratings,
                                    torch.as_tensor(users),
                                    torch.as_tensor(items), n_valid=n_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    want_i, want_s = J.knn.recommend_topn_graph(
        st.graph, st.ratings, jnp.asarray(users[:20]), n=5, n_valid=n_valid)
    got_i, got_s = T.knn.recommend_topn_graph(
        ts.graph, ts.ratings, torch.as_tensor(users[:20]), n=5,
        n_valid=n_valid)
    assert list_mismatches(np.asarray(want_s), np.asarray(want_i), got_s,
                           got_i, RTOL, ATOL).size == 0


def test_cold_row_falls_back_to_user_mean(fitted):
    """A user whose graph row is all zero weights predicts their own mean,
    never NaN, and top-N stays finite and unrated."""
    _, ts, _ = fitted
    cold = 3
    w = ts.graph.weights.clone()
    w[cold] = 0.0
    g = T.NeighborGraph(ts.graph.indices, w)
    items = torch.arange(8)
    users = torch.full((8,), cold)
    got = T.knn.predict_pairs_graph(g, ts.ratings, users, items).numpy()
    row = ts.ratings[cold].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, row[row != 0].mean(), rtol=1e-5)
    rec_items, scores = T.knn.recommend_topn_graph(g, ts.ratings, users[:1],
                                                   n=4)
    assert torch.isfinite(scores).all()
    assert not (row[rec_items[0].numpy()] != 0).any()


def test_recommend_topn_exhausted_slots_are_sentinel(fitted):
    """A user with fewer than n unrated items gets -1/-inf filler slots,
    never a rated item."""
    _, ts, _ = fitted
    u = 5
    ratings = ts.ratings.clone()
    ratings[u] = 4.0
    ratings[u, :2] = 0.0  # 2 unrated items
    items, scores = T.knn.recommend_topn_graph(ts.graph, ratings,
                                               torch.tensor([u]), n=6)
    items, scores = items[0].numpy(), scores[0].numpy()
    assert set(items[np.isfinite(scores)]) <= {0, 1}
    assert (items[~np.isfinite(scores)] == -1).all()
    assert (~np.isfinite(scores)).sum() == 4


def test_compact_graph_predicts(fitted):
    """A uint16/bf16 graph predicts directly, as the full graph with its
    weights rounded to bf16."""
    _, ts, _ = fitted
    users, items = (torch.as_tensor(a) for a in _pairs(5, 120, 64))
    c = ts.graph.to_compact()
    want = T.knn.predict_pairs_graph(c.to_full(), ts.ratings, users, items)
    got = T.knn.predict_pairs_graph(c, ts.ratings, users, items)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("measure", ["cosine", "pearson"])
def test_dense_predict_matches_reference(measure):
    """The baseline path from a dense (U, U) sims matrix."""
    r = _ratings(70, 40, seed=6)
    sims = np.asarray(J.full_similarity_matrix(jnp.asarray(r), measure))
    users, items = _pairs(7, 70, 40)
    want = J.knn.predict_pairs(jnp.asarray(sims), jnp.asarray(r),
                               jnp.asarray(users), jnp.asarray(items), k=6)
    got = T.knn.predict_pairs(torch.as_tensor(sims), torch.as_tensor(r),
                              torch.as_tensor(users), torch.as_tensor(items),
                              k=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    want_all = J.knn.predict_all(jnp.asarray(sims), jnp.asarray(r), k=6,
                                 block=32)
    got_all = T.knn.predict_all(torch.as_tensor(sims), torch.as_tensor(r),
                                k=6, block=32)
    np.testing.assert_allclose(got_all.numpy(), np.asarray(want_all),
                               rtol=RTOL, atol=ATOL)
