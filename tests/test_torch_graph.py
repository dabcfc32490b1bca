"""Parity of the port's neighbor-graph layer with the JAX reference, on the CPU.

The port's graph backends (dense, streaming, and kernel — whose wrappers
run their plain versions on CPU tensors) are held against the reference's
streaming and dense builds, and the port's plain top-k kernels against the
reference's Pallas kernels in interpret mode.

Tolerances:
- weights: rtol=1e-5, atol=1e-6 (f32 products summed in different orders);
- neighbor ids: equal, except where the reference's own weights tie within
  that tolerance at the cut-off (``core.topk.list_mismatches``);
- exact ties (duplicated rows) break to the lowest id: checked directly
  against the known duplicate groups, with no tolerance;
- euclidean weight of an exact copy: 1 within 2e-3, because the
  reference's |u|² − 2z + |v|² leaves a rounding residual there that the
  square root magnifies to ~1e-3.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.kernels.knn_topk import foldin_topk_kernel, topk_sim_kernel
import repro_torch.core as T
from repro_torch.core import graph as tgraph
from repro_torch.core.convert import landmark_state_from_numpy
from repro_torch.core.topk import canonical_topk, list_mismatches
from repro_torch.kernels import ops as tops

RTOL, ATOL = 1e-5, 1e-6
MEASURES = T.MEASURES
PORT_BACKENDS = ("dense", "streaming", "kernel")


def _ratings(u, p, density=0.35, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    return r * (rng.random((u, p)) < density)


def _rep(u, n=10, seed=0):
    """A landmark representation as d1 makes it: cosine of ratings to the
    first n rows."""
    r = _ratings(u, 48, seed=seed)
    return T.masked_similarity(torch.as_tensor(r), torch.as_tensor(r[:n])
                               ).numpy()


def _assert_graphs_agree(ref, got):
    bad = list_mismatches(np.asarray(ref.weights), np.asarray(ref.indices),
                          got.weights, got.indices, RTOL, ATOL)
    assert bad.size == 0, f"rows disagree beyond the tie rule: {bad[:10]}"


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_build_graph_matches_reference(backend, measure):
    """Every port backend against the reference's streaming and dense
    builds: ids equal up to ties at the cut, weights within tolerance."""
    rep = _rep(97, seed=1)
    got = T.build_neighbor_graph(torch.as_tensor(rep), measure, 7, backend)
    assert got.indices.dtype == torch.int32 and got.k == 7
    for jb in ("streaming", "dense"):
        _assert_graphs_agree(
            J.build_neighbor_graph(jnp.asarray(rep), measure, 7, jb), got)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_build_graph_duplicated_rows_tie_to_lowest_id(backend, measure):
    """Rows come in triples of identical copies, so weights tie exactly
    (as d1 collisions make them in real data). With k=4 every list holds
    the row's two copies and two of the three copies of another group;
    the two must be that group's lowest ids, and the lists must agree with
    the reference's."""
    base = _rep(40, n=8, seed=2)
    rep = np.repeat(base, 3, axis=0)
    got = T.build_neighbor_graph(torch.as_tensor(rep), measure, 4, backend)
    ids = got.indices.numpy()
    w = got.weights.numpy()
    for r in range(rep.shape[0]):
        for g in set(ids[r] // 3):
            members = [i for i in range(3 * g, 3 * g + 3) if i != r]
            chosen = sorted(i for i in ids[r] if i // 3 == g)
            assert chosen == members[:len(chosen)], (r, ids[r])
        # canonical order inside the list: equal weights in ascending id
        for j in range(3):
            if w[r, j] == w[r, j + 1]:
                assert ids[r, j] < ids[r, j + 1], (r, ids[r], w[r])
    for jb in ("streaming", "dense"):
        want = J.build_neighbor_graph(jnp.asarray(rep), measure, 4, jb)
        if measure == "euclidean":
            # a copy is at distance 0: weight 1. The reference's
            # |u|² − 2z + |v|² leaves a rounding residual there (~1e-3 after
            # the square root); the kernel's plain version, summing in the
            # kernel's order, is exact. Those two slots are held to the true
            # weight, the rest to the reference.
            own = [[i for i in range(3 * (r // 3), 3 * (r // 3) + 3) if i != r]
                   for r in range(rep.shape[0])]
            np.testing.assert_array_equal(ids[:, :2], np.asarray(own))
            np.testing.assert_allclose(w[:, :2], 1.0, atol=2e-3)
            np.testing.assert_allclose(np.asarray(want.weights)[:, :2], 1.0,
                                       atol=2e-3)
            want = J.NeighborGraph(want.indices[:, 2:], want.weights[:, 2:])
            got = T.NeighborGraph(got.indices[:, 2:], got.weights[:, 2:])
        _assert_graphs_agree(want, got)
        got = T.build_neighbor_graph(torch.as_tensor(rep), measure, 4, backend)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_k_clamped_to_u_minus_1(backend):
    rep = _rep(6, n=4, seed=3)
    got = T.build_neighbor_graph(torch.as_tensor(rep), "cosine", 13, backend)
    want = J.build_neighbor_graph(jnp.asarray(rep), "cosine", 13, "dense")
    assert got.k == want.k == 5
    _assert_graphs_agree(want, got)


def _canonical(vals, ids):
    """The reference kernel's slot-ordered lists, sorted canonically."""
    v, i = canonical_topk(torch.as_tensor(np.asarray(vals)),
                          vals.shape[1],
                          ids=torch.as_tensor(np.asarray(ids)))
    i = torch.where(torch.isfinite(v), i, torch.zeros_like(i))
    return v.numpy(), i.numpy()


def _rows(rep, measure):
    return tgraph.kernel_rows(torch.as_tensor(rep), measure)


@pytest.mark.parametrize("measure", MEASURES)
def test_topk_sim_plain_matches_pallas_kernel(measure):
    """The port's ``topk_sim`` (plain on CPU) against the reference's
    ``topk_sim_kernel`` in interpret mode, with a ragged ``n_valid`` and
    self-exclusion; the reference's lists are sorted canonically first."""
    rep = _rows(_rep(150, n=12, seed=4), measure)
    got_v, got_i = tops.topk_sim(rep, rep, k=6, exclude_self=True,
                                 n_valid=141, measure=measure)
    want_v, want_i = topk_sim_kernel(jnp.asarray(rep.numpy()),
                                     jnp.asarray(rep.numpy()), k=6,
                                     exclude_self=True, n_valid=141,
                                     measure=measure)
    want_v, want_i = _canonical(want_v, want_i)
    bad = list_mismatches(want_v, want_i, got_v, got_i, RTOL, ATOL)
    assert bad.size == 0, bad[:10]
    assert (got_i.numpy() < 141).all()
    assert not (got_i.numpy() == np.arange(150)[:, None]).any()


@pytest.mark.parametrize("measure", MEASURES)
def test_foldin_topk_plain_matches_pallas_kernel(measure):
    """The port's ``foldin_topk`` (plain on CPU) against the reference's
    ``foldin_topk_kernel`` in interpret mode: 19 queries appended as
    candidates 151..169, each masked against its own slot."""
    rep = _rows(_rep(170, n=12, seed=5), measure)
    q = rep[151:].contiguous()
    got_v, got_i = tops.foldin_topk(q, rep, k=6, self_offset=151,
                                    measure=measure)
    want_v, want_i = foldin_topk_kernel(jnp.asarray(q.numpy()),
                                        jnp.asarray(rep.numpy()), k=6,
                                        self_offset=151, measure=measure)
    want_v, want_i = _canonical(want_v, want_i)
    bad = list_mismatches(want_v, want_i, got_v, got_i, RTOL, ATOL)
    assert bad.size == 0, bad[:10]
    assert not (got_i.numpy() == 151 + np.arange(19)[:, None]).any()


def test_topk_plain_empty_slots_are_neg_inf_zero():
    """Fewer valid candidates than k: the tail is (-inf, 0), which
    ``finalize_topk`` turns into inert (0, 0.0) slots."""
    rep = torch.eye(5)
    v, i = tops.topk_sim(rep, rep, k=4, exclude_self=True, n_valid=3)
    assert torch.isinf(v[:, 3]).all() and (i[:, 3] == 0).all()
    g = tgraph.finalize_topk(v, i)
    assert (g.weights[:, 3] == 0).all() and (g.indices[:, 3] == 0).all()


def _foldin_fixture(measure="cosine", k=5, u=60, b=12, p=40):
    r = _ratings(u + b, p, seed=6)
    spec = J.LandmarkSpec(n_landmarks=8, selection="popularity",
                          d2=measure, k_neighbors=k)
    st = J.fit(jax.random.PRNGKey(0), J.RatingMatrix(jnp.asarray(r[:u]), u, p),
               spec, backend="dense")
    tspec = T.LandmarkSpec(n_landmarks=8, selection="popularity", d2=measure,
                           k_neighbors=k)
    return r, spec, st, tspec


def _carry(st):
    return landmark_state_from_numpy({
        "landmark_idx": np.asarray(st.landmark_idx),
        "representation": np.asarray(st.representation),
        "ratings": np.asarray(st.ratings),
        "graph.indices": np.asarray(st.graph.indices),
        "graph.weights": np.asarray(st.graph.weights)}, device="cpu")


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_extend_matches_reference(backend, measure):
    """New-vs-all plus the (U, b) back-patch, from the same fitted graph,
    against the reference's streaming extend."""
    r, spec, st, _ = _foldin_fixture(measure)
    u = st.ratings.shape[0]
    new_rep = np.asarray(J.masked_similarity(jnp.asarray(r[u:]),
                                             st.ratings[st.landmark_idx]))
    want = J.extend_neighbor_graph(st.graph, st.representation,
                                   jnp.asarray(new_rep), measure, "streaming")
    ts = _carry(st)
    got = T.extend_neighbor_graph(ts.graph, ts.representation,
                                  torch.as_tensor(new_rep), measure, backend)
    assert got.indices.shape == (u + r.shape[0] - u, 5)
    _assert_graphs_agree(want, got)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_fold_in_equals_from_scratch_fit(backend):
    """``fold_in`` of b rows equals a from-scratch fit on the concatenated
    matrix with the same landmarks (graph under the tie rule, predictions
    within rtol=1e-5, atol=1e-6), and agrees with the reference's
    ``fold_in``."""
    r, spec, st, tspec = _foldin_fixture()
    u = st.ratings.shape[0]
    ts = _carry(st)
    folded = T.fold_in(ts, torch.as_tensor(r[u:]), tspec, backend=backend)
    rt = torch.as_tensor(r)
    rep = T.build_representation(rt, ts.landmark_idx, tspec.d1)
    scratch = T.build_neighbor_graph(rep, tspec.d2, tspec.k_neighbors, "dense")
    _assert_graphs_agree(scratch, folded.graph)
    _assert_graphs_agree(J.fold_in(st, jnp.asarray(r[u:]), spec,
                                   backend="streaming").graph, folded.graph)

    rng = np.random.default_rng(4)
    users = torch.as_tensor(rng.integers(0, r.shape[0], 300))
    items = torch.as_tensor(rng.integers(0, r.shape[1], 300))
    want = T.knn.predict_pairs_graph(scratch, rt, users, items)
    got = T.predict(folded, users, items, tspec)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


def test_from_dense_sims_matches_reference():
    rng = np.random.default_rng(7)
    sims = rng.normal(size=(30, 30)).astype(np.float32)
    sims[:, 4] = sims[:, 9]  # exact ties between two columns
    want = J.NeighborGraph.from_dense_sims(jnp.asarray(sims), 6)
    got = T.NeighborGraph.from_dense_sims(torch.as_tensor(sims), 6)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))


def test_compact_round_trip():
    g = T.build_neighbor_graph(torch.as_tensor(_rep(50, seed=8)), "cosine", 5,
                               "streaming")
    c = g.to_compact()
    assert c.is_compact and c.indices.dtype == torch.uint16
    assert c.weights.dtype == torch.bfloat16
    back = c.to_full()
    assert not back.is_compact
    np.testing.assert_array_equal(back.indices.numpy(), g.indices.numpy())
    np.testing.assert_allclose(back.weights.numpy(), g.weights.numpy(),
                               rtol=1e-2)
    with pytest.raises(ValueError, match="65535"):
        T.NeighborGraph(torch.zeros((70_000, 2), dtype=torch.int32),
                        torch.ones((70_000, 2))).to_compact()


def test_types_match_reference():
    """RatingMatrix's mask, transpose and user means, and the padding
    helpers, against the reference's."""
    r = _ratings(9, 7, seed=9)
    r[4] = 0.0  # a user with no ratings: mean 0
    jm = J.RatingMatrix(jnp.asarray(r), 9, 7)
    tm = T.RatingMatrix(torch.as_tensor(r), 9, 7)
    np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
    tt, jt = tm.transpose(), jm.transpose()
    assert (tt.n_users, tt.n_items) == (jt.n_users, jt.n_items) == (7, 9)
    assert tt.ratings.is_contiguous()
    np.testing.assert_array_equal(tt.ratings.numpy(), np.asarray(jt.ratings))
    np.testing.assert_allclose(tm.user_means().numpy(),
                               np.asarray(jm.user_means()), rtol=RTOL,
                               atol=ATOL)
    assert T.round_up(13, 8) == J.round_up(13, 8) == 16
    for axis, size in ((0, 12), (1, 10), (0, 5)):
        np.testing.assert_array_equal(
            T.pad_to(torch.as_tensor(r), size, axis).numpy(),
            np.asarray(J.pad_to(jnp.asarray(r), size, axis)))
