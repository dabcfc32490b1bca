"""The port's continual-serving lifecycle (``repro_torch.lifecycle``), its
landmark selection strategies and its drifting stream, against the JAX
reference on the CPU, and the lifecycle serve CLI end to end.

Tolerances:
- predictions: rtol=1e-5, atol=1e-6 (f32 sums in different orders);
- neighbor lists: weights within that tolerance, ids equal except where
  the reference's weights tie within it at the cut
  (``core.topk.list_mismatches``);
- the drifting stream: byte-identical (the same numpy generator);
- the random selection strategies and the reservoir draw from a
  ``torch.Generator``, whose bits differ from ``jax.random``: they are held
  to their contracts (distinct in-range ids, determinism per seed, the
  reservoir's fill and offer counts), not to the reference's picks.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.data.synthetic import drifting_ratings as j_drifting
from repro.lifecycle import buckets as jbuckets
import repro_torch.core as T
from repro_torch.core import selection
from repro_torch.core.convert import landmark_state_from_numpy
from repro_torch.core.graph import extend_neighbor_graph_bucketed
from repro_torch.core.topk import list_mismatches
from repro_torch.data.synthetic import drifting_ratings
from repro_torch.lifecycle import buckets, monitor, policy
from repro_torch.lifecycle.monitor import Snapshot
from repro_torch.lifecycle.refresh import RefreshManager
from repro_torch.train.checkpoint import latest_step, load_landmark_state

RTOL, ATOL = 1e-5, 1e-6
SPEC = T.LandmarkSpec(n_landmarks=8, selection="popularity", k_neighbors=5)
JSPEC = J.LandmarkSpec(n_landmarks=8, selection="popularity", k_neighbors=5)


def _ratings(u, p, density=0.35, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    return r * (rng.random((u, p)) < density)


@pytest.fixture(scope="module")
def fitted():
    """The reference's fit of a (120, 48) block, carried into the port."""
    r = _ratings(120, 48, seed=1)
    jst = J.fit(jax.random.PRNGKey(0), J.RatingMatrix(jnp.asarray(r), 120,
                                                      48), JSPEC)
    st = landmark_state_from_numpy({
        "landmark_idx": np.asarray(jst.landmark_idx),
        "representation": np.asarray(jst.representation),
        "ratings": np.asarray(jst.ratings),
        "graph.indices": np.asarray(jst.graph.indices),
        "graph.weights": np.asarray(jst.graph.weights)}, device="cpu")
    return jst, st, r


def _agree(want_w, want_i, got_w, got_i):
    bad = list_mismatches(np.asarray(want_w), np.asarray(want_i), got_w,
                          got_i, RTOL, ATOL)
    assert bad.size == 0, f"rows disagree beyond the tie rule: {bad[:10]}"


# ------------------------------------------------------------------ stream
@pytest.mark.parametrize("seed,wave", [(0, 0), (0, 5), (7, 3), (3, 7)])
def test_drifting_ratings_byte_identical(seed, wave):
    a = drifting_ratings(seed, wave, 20, 64, n_waves=8, drift=0.7)
    b = j_drifting(seed, wave, 20, 64, n_waves=8, drift=0.7)
    assert a.dtype == np.float32 and a.tobytes() == b.tobytes()


# --------------------------------------------------------------- selection
@pytest.mark.parametrize("strategy", selection.STRATEGIES)
@pytest.mark.parametrize("u,n", [(40, 6), (40, 10), (200, 20), (12, 11)])
def test_selection_returns_n_distinct_ids_deterministically(strategy, u, n):
    """n distinct in-range ids, the same for the same generator seed (the
    (12, 11) case runs the coresets pool dry, so duplicate picks occur and
    the final top-n must still be distinct)."""
    r = torch.as_tensor(_ratings(u, 24, density=0.3, seed=u + n))
    pick = [T.select_landmarks(r, n, strategy,
                               torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert pick[0].shape == (n,) and pick[0].dtype == torch.int64
    assert int(pick[0].min()) >= 0 and int(pick[0].max()) < u
    assert len(set(pick[0].tolist())) == n
    assert torch.equal(pick[0], pick[1])


def test_selection_cost_ordering():
    """The paper's cost ordering (claim C6), by the d1 work each strategy
    does: random, dist. of ratings and popularity compute no similarity;
    both coresets variants score every user against each round's
    candidates, one d1 call per round of the halving schedule."""
    r = torch.as_tensor(_ratings(200, 30, seed=2))
    calls = []

    def counting(a, b, measure):
        calls.append(a.shape[0] * b.shape[0])
        return T.masked_similarity(a, b, measure)

    cost = {}
    for strategy in selection.STRATEGIES:
        calls.clear()
        T.select_landmarks(r, 20, strategy, torch.Generator().manual_seed(0),
                           sim_fn=counting)
        cost[strategy] = sum(calls)
    rounds = selection._coreset_rounds(200, 20)
    per_round = math.ceil(20 / rounds)
    assert cost["random"] == cost["dist_ratings"] == cost["popularity"] == 0
    assert cost["coresets"] == cost["coresets_random"] == \
        rounds * 200 * per_round


def test_fit_takes_a_generator(fitted):
    r = torch.as_tensor(_ratings(90, 40, seed=3))
    spec = T.LandmarkSpec(n_landmarks=8, selection="coresets", k_neighbors=5)
    a, b, c = (T.fit(T.RatingMatrix(r, 90, 40), spec,
                     generator=torch.Generator().manual_seed(s))
               for s in (1, 1, 2))
    assert torch.equal(a.landmark_idx, b.landmark_idx)
    assert torch.equal(a.graph.indices, b.graph.indices)
    assert not torch.equal(a.landmark_idx, c.landmark_idx)


# ----------------------------------------------------------------- buckets
def test_bucket_schedule_matches_reference():
    for args in ((5000, 256, 2.0), (1000, 100, 1.3), (1, 8, 1.5)):
        assert buckets.bucket_schedule(*args) == jbuckets.bucket_schedule(*args)
    for n in (1, 255, 256, 257, 5000):
        assert buckets.bucket_capacity(n, 256, 2.0) == \
            jbuckets.bucket_capacity(n, 256, 2.0)


def test_bucketed_predictions_match_reference_and_ignore_padding(fitted):
    jst, st, _ = fitted
    bst = buckets.from_state(st, min_bucket=64, growth=2.0)
    assert bst.capacity == 128 and bst.n_valid == 120
    assert bst.state.ratings.data_ptr() != st.ratings.data_ptr()
    rng = np.random.default_rng(2)
    users = rng.integers(0, 120, 200).astype(np.int32)
    items = rng.integers(0, 48, 200).astype(np.int32)
    jb = jbuckets.from_state(jst, min_bucket=64, growth=2.0)
    want = np.asarray(jbuckets.predict_pairs(jb, jnp.asarray(users),
                                             jnp.asarray(items)))
    got = buckets.predict_pairs(bst, torch.as_tensor(users),
                                torch.as_tensor(items))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # poison the padding: garbage ratings and links into the padded rows
    bst.state.ratings[120:] = 5.0
    bst.state.graph.indices[120:] = 3
    bst.state.graph.weights[120:] = 9.0
    bst.state.graph.indices[:5, -1] = 125  # a link out of the valid prefix
    again = buckets.predict_pairs(bst, torch.as_tensor(users),
                                  torch.as_tensor(items))
    keep = ~np.isin(users, np.arange(5))
    np.testing.assert_array_equal(again.numpy()[keep], got.numpy()[keep])
    items_r, scores = buckets.recommend_topn(bst, torch.as_tensor(users[:8]),
                                             n=5)
    assert items_r.shape == (8, 5) and torch.isfinite(scores).all()


@pytest.mark.parametrize("measure", T.MEASURES)
def test_fold_in_bucketed_matches_growing_fold_in_and_reference(fitted,
                                                                measure):
    """Three ragged bucketed fold-ins (batch bucket 8: 8, 8, 3 rows) against
    one growing fold-in of the same 19 rows and the reference's bucketed
    steps; both new-vs-all backends (streaming; kernel, whose wrapper runs
    its plain version here)."""
    jst, st, r = fitted
    spec = T.LandmarkSpec(n_landmarks=8, k_neighbors=5, d2=measure)
    jspec = J.LandmarkSpec(n_landmarks=8, k_neighbors=5, d2=measure)
    new = _ratings(19, 48, seed=4)
    grown = T.fold_in(st, torch.as_tensor(new), spec, backend="streaming")
    jb = jbuckets.fold_in_rows(
        jbuckets.from_state(jst, min_bucket=64, growth=2.0), new, 8, jspec,
        64, 2.0)
    jg = jb.state.graph
    for backend in ("streaming", "kernel"):
        bst = buckets.from_state(st, min_bucket=64, growth=2.0)
        for lo in range(0, 19, 8):
            chunk = torch.zeros((8, 48))
            part = torch.as_tensor(new[lo:lo + 8])
            chunk[:part.shape[0]] = part
            bst, _ = buckets.ensure_capacity(bst, 8, 64, 2.0)
            bst = buckets.fold_in_bucketed(bst, chunk, part.shape[0], spec,
                                           backend=backend)
        assert bst.n_valid == 139 and bst.capacity == 256
        g = bst.state.graph
        _agree(grown.graph.weights, grown.graph.indices, g.weights[:139],
               g.indices[:139])
        _agree(np.asarray(jg.weights)[:139], np.asarray(jg.indices)[:139],
               g.weights[:139], g.indices[:139])
        assert (g.weights[139:] == 0).all() and (g.indices[139:] == 0).all()
        assert (g.indices[:139] < 139).all()
        np.testing.assert_array_equal(bst.state.ratings[:139].numpy(),
                                      np.concatenate([r, new]))


def test_bucketed_extend_backends_agree_at_ragged_batch(fitted):
    _, st, _ = fitted
    bst = buckets.from_state(st, min_bucket=64, growth=2.0)
    rep = bst.state.representation.clone()
    new_rep = torch.as_tensor(np.random.default_rng(5).normal(
        size=(4, rep.shape[1])).astype(np.float32))
    new_rep[3:] = 0.0  # filler row
    rep[120:124] = new_rep
    a, b = (extend_neighbor_graph_bucketed(bst.state.graph, rep, new_rep,
                                           120, 3, "euclidean", backend)
            for backend in ("streaming", "kernel"))
    _agree(a.weights, a.indices, b.weights, b.indices)
    assert (a.indices[123:] == 0).all() and (a.weights[123:] == 0).all()


def test_geometries_are_recorded_per_family(fitted):
    _, st, _ = fitted
    buckets.reset_geometries()
    bst = buckets.from_state(st, min_bucket=64, growth=2.0)
    rows = _ratings(20, 48, seed=6)
    bst = buckets.fold_in_rows(bst, rows[:8], 8, SPEC, 64, 2.0)  # fits 128
    bst = buckets.fold_in_rows(bst, rows, 8, SPEC, 64, 2.0)  # grows to 256
    users = torch.zeros(16, dtype=torch.int32)
    buckets.predict_pairs(bst, users, users)
    buckets.recommend_topn(bst, users)
    assert buckets.geometry_counts() == {"fold": 2, "pair": 1, "topn": 1}
    assert buckets.GEOMETRIES["fold"] == {(128, 8), (256, 8)}


# ----------------------------------------------------------------- monitor
def test_reservoir_fills_then_samples_bounded():
    mon = monitor.init_monitor(32, n_base=100, base_coverage=1.0,
                               device="cpu")
    gen = torch.Generator().manual_seed(0)
    for step in range(5):
        users = torch.arange(20, dtype=torch.int32) + 100 * step
        mon = monitor.reservoir_add(mon, gen, users, torch.arange(20),
                                    torch.full((20,), 3.0), 20)
    assert mon.res_filled == 32  # capped at capacity
    assert mon.res_seen == 100  # but every offer was counted
    assert len(set(mon.res_users.tolist())) == 32  # distinct offered users
    assert set(mon.res_users.tolist()) <= set(range(0, 420))
    mon2 = monitor.init_monitor(32, 100, 1.0, device="cpu")
    mon2 = monitor.reservoir_add(mon2, gen, torch.arange(20),
                                 torch.arange(20), torch.full((20,), 3.0), 7)
    assert mon2.res_filled == 7 and mon2.res_seen == 7
    assert mon2.res_users[:7].tolist() == list(range(7))


def test_reservoir_keeps_a_uniform_sample():
    """Algorithm R: after 2000 offers into 100 slots, each offer survives
    with probability 1/20 — early and late halves hold about the same
    share."""
    mon = monitor.init_monitor(100, 0, 1.0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for step in range(20):
        ids = torch.arange(100) + 100 * step
        mon = monitor.reservoir_add(mon, gen, ids, ids, torch.ones(100), 100)
    early = int((mon.res_users < 1000).sum())
    assert 30 <= early <= 70, early


def test_monitor_coverage_volume_and_holdout(fitted):
    jst, st, r = fitted
    base = monitor.batch_coverage(st.representation, torch.ones(120))
    want = float(jax.jit(lambda x: jnp.mean(jnp.max(jnp.abs(x), axis=1)))(
        jst.representation))
    assert base == pytest.approx(want, rel=1e-6)
    mon = monitor.init_monitor(64, 120, base, device="cpu")
    dead = torch.zeros((8, st.representation.shape[1]))
    mon = monitor.observe_fold_in(mon, dead, 8, alpha=1.0)
    assert mon.coverage == 0.0 and mon.n_folded == 8
    rows, cols = np.nonzero(r)
    pick = np.random.default_rng(0).choice(len(rows), 40, replace=False)
    mon = monitor.reservoir_add(
        mon, torch.Generator().manual_seed(1),
        torch.as_tensor(rows[pick]), torch.as_tensor(cols[pick]),
        torch.as_tensor(r[rows[pick], cols[pick]]), 40)
    bst = buckets.from_state(st, min_bucket=64, growth=2.0)
    snap = monitor.holdout_snapshot(mon, bst)
    assert snap.coverage_ratio == 0.0
    assert snap.foldin_frac == pytest.approx(8 / 128)
    assert snap.holdout_count == 40
    preds = buckets.predict_pairs(bst, torch.as_tensor(rows[pick]),
                                  torch.as_tensor(cols[pick])).numpy()
    err = preds - r[rows[pick], cols[pick]]
    assert snap.mae == pytest.approx(np.abs(err).mean(), rel=1e-5)
    assert snap.rmse == pytest.approx(np.sqrt((err ** 2).mean()), rel=1e-5)
    mon = monitor.rebase(mon, 130, 0.5)
    assert (mon.n_base, mon.n_folded, mon.coverage) == (130, 0, 0.5)
    assert mon.res_filled == 40  # the reservoir survives a swap


# ------------------------------------------------------------------ policy
def _snap(mae=1.0, cov=1.0, frac=0.0, count=100):
    return Snapshot(mae=mae, rmse=mae, holdout_count=count, foldin_frac=frac,
                    coverage=cov, coverage_ratio=cov)


def test_policy_fires_only_after_patience():
    spec = policy.RefreshSpec(patience=2, cooldown_waves=3, mae_ratio=1.1)
    pol = policy.PolicyState(base_mae=1.0)
    fire, reasons = policy.decide(pol, spec, _snap(mae=1.5))
    assert not fire and reasons
    assert policy.decide(pol, spec, _snap(mae=1.5))[0]
    pol2 = policy.PolicyState(base_mae=1.0)
    policy.decide(pol2, spec, _snap(mae=1.5))
    policy.decide(pol2, spec, _snap(mae=1.0))
    fire, _ = policy.decide(pol2, spec, _snap(mae=1.5))
    assert not fire and pol2.streak == 1


def test_policy_cooldown_refreshing_and_other_signals():
    spec = policy.RefreshSpec(patience=1, cooldown_waves=2, mae_ratio=1.1)
    pol = policy.PolicyState(base_mae=1.0)
    assert policy.decide(pol, spec, _snap(mae=2.0))[0]
    policy.on_fire(pol)
    assert not policy.decide(pol, spec, _snap(mae=2.0))[0]  # in flight
    policy.on_swap(pol, 1, post_swap_mae=1.0, spec=spec)
    assert pol.generation == 1 and pol.base_mae == 1.0
    assert not policy.decide(pol, spec, _snap(mae=2.0))[0]  # cooldown 2
    assert not policy.decide(pol, spec, _snap(mae=2.0))[0]  # cooldown 1
    assert policy.decide(pol, spec, _snap(mae=2.0))[0]
    spec = policy.RefreshSpec(patience=1, min_holdout=32, mae_ratio=1.1,
                              min_coverage_ratio=0.8, max_foldin_frac=0.5)
    pol = policy.PolicyState(base_mae=1.0)
    assert not policy.decide(pol, spec, _snap(mae=9.0, count=10))[0]
    assert policy.decide(pol, spec, _snap(cov=0.5))[0]
    assert policy.decide(policy.PolicyState(), spec, _snap(frac=0.7))[0]


def test_skew_signal_and_rebalance_hysteresis():
    assert monitor.shard_skew(np.array([4, 4, 4, 4])) == 1.0
    assert monitor.shard_skew(torch.tensor([8, 0, 0, 0])) == 4.0
    assert monitor.shard_skew(np.array([0, 0])) == 1.0
    spec = policy.RefreshSpec(max_skew=2.0, rebalance_patience=2)
    pol = policy.PolicyState()
    assert not policy.should_rebalance(pol, spec, 3.0)
    assert policy.should_rebalance(pol, spec, 3.0)
    assert not policy.should_rebalance(pol, spec, 3.0)
    assert not policy.should_rebalance(pol, spec, 1.9)
    assert policy.should_compact(policy.RefreshSpec(compact_serving=True),
                                 1000)
    assert not policy.should_compact(policy.RefreshSpec(), 1000)


def test_refresh_configs_match_reference():
    import dataclasses

    from repro.configs import landmark_cf as jcfg
    from repro_torch.configs import landmark_cf as tcfg

    assert dataclasses.asdict(tcfg.REFRESH) == dataclasses.asdict(jcfg.REFRESH)
    assert (dataclasses.asdict(tcfg.SMOKE_REFRESH)
            == dataclasses.asdict(jcfg.SMOKE_REFRESH))


# ----------------------------------------------------------------- refresh
def test_refresh_manager_commits_oracle_exact_generation(tmp_path, fitted):
    _, _, r = fitted
    acc = np.concatenate([r, _ratings(16, 48, seed=9)])
    spec = T.LandmarkSpec(n_landmarks=8, selection="coresets", k_neighbors=5)
    mgr = RefreshManager(str(tmp_path), spec, device="cpu")
    assert mgr.request(acc, generation=1)
    assert not mgr.request(acc, generation=2)  # one in flight
    mgr.join()
    gen, st_new = mgr.poll()
    assert gen == 1 and mgr.poll() is None  # delivered exactly once
    assert latest_step(str(tmp_path)) == 1
    oracle = T.fit(T.RatingMatrix(torch.as_tensor(acc), *acc.shape), spec,
                   generator=torch.Generator().manual_seed(1))
    assert torch.equal(st_new.landmark_idx, oracle.landmark_idx)
    assert torch.equal(st_new.graph.indices, oracle.graph.indices)
    assert torch.equal(st_new.graph.weights, oracle.graph.weights)
    loaded = load_landmark_state(str(tmp_path), device="cpu")
    assert torch.equal(loaded.graph.weights, oracle.graph.weights)
    np.testing.assert_array_equal(loaded.ratings.numpy(), acc)
    with pytest.raises(ValueError, match="generation must increase"):
        mgr.request(acc, generation=1)


def test_refresh_manager_rebuilds_ivf_index_inside_swap(tmp_path, fitted):
    from repro_torch.retrieval import IVFSpec

    _, _, r = fitted
    mgr = RefreshManager(str(tmp_path), SPEC, ivf=IVFSpec(n_clusters=6),
                         device="cpu")
    assert mgr.request(r, generation=1)
    mgr.join()
    gen, st_new, index = mgr.poll()
    assert gen == 1 and index.n_clusters == 6
    ids = sorted(int(i) for c in range(6)
                 for i in index.lists[c, :int(index.fill[c])])
    assert ids == list(range(st_new.representation.shape[0]))


def test_refresh_manager_surfaces_thread_errors(tmp_path):
    mgr = RefreshManager(str(tmp_path), SPEC, device="cpu")
    mgr.request(np.zeros((0, 8), np.float32), generation=1)
    mgr.join()
    with pytest.raises(RuntimeError, match="background refresh failed"):
        mgr.poll()


# -------------------------------------------------------------- replay e2e
@pytest.mark.parametrize("extra", [[], ["--retrieval", "ivf",
                                        "--early-exit"]])
def test_lifecycle_replay_end_to_end(tmp_path, capsys, extra):
    """The reference's acceptance replay, on the CPU: a fired refresh, the
    swapped generation serving, an oracle-exact artifact, geometries within
    the buckets used (asserted inside the replay), and with IVF retrieval a
    mean recall at or above the 0.95 SLO."""
    from repro_torch.launch import serve

    serve.main([
        "--workload", "cf", "--lifecycle", "--smoke", "--ckpt", str(tmp_path),
        "--users", "128", "--items", "64", "--waves", "6", "--arrivals", "32",
        "--requests", "2", "--batch", "32", "--min-bucket", "128",
        "--device", "cpu"] + extra)
    out = capsys.readouterr().out
    assert "cf lifecycle: done" in out
    assert "refresh -> gen 1 launched in background" in out
    assert "swapped in gen 1" in out
    assert "swap oracle-exact vs from-scratch fit (gen 1): True" in out
    assert "wave 5: gen 1" in out
    assert "geometries per request-path family" in out
    assert latest_step(str(tmp_path)) == 1
    if extra:
        line = next(ln for ln in out.splitlines()
                    if ln.startswith("ivf retrieval: recall@k per wave"))
        assert float(line.split("(mean ")[1].split(",")[0]) >= 0.95
        assert "probed/q=" in out
