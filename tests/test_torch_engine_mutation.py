"""The port's write lane with mutations (``serving.MutableLocalBackend``) on
the CPU: the reference's ``test_engine_mutation_kinds_local``, parity with
the reference's ``MutableLocalBackend`` generation by generation, the
publish discipline, the threaded engine, and ``serve --engine --mutations``
end to end.

Tolerances (``ROADMAP.md``'s parity rule): pair predictions within
rtol=1e-5, atol=1e-6 of the reference's; the port's engine against itself
(micro-batched against solo) bitwise; generations and counters exactly.
Every wait on a thread has a timeout.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import mutation as JM
from repro.core.landmark_cf import fit as jfit
from repro.core.types import LandmarkSpec as JSpec
from repro.core.types import RatingMatrix as JRatings
from repro.lifecycle import buckets as jbuckets
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import MutableLocalBackend as JMutableLocalBackend
from repro.serving import RequestEngine as JRequestEngine
from repro_torch import mutation as TM
from repro_torch.core.convert import landmark_state_from_numpy
from repro_torch.core.types import LandmarkSpec
from repro_torch.launch import serve
from repro_torch.lifecycle import buckets
from repro_torch.serving import EngineConfig, MutableLocalBackend, RequestEngine
from repro_torch.serving import engine as engine_mod

RTOL, ATOL = 1e-5, 1e-6
U, P = 96, 40
KW = dict(n_landmarks=8, selection="popularity", k_neighbors=5, d2="cosine")
JSPEC, SPEC = JSpec(**KW), LandmarkSpec(**KW)
CFG = dict(max_batch=32, min_shape=8, fold_bq=8)


def _ratings(u, p, seed=0, density=0.35):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    return r * (rng.random((u, p)) < density)


@pytest.fixture(scope="module")
def fitted():
    """The reference's fit of a (96, 40) block, carried into the port."""
    jst = jfit(jax.random.PRNGKey(0),
               JRatings(jnp.asarray(_ratings(U, P, seed=16)), U, P), JSPEC)
    st = landmark_state_from_numpy({
        "landmark_idx": np.asarray(jst.landmark_idx),
        "representation": np.asarray(jst.representation),
        "ratings": np.asarray(jst.ratings),
        "graph.indices": np.asarray(jst.graph.indices),
        "graph.weights": np.asarray(jst.graph.weights)}, device="cpu")
    return jst, st


def _backend(st, **kw):
    return MutableLocalBackend(buckets.from_state(st, min_bucket=32), SPEC,
                               min_bucket=32, **kw)


def _no_tomb_citations(mst, dead):
    g = mst.bstate.state.graph
    gi, gw = g.indices.numpy(), g.weights.numpy()
    live = np.nonzero(~mst.tomb.numpy()[:mst.n_valid])[0]
    cit = np.isin(gi[live], dead) & ~((gi[live] == 0) & (gw[live] == 0.0))
    return not cit.any()


UP_IDS = np.array([5, 30, 60])
RM_IDS = np.array([3, 17, 40, 41, 77, 90, 8, 20])


def test_engine_mutation_kinds_local(fitted):
    """update/remove ride the engine's write lane: atomic generation swaps,
    drained repairs, live stats, bitwise verify, a compacting refresh."""
    be = _backend(fitted[1])
    eng = RequestEngine(be, EngineConfig(**CFG))
    rng = np.random.default_rng(17)
    users = rng.integers(0, U, 16)
    items = rng.integers(0, P, 16)
    r0 = eng.submit("pair", users=users, items=items)
    eng.pump_reads()
    assert r0.done.is_set()

    ru = eng.submit("update", users=UP_IDS, rows=_ratings(3, P, seed=18))
    rr = eng.submit("remove", users=RM_IDS)
    assert eng.pump_folds() == 2
    assert ru.done.is_set() and rr.done.is_set()
    assert (ru.result, rr.result) == (1, 2) and be.generation == 2
    assert be.snapshot()[0].dirty_count() == 0

    r1 = eng.submit("topn", users=users)
    eng.pump_reads()
    assert r1.done.is_set()
    stats = eng.stats()
    assert stats["mutated_rows"] == 11
    assert stats["completed"]["update"] == stats["completed"]["remove"] == 1
    assert 0 < stats["tombstone_frac"] < 1 and stats["repaired_rows"] > 0
    checked, bad = eng.verify_sample()
    assert bad == 0 and checked > 0

    mst = be.snapshot()[0]
    assert _no_tomb_citations(mst, RM_IDS)
    assert set(np.flatnonzero(be.tomb())) == set(RM_IDS.tolist())
    r2 = eng.submit("pair", users=users, items=items)
    eng.pump_reads()
    want = TM.predict_pairs(mst, torch.as_tensor(users),
                            torch.as_tensor(items)).numpy()
    np.testing.assert_array_equal(r2.result, want)

    gen, table = be.refresh()
    assert gen == 3 and (table[RM_IDS] == -1).all()
    live = np.setdiff1d(np.arange(U), RM_IDS)
    np.testing.assert_array_equal(table[live], np.arange(len(live)))
    assert be.tombstone_frac == 0.0 and be.n_users == U - 8
    preds = TM.predict_pairs(be.snapshot()[0],
                             torch.as_tensor(table[live[:8]]),
                             torch.as_tensor(items[:8]))
    assert torch.isfinite(preds).all()


def test_predictions_at_each_generation_match_the_reference(fitted):
    """The same writes through the reference's and the port's mutable
    backends, from one fitted state: after every write (an update, a
    removal, a fold, a compacting refresh) the published generation and
    the pair predictions agree — the port's within the parity rule of the
    reference's ``mutation.predict_pairs`` on the reference's state."""
    jst, st = fitted
    jbe = JMutableLocalBackend(jbuckets.from_state(jst, min_bucket=32), JSPEC,
                               min_bucket=32)
    be = _backend(st)
    rng = np.random.default_rng(19)
    users = rng.integers(0, U - 8, 32)
    items = rng.integers(0, P, 32)
    steps = [
        lambda b: b.apply_update(UP_IDS, _ratings(3, P, seed=18)),
        lambda b: b.apply_remove(RM_IDS),
        lambda b: b.fold_in(_ratings(8, P, seed=20), 8),
        lambda b: b.apply_update(np.array([0, 95]), _ratings(2, P, seed=21)),
        lambda b: b.refresh()[0],
    ]
    for step in steps:
        assert step(jbe) == step(be)
        jm, tm = jbe.snapshot()[0], be.snapshot()[0]
        assert tm.n_valid == int(jm.bstate.n_valid)
        np.testing.assert_array_equal(tm.tomb.numpy(), np.asarray(jm.tomb))
        want = np.asarray(JM.predict_pairs(jm, jnp.asarray(users, jnp.int32),
                                           jnp.asarray(items, jnp.int32)))
        got = be.predict_pairs(be.snapshot(), users, items)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert be.repaired_rows == jbe.repaired_rows


@pytest.mark.parametrize("kind", ["fold", "update", "remove", "refresh"])
def test_writes_never_touch_the_published_generation(fitted, kind):
    """Every write builds the next generation in fresh tensors: the
    generation a read holds keeps its bits."""
    be = _backend(fitted[1])
    be.apply_remove(np.array([1, 2]))  # tombstones for refresh to compact
    pub = be.snapshot()
    before = [t.clone() for t in be._state_tensors(pub[0])]
    {"fold": lambda: be.fold_in(_ratings(4, P, seed=22), 8),
     "update": lambda: be.apply_update(np.array([4, 9]),
                                       _ratings(2, P, seed=23)),
     "remove": lambda: be.apply_remove(np.array([6])),
     "refresh": lambda: be.refresh()}[kind]()
    assert be.generation == 2
    for a, b in zip(before, be._state_tensors(pub[0])):
        assert torch.equal(a, b)


def test_removed_users_vanish_from_reads_at_publish(fitted):
    """A deleted user never contributes to another user's prediction once
    the removal publishes (the tomb mask on the read path)."""
    be = _backend(fitted[1])
    mst = be.snapshot()[0]
    g = mst.bstate.state.graph
    victim = int(g.indices[0, 0])  # user 0's top neighbor
    be.apply_remove(np.array([victim]))
    new = be.snapshot()[0]
    assert victim not in new.bstate.state.graph.indices[0].tolist()
    assert not new.bstate.state.ratings[victim].any()
    assert new.tomb[victim]


def test_threaded_engine_reads_folds_and_mutations(fitted):
    """Client threads reading while folds, updates and removals drain on
    the write lane's own thread: every admitted request completes, the
    final generation counts every write, no live row cites a removed
    one, and the live generation's sample re-runs bitwise."""
    be = _backend(fitted[1])
    cfg = EngineConfig(max_batch=16, min_shape=4, queue_cap=4096,
                       max_wait_ms=0.5, slo_ms=500.0, fold_bq=8, topn=5)
    eng = RequestEngine(be, cfg)
    eng.start()
    done, lock = [], threading.Lock()

    def client(seed):
        rng = np.random.default_rng(seed)
        mine = []
        for _ in range(12):
            m = int(rng.integers(1, 6))
            uu = rng.integers(0, U, m)
            r = (eng.submit("topn", users=uu) if rng.random() < 0.3 else
                 eng.submit("pair", users=uu, items=rng.integers(0, P, m)))
            assert r is not None and r.done.wait(10.0)
            mine.append(r)
        with lock:
            done.extend(mine)

    threads = [threading.Thread(target=client, args=(60 + i,))
               for i in range(3)]
    try:
        for t in threads:
            t.start()
        writes = [eng.submit("fold", rows=_ratings(4, P, seed=70)),
                  eng.submit("update", users=UP_IDS,
                             rows=_ratings(3, P, seed=71)),
                  eng.submit("remove", users=RM_IDS),
                  eng.submit("fold", rows=_ratings(4, P, seed=72))]
        for t in threads:
            t.join(timeout=30.0)
            assert not t.is_alive()
        assert all(w.done.wait(10.0) for w in writes)
    finally:
        eng.stop()
    assert len(done) == 36 and be.generation == 4
    assert [w.generation for w in writes] == [1, 2, 3, 4]
    assert all(np.isfinite(r.result).all() for r in done if r.kind == "pair")
    assert _no_tomb_citations(be.snapshot()[0], RM_IDS)
    assert eng.stats()["mutated_rows"] == 11
    eng.submit("pair", users=np.arange(U, U + 8), items=np.zeros(8, int))
    eng.pump_reads()
    checked, bad = eng.verify_sample()
    assert checked >= 1 and bad == 0


def test_publish_metrics_carries_the_write_lane(fitted):
    from repro_torch import obs as obslib

    o = obslib.Observability(sample_rate=1.0, seed=0)
    be = _backend(fitted[1])
    eng = RequestEngine(be, EngineConfig(**CFG), obs=o)
    eng.submit("remove", users=RM_IDS)
    eng.pump_folds()
    eng.publish_metrics()
    snap = o.registry.snapshot()
    assert snap["counters"]["engine.mutated_rows"] == 8
    assert snap["counters"]["engine.repaired_rows"] == be.repaired_rows > 0
    assert snap["gauges"]["engine.tombstone_frac"] == pytest.approx(8 / U)
    assert snap["histograms"]["engine.latency_ms.remove"]["count"] == 1


def test_mutation_kinds_keep_the_reference_names():
    assert engine_mod.WRITE_KINDS == ("fold",) + engine_mod.MUTATION_KINDS
    assert engine_mod._mutation_shape(3) == 8
    assert engine_mod._mutation_shape(9) == 16


# ----------------------------------------------------------------- the CLI
def test_engine_cli_mutations_smoke_on_cpu(capsys):
    """``serve --engine --mutations --smoke`` end to end on the CPU at a
    fixed 500 requests/s (as the engine CLI tests pin it): updates and
    removals drain, the drift monitor reports, the refresh compacts the
    tombstones, and the audit re-runs with 0 mismatches."""
    out = serve.main(["--workload", "cf", "--engine", "--mutations",
                      "--smoke", "--device", "cpu", "--duration", "2",
                      "--rate", "500"])
    text = capsys.readouterr().out
    assert text.rstrip().endswith("cf engine: done")
    assert " 0 mismatches | non-finite predictions: 0" in text
    assert out["mismatches"] == 0 and out["checked"] > 0
    assert out["completed"]["update"] >= 1
    assert out["completed"]["remove"] >= 1
    for line in ("write lane: ", "drift monitor: ", "refresh swap: "):
        assert line in text
    assert "tombstone_frac=0.000" in text.split("refresh swap: ")[1]
    mut = out["mutations"]
    assert mut["cites_dead"] == 0 and mut["dirty_published"] == 0
    assert mut["compacted"] == mut["removed"] > 0
    assert mut["post_tombstone_frac"] == 0.0
    assert mut["write_latency"]["update"].count >= 1
    assert max(out["geometries"].values()) <= out["geometry_budget"]


def test_engine_cli_mutations_need_the_engine():
    """``--mutations`` without ``--engine`` is refused with the
    reference's message."""
    from repro.launch import serve as jserve

    argv = ["--workload", "cf", "--smoke", "--mutations"]
    with pytest.raises(SystemExit) as got:
        serve.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as want:
        jserve.main(argv)
    assert str(got.value) == str(want.value)
