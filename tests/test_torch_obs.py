"""The port's observability layer (``repro_torch.obs``) on the CPU: the
single-process cases of ``tests/test_obs.py`` against the port — histogram
bucket edges, percentiles within one bucket width, merge, registry delta
and publish, the bounded tracer, spans under concurrent submit, the
disabled configuration — plus the port against the reference where both
compute the same thing (the sampler's coin sequence, the published
snapshot and retrieval series), the profiler hook, and the serve CLI's
exports through the reference's checker (``benchmarks/check_obs.py``,
imported, not edited).

Exact equality throughout: the registry, sampler and publishers are the
same pure-Python arithmetic in both packages.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import dataclasses
import json
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as J
from benchmarks import check_obs
from repro.lifecycle.monitor import Snapshot as JSnapshot
from repro.lifecycle.monitor import publish_snapshot as j_publish_snapshot
from repro.obs import MetricsRegistry as JMetricsRegistry
from repro.obs import Sampler as JSampler
from repro.retrieval import publish_retrieval as j_publish_retrieval
import repro_torch.core as T
from repro_torch import obs as obslib
from repro_torch.core.convert import landmark_state_from_numpy
from repro_torch.launch import serve
from repro_torch.lifecycle import buckets
from repro_torch.lifecycle.monitor import Snapshot, publish_snapshot
from repro_torch.obs import (Histogram, MetricsRegistry, Observability,
                             Sampler, Tracer)
from repro_torch.retrieval import publish_retrieval
from repro_torch.serving import EngineConfig, LocalBackend, RequestEngine

SPEC = T.LandmarkSpec(n_landmarks=8, selection="popularity", k_neighbors=5)
U, P = 64, 24


def _ratings(u, p, density=0.35, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    r *= rng.random((u, p)) < density
    return r


@pytest.fixture(scope="module")
def state():
    """The reference's fit of a (64, 24) block, carried into the port."""
    r = _ratings(U, P, seed=3)
    jst = J.fit(jax.random.PRNGKey(0), J.RatingMatrix(jnp.asarray(r), U, P),
                J.LandmarkSpec(n_landmarks=8, selection="popularity",
                               k_neighbors=5))
    return landmark_state_from_numpy({
        "landmark_idx": np.asarray(jst.landmark_idx),
        "representation": np.asarray(jst.representation),
        "ratings": np.asarray(jst.ratings),
        "graph.indices": np.asarray(jst.graph.indices),
        "graph.weights": np.asarray(jst.graph.weights)}, device="cpu")


def _local_backend(state):
    return LocalBackend(buckets.from_state(state, min_bucket=U), SPEC,
                        min_bucket=U)


# how long a write-lane apply waits for a read batch to run inside it
HOLD_S = 10.0


@pytest.fixture
def folds_overlap_reads(monkeypatch):
    """The read/fold overlap that ``check_obs --require-overlap`` asks
    for, by construction: each write-lane apply (the engine's
    ``_apply_write``, inside its ``apply[...]`` span) stays open after its
    fold until a read batch's backend call (inside its ``execute[...]``
    span) has returned while it was open, or HOLD_S has passed. That
    moment lies in both spans. A small fold at U = 64 is short, and on a
    CPU shared with other workers the two lanes did not always meet
    (ROADMAP A9). Returns the list of holds that timed out."""
    lock = threading.Lock()
    open_holds = []
    missed = []
    apply_write = RequestEngine._apply_write

    def held_apply(self, req):
        seen = threading.Event()
        with lock:
            open_holds.append(seen)
        try:
            out = apply_write(self, req)
            if not seen.wait(HOLD_S):
                missed.append(req.kind)
            return out
        finally:
            with lock:
                open_holds.remove(seen)

    def signalling(read):
        def call(self, *args, **kw):
            out = read(self, *args, **kw)
            with lock:
                for seen in open_holds:
                    seen.set()
            return out
        return call

    monkeypatch.setattr(RequestEngine, "_apply_write", held_apply)
    for name in ("predict_pairs", "recommend_topn"):
        monkeypatch.setattr(LocalBackend, name,
                            signalling(getattr(LocalBackend, name)))
    return missed


# --------------------------------------------------------------- histogram
def test_histogram_bucket_boundary_exactness():
    """Bucket i covers (edges[i-1], edges[i]]: a value equal to an edge
    lands in that edge's OWN bucket, never the next one."""
    h = Histogram(lo=1.0, hi=16.0, growth=2.0)
    np.testing.assert_allclose(h.edges, [1.0, 2.0, 4.0, 8.0, 16.0])
    assert len(h.counts) == len(h.edges) + 1  # overflow slot
    for v in (1.0, 0.25, 2.0, 1.5, 2.0001, 16.0, 16.0001):
        h.record(v)
    assert list(h.counts) == [2, 2, 1, 0, 1, 1]
    assert h.count == 7 == int(h.counts.sum())
    assert h.vmin == 0.25 and h.vmax == 16.0001
    assert abs(h.total - (1.0 + 0.25 + 2.0 + 1.5 + 2.0001 + 16.0
                          + 16.0001)) < 1e-9
    with pytest.raises(ValueError, match="geometry"):
        Histogram(lo=1.0, hi=0.5)


def test_histogram_percentile_within_one_bucket_width():
    """percentile(q) stays within one multiplicative bucket width of the
    exact inverted_cdf order statistic."""
    growth = 2 ** 0.125
    rng = np.random.default_rng(5)
    vals = np.exp(rng.normal(1.0, 1.5, 5000))  # spans many buckets
    h = Histogram(lo=1e-3, hi=6e4, growth=growth)
    for v in vals:
        h.record(float(v))
    for q in (10.0, 50.0, 90.0, 95.0, 99.0, 100.0):
        exact = float(np.percentile(vals, q, method="inverted_cdf"))
        approx = h.percentile(q)
        assert exact / growth <= approx <= exact * growth, (
            f"q={q}: approx {approx} vs exact {exact}")
    assert math.isnan(Histogram().percentile(50.0))


def test_histogram_merge_associative_and_geometry_checked():
    rng = np.random.default_rng(9)

    def filled(vals):
        h = Histogram(lo=1.0, hi=64.0, growth=2.0)
        for v in vals:
            h.record(float(v))
        return h

    a_vals, b_vals, c_vals = (rng.uniform(0.5, 80.0, n) for n in (40, 25, 60))
    left = filled(a_vals).merge(filled(b_vals)).merge(filled(c_vals))
    right = filled(a_vals).merge(filled(b_vals).merge(filled(c_vals)))
    swapped = filled(c_vals).merge(filled(a_vals)).merge(filled(b_vals))
    for other in (right, swapped):
        assert np.array_equal(left.counts, other.counts)
        assert left.count == other.count
        assert left.vmin == other.vmin and left.vmax == other.vmax
        assert abs(left.total - other.total) < 1e-6
    with pytest.raises(ValueError, match="geometry"):
        filled(a_vals).merge(Histogram(lo=1.0, hi=128.0, growth=2.0))


def test_registry_publish_idempotent_and_delta():
    reg = MetricsRegistry()
    live = Histogram(lo=1.0, hi=16.0, growth=2.0)
    for v in (1.5, 3.0, 9.0):
        live.record(v)
    reg.publish_histogram("engine.latency_ms.pair", live)
    reg.publish_histogram("engine.latency_ms.pair", live)  # republish
    snap = reg.snapshot()
    h = snap["histograms"]["engine.latency_ms.pair"]
    assert h["count"] == 3 and sum(h["counts"]) == 3  # no double count
    c = reg.counter("engine.batches")
    c.inc(3)
    s0 = reg.snapshot()
    c.inc(2)
    live.record(12.0)
    reg.publish_histogram("engine.latency_ms.pair", live)
    d = reg.delta(s0)
    assert d["counters"]["engine.batches"] == 2
    assert d["histograms"]["engine.latency_ms.pair"]["count"] == 1
    reg.gauge("engine.queue_rows").set(7.0)
    prom = reg.to_prometheus()
    assert "# TYPE engine_batches counter" in prom
    assert "engine_queue_rows 7" in prom
    assert 'engine_latency_ms_pair_bucket{le="+Inf"} 4' in prom
    assert not reg.empty() and MetricsRegistry().empty()


def test_registry_exports_match_the_reference():
    ops = [("counter", "engine.batches", 5), ("gauge", "lifecycle.mae", 0.8),
           ("gauge", "retrieval.recall", float("nan")),
           ("hist", "engine.latency_ms.topn", [0.5, 2.0, 70.0])]
    regs = (MetricsRegistry(), JMetricsRegistry())
    for reg in regs:
        for kind, name, v in ops:
            if kind == "counter":
                reg.counter(name).set(v)
            elif kind == "gauge":
                reg.gauge(name).set(v)
            else:
                for x in v:
                    reg.histogram(name).record(x)
    a, b = (json.dumps(r.snapshot(), sort_keys=True) for r in regs)
    assert a == b
    assert regs[0].to_prometheus() == regs[1].to_prometheus()


# ----------------------------------------------------------------- sampler
def _coins(sampler, n):
    return [sampler.sample() for _ in range(n)]


@pytest.mark.parametrize("rate,seed", [(0.3, 7), (0.3, 8), (0.05, 0),
                                       (0.9, 12345), (1.0, 3), (0.0, 3)])
def test_sampler_coin_sequence_matches_the_reference(rate, seed):
    n = 2000
    got = _coins(Sampler(rate, seed=seed), n)
    assert got == _coins(JSampler(rate, seed=seed), n)
    tr = Tracer(sample_rate=rate, seed=seed)
    assert [tr.should_sample() for _ in range(n)] == got


def test_sampler_seeded_determinism():
    n = 2000
    seq1 = _coins(Sampler(0.3, seed=7), n)
    assert seq1 == _coins(Sampler(0.3, seed=7), n)
    assert 0.25 < sum(seq1) / n < 0.35
    assert _coins(Sampler(0.3, seed=8), n) != seq1
    assert all(Sampler(1.0, seed=0).sample() for _ in range(50))
    assert not any(Sampler(0.0, seed=0).sample() for _ in range(50))


def test_tracer_bounded_buffer_counts_drops():
    tr = Tracer(max_events=5)
    for i in range(8):
        tr.complete(f"s{i}", "bg", 0.0, 1.0)
    assert len(tr.events()) == 5 and tr.dropped == 3
    tr2 = Tracer(max_events=3)
    tr2.complete_many([{"name": f"s{i}", "cat": "bg", "t0": 0.0, "t1": 1.0}
                       for i in range(5)])
    assert len(tr2.events()) == 3 and tr2.dropped == 2
    tr3 = Tracer(max_events=2)
    tr3.complete_requests([("pair", 0.0, 0.5, 1.0, i, 2, 0, 1)
                           for i in range(3)])
    assert len(tr3.events()) == 6 and tr3.dropped == 3  # 3 spans a record


def test_span_contextmanager_and_install():
    o = Observability(sample_rate=1.0, seed=0)
    obslib.install(o)
    try:
        assert obslib.current() is o
        with obslib.span("refresh.fit", cat="lifecycle",
                         args={"rows": 4}) as got:
            assert got is o
        evs = o.tracer.events()
        assert [e["name"] for e in evs] == ["refresh.fit"]
        assert evs[0]["cat"] == "lifecycle" and evs[0]["args"] == {"rows": 4}
        assert evs[0]["t1"] >= evs[0]["t0"]
    finally:
        obslib.uninstall()
    assert obslib.current() is None
    with obslib.span("ignored") as got:  # nothing installed -> no-op
        assert got is None
    assert len(o.tracer.events()) == 1
    with obslib.span("explicit", obs=o):
        pass
    assert [e["name"] for e in o.tracer.events()] == ["refresh.fit",
                                                      "explicit"]


# ------------------------------------------- engine spans under concurrency
def test_span_parent_ordering_under_concurrent_submit(state):
    """Every sampled request exports one root serve[...] span with a unique
    id and exactly two children (queued + exec/apply) citing it, nested in
    the root interval, queued ending where exec begins — under concurrent
    threaded submission."""
    cfg = EngineConfig(max_batch=16, min_shape=4, queue_cap=4096,
                       max_wait_ms=0.5, slo_ms=500.0, fold_bq=8, topn=5)
    o = Observability(sample_rate=1.0, seed=0)
    eng = RequestEngine(_local_backend(state), cfg, obs=o)
    eng.start()
    reqs, lock = [], threading.Lock()

    def client(tseed):
        trng = np.random.default_rng(tseed)
        mine = []
        for _ in range(12):
            m = int(trng.integers(1, 5))
            uu = trng.integers(0, U, m)
            if trng.random() < 0.5:
                r = eng.submit("pair", users=uu, items=trng.integers(0, P, m))
            else:
                r = eng.submit("topn", users=uu)
            assert r is not None and r.done.wait(10.0)
            mine.append(r)
        with lock:
            reqs.extend(mine)

    threads = [threading.Thread(target=client, args=(100 + i,))
               for i in range(4)]
    try:
        for t in threads:
            t.start()
        fr = eng.submit("fold", rows=_ratings(4, P, seed=11))
        for t in threads:
            t.join(timeout=30.0)
            assert not t.is_alive()
        assert fr is not None and fr.done.wait(10.0)
    finally:
        eng.stop()

    evs = o.tracer.events()
    assert o.tracer.dropped == 0
    roots = [e for e in evs if e["name"].startswith("serve[")]
    kids = [e for e in evs if "parent" in e]
    assert len(roots) == len(reqs) + 1  # 48 reads + 1 fold, rate 1.0
    ids = [e["id"] for e in roots]
    assert len(set(ids)) == len(ids)
    by_parent = {}
    for k in kids:
        by_parent.setdefault(k["parent"], []).append(k)
    assert set(by_parent) == set(ids)
    for root in roots:
        children = sorted(by_parent[root["id"]], key=lambda e: e["t0"])
        assert [c["name"] for c in children] in (["queued", "exec"],
                                                 ["queued", "apply"])
        q, x = children
        assert root["t0"] <= q["t0"] <= q["t1"] <= x["t1"] <= root["t1"]
        assert q["t1"] == x["t0"] and root["t0"] == q["t0"]
        assert root["t1"] == x["t1"]
    assert {"engine", "request", "write"} <= {e["cat"] for e in evs}
    execs = [e for e in evs if e["name"].startswith("execute[")]
    assert sum(e["args"]["rows"] for e in execs) == sum(
        r.n_rows for r in reqs)


def test_sampling_rate_bounds_request_spans(state):
    cfg = EngineConfig(max_batch=16, min_shape=4, queue_cap=4096,
                       slo_ms=500.0, topn=5)
    o = Observability(sample_rate=0.25, seed=3)
    eng = RequestEngine(_local_backend(state), cfg, obs=o)
    n = 64
    for i in range(n):
        assert eng.submit("pair", users=[i % U], items=[i % P]) is not None
    eng.pump_reads()
    roots = [e for e in o.tracer.events() if e["name"].startswith("serve[")]
    assert 0 < len(roots) < n
    execs = [e for e in o.tracer.events()
             if e["name"].startswith("execute[")]
    assert sum(e["args"]["rows"] for e in execs) == n


def test_zero_overhead_when_disabled(state):
    """An engine without obs never touches the tracer: DISABLED's tracer
    methods are replaced with raising sentinels, traffic runs, and the
    shared registry stays empty."""
    eng = RequestEngine(_local_backend(state), EngineConfig(
        max_batch=16, min_shape=4, queue_cap=256, slo_ms=500.0, fold_bq=8,
        topn=5))
    tr = obslib.DISABLED.tracer
    assert eng.obs is None and eng._tracer is tr and not tr.active

    def boom(*a, **k):
        raise AssertionError("disabled tracer was invoked on the hot path")

    saved = {m: getattr(tr, m) for m in
             ("complete", "complete_many", "should_sample", "new_id")}
    for m in saved:
        setattr(tr, m, boom)
    try:
        rng = np.random.default_rng(4)
        for _ in range(10):
            m = int(rng.integers(1, 5))
            assert eng.submit("pair", users=rng.integers(0, U, m),
                              items=rng.integers(0, P, m)) is not None
        eng.submit("fold", rows=_ratings(2, P, seed=13))
        eng.pump_reads()
        eng.pump_folds()
        eng.publish_metrics()  # no obs -> no-op
    finally:
        for m, fn in saved.items():
            setattr(tr, m, fn)
    assert len(tr.events()) == 0 and tr.dropped == 0
    assert obslib.DISABLED.registry.empty()
    assert eng.latencies["pair"].count == 10
    assert eng.latencies["fold"].count == 1


def test_engine_latencies_are_bounded_histograms(state):
    eng = RequestEngine(_local_backend(state), EngineConfig(
        max_batch=16, min_shape=4, queue_cap=4096, slo_ms=500.0, topn=5))
    h = eng.latencies["pair"]
    assert isinstance(h, Histogram)
    nbytes0 = h.counts.nbytes + len(h.edges)
    for i in range(300):
        assert eng.submit("pair", users=[i % U], items=[i % P]) is not None
        if i % 37 == 0:
            eng.pump_reads()
    eng.pump_reads()
    assert h.count == 300
    assert h.counts.nbytes + len(h.edges) == nbytes0  # fixed memory
    st = eng.stats()
    assert st["read_latency"].count == 300
    assert st["read_latency"].p99_ms >= st["read_latency"].p50_ms


def test_per_kind_shed_counters_and_queue_gauges(state):
    cfg = EngineConfig(max_batch=8, min_shape=4, queue_cap=8, slo_ms=500.0,
                       fold_queue_cap=2, fold_bq=8, topn=5)
    o = Observability(sample_rate=0.0, seed=0)
    eng = RequestEngine(_local_backend(state), cfg, obs=o)
    assert eng.submit("pair", users=[0] * 4, items=[0] * 4) is not None
    assert eng.submit("pair", users=[1] * 4, items=[1] * 4) is not None
    assert eng.submit("pair", users=[2] * 4, items=[2] * 4) is None  # shed
    assert eng.submit("topn", users=[3]) is None                     # shed
    for _ in range(2):
        assert eng.submit("fold", rows=_ratings(1, P, seed=21)) is not None
    assert eng.submit("fold", rows=_ratings(1, P, seed=22)) is None  # shed
    st = eng.stats()
    assert st["shed"] == {"pair": 1, "topn": 1, "fold": 1,
                          "update": 0, "remove": 0}
    assert st["shed_frac_by_kind"]["pair"] == pytest.approx(1 / 3)
    assert st["shed_frac_by_kind"]["topn"] == pytest.approx(1.0)
    assert st["shed_frac_by_kind"]["fold"] == pytest.approx(1 / 3)
    assert st["queue_rows"] == 8 and st["write_queue"] == 2
    eng.publish_metrics()
    snap = o.registry.snapshot()
    assert snap["counters"]["engine.shed.pair"] == 1
    assert snap["counters"]["engine.shed.fold"] == 1
    assert snap["gauges"]["engine.queue_rows"] == 8.0
    assert snap["gauges"]["engine.write_queue"] == 2.0
    eng.pump_reads()
    eng.pump_folds()
    eng.publish_metrics()
    snap = o.registry.snapshot()
    assert snap["gauges"]["engine.queue_rows"] == 0.0
    assert snap["gauges"]["engine.write_queue"] == 0.0
    assert 0.0 < snap["gauges"]["engine.row_occupancy"] <= 1.0
    assert snap["counters"]["exec.engine.pair.b8.launches"] == 1
    eng.publish_metrics()  # idempotent: absolute copies, not re-added
    assert o.registry.snapshot()["counters"]["engine.shed.pair"] == 1


# ------------------------------------------- publishers against the reference
@pytest.mark.parametrize("fields", [
    dict(mae=0.81, rmse=1.02, holdout_count=37, foldin_frac=0.25,
         coverage=0.4, coverage_ratio=0.9),
    dict(mae=float("nan"), rmse=float("nan"), holdout_count=0,
         foldin_frac=0.0, coverage=0.5, coverage_ratio=1.0, shard_skew=1.7,
         tombstone_frac=0.02)])
def test_publish_snapshot_matches_the_reference(fields):
    assert ([f.name for f in dataclasses.fields(Snapshot)]
            == [f.name for f in dataclasses.fields(JSnapshot)])
    got, want = MetricsRegistry(), JMetricsRegistry()
    publish_snapshot(got, Snapshot(**fields))
    j_publish_snapshot(want, JSnapshot(**fields))
    g, w = got.snapshot(), want.snapshot()
    assert sorted(g["gauges"]) == sorted(w["gauges"]) and g["gauges"]
    for name, v in w["gauges"].items():
        assert (g["gauges"][name] == v
                or (math.isnan(v) and math.isnan(g["gauges"][name])))
    publish_snapshot(got, Snapshot(**fields), prefix="drift")
    assert "drift.mae" in got.snapshot()["gauges"]


@pytest.mark.parametrize("kw", [
    dict(), dict(nprobe=19, clusters=77, probed_per_q=8.5, recall=0.97,
                 early_exit=True, escalations=2, probes=5),
    dict(nprobe=4, clusters=16, recall=float("nan"), early_exit=False,
         probes=0)])
def test_publish_retrieval_matches_the_reference(kw):
    got, want = MetricsRegistry(), JMetricsRegistry()
    publish_retrieval(got, **kw)
    j_publish_retrieval(want, **kw)
    a, b = (json.dumps(obslib._sanitize(r.snapshot()), sort_keys=True)
            for r in (got, want))
    assert a == b
    assert got.snapshot()["gauges"]["retrieval.exact"] == (
        0.0 if kw.get("clusters") else 1.0)


# ------------------------------------------------------- profiling hooks
def test_count_launch_and_compile_counts():
    reg = MetricsRegistry()
    obslib.count_launch(reg, "engine.pair", 12)
    obslib.count_launch(reg, "engine.pair", 4)
    c = reg.snapshot()["counters"]
    assert c["exec.engine.pair.launches"] == 2
    assert c["exec.engine.pair.rows"] == 16
    buckets.reset_geometries()
    buckets.record_geometry("pair", 256, 8)
    base = buckets.geometry_counts()
    buckets.record_geometry("pair", 256, 16)
    buckets.record_geometry("pair", 256, 16)
    buckets.record_geometry("fold", 512, 32)
    obslib.publish_compile_counts(reg, base)
    g = reg.snapshot()["gauges"]
    assert g["exec.pair.compiles"] == 1.0 and g["exec.fold.compiles"] == 1.0
    obslib.publish_compile_counts(reg)
    assert reg.snapshot()["gauges"]["exec.pair.compiles"] == 2.0
    buckets.reset_geometries()


def test_profile_trace_exports_a_chrome_trace(tmp_path):
    with obslib.profile_trace(None) as prof:
        assert prof is None
    import torch

    with obslib.profile_trace(str(tmp_path / "p")) as prof:
        assert prof is not None
        torch.ones(8) @ torch.ones(8)
    doc = json.loads((tmp_path / "p" / "torch_trace.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "aten::matmul" in names or "aten::dot" in names


def test_profile_trace_on_the_cpu_opens_with_no_markers(tmp_path):
    """Without a card the session traces the CPU alone and launches no
    spin kernel: the trace holds none of the markers."""
    import torch

    assert not torch.cuda.is_available()
    with obslib.profile_trace(str(tmp_path / "p")):
        torch.ones(8) @ torch.ones(8)
    doc = json.loads((tmp_path / "p" / "torch_trace.json").read_text())
    assert not any(obslib.profile.MARKER in str(e.get("name"))
                   for e in doc["traceEvents"])


@pytest.mark.parametrize("seen", [256, 200, 1, 0])
def test_strip_markers_counts_the_markers_lost(seen):
    """A session's records less its markers, and the markers lost; None
    when every marker was lost (the run's first records may be too)."""
    from repro_torch.obs import profile

    run = [{"name": f"void kernel_{i}<64>(float*)"} for i in range(5)]
    marks = [{"name": f"{profile.MARKER}(long)"}] * seen
    kept, lost = obslib.strip_markers(marks + run, lambda e: e["name"])
    assert lost == profile.PROFILE_MARKERS - seen
    assert kept == (run if seen else None)


# ------------------------------------------------------- export + validator
def test_exports_satisfy_ci_schema_checker(state, tmp_path,
                                           folds_overlap_reads):
    """Traffic, all three series groups, export, and the reference's checker
    with the read/fold-overlap requirement. Four readers keep reads queued
    through every fold, and each fold stays open until a read has run
    inside it (``folds_overlap_reads``)."""
    cfg = EngineConfig(max_batch=16, min_shape=4, queue_cap=4096,
                       max_wait_ms=0.5, slo_ms=500.0, fold_bq=8, topn=5)
    o = Observability(sample_rate=1.0, seed=0)
    eng = RequestEngine(_local_backend(state), cfg, obs=o)
    eng.start()
    stop = threading.Event()

    def read_load(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            r = eng.submit("pair", users=rng.integers(0, U, 4),
                           items=rng.integers(0, P, 4))
            if r is not None:
                r.done.wait(5.0)

    readers = [threading.Thread(target=read_load, args=(6 + i,))
               for i in range(4)]
    for t in readers:
        t.start()
    try:
        for i in range(3):
            fr = eng.submit("fold", rows=_ratings(6, P, seed=30 + i))
            assert fr is not None and fr.done.wait(HOLD_S + 10.0)
    finally:
        stop.set()
        for t in readers:
            t.join(timeout=30.0)
        eng.stop()
    assert not any(t.is_alive() for t in readers)
    assert folds_overlap_reads == []
    eng.publish_metrics()
    publish_retrieval(o.registry)
    o.registry.gauge("lifecycle.mae").set(float("nan"))
    o.registry.counter("lifecycle.holdout_count").set(12)
    tpath = o.export_trace(str(tmp_path))
    mpath = o.export_metrics(str(tmp_path / "metrics.json"))
    doc = check_obs.check_trace(tpath, require_overlap=True)
    check_obs.check_metrics(mpath)
    strict = json.loads((tmp_path / "metrics.json").read_text(),
                        parse_constant=lambda s: pytest.fail(f"non-strict {s}"))
    assert strict["gauges"]["lifecycle.mae"] is None  # NaN exports as null
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert "execute[pair]" in names and "apply[fold]" in names


def test_engine_cli_exports_pass_the_checker(capsys, tmp_path,
                                             folds_overlap_reads):
    """``serve --engine --smoke --device cpu`` with the obs flags: its trace
    and metrics pass ``check_obs`` with ``require_overlap``; the profiler
    hook writes its Chrome trace. A fixed 500 requests/s, as in
    ``test_torch_engine.py``'s CLI tests; each fold stays open until a
    read has run inside it (``folds_overlap_reads``), so at least one
    fold of the window meets a read."""
    t, m, p = tmp_path / "t", tmp_path / "m.json", tmp_path / "p"
    serve.main(["--workload", "cf", "--engine", "--smoke", "--device", "cpu",
                "--duration", "2", "--rate", "500", "--trace-dir", str(t),
                "--metrics-json",
                str(m), "--sample-rate", "0.5", "--torch-profile", str(p)])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("cf engine: done")
    assert obslib.current() is None  # uninstalled after the export
    check_obs.check_trace(str(t / "trace.json"), require_overlap=True)
    doc = check_obs.check_metrics(str(m))
    assert doc["gauges"]["retrieval.exact"] == 1.0
    assert doc["gauges"]["lifecycle.holdout_count"] > 0
    assert doc["counters"]["engine.completed.fold"] >= 1
    assert (p / "torch_trace.json").stat().st_size > 0


def test_lifecycle_cli_exports(capsys, tmp_path):
    """The obs flags on ``--lifecycle --retrieval ivf``: a strict-JSON
    metrics file with lifecycle and retrieval series, and a trace holding
    the background refresh's spans."""
    t, m = tmp_path / "t", tmp_path / "m.json"
    serve.main(["--workload", "cf", "--lifecycle", "--smoke", "--retrieval",
                "ivf", "--device", "cpu", "--trace-dir", str(t),
                "--metrics-json", str(m)])
    assert capsys.readouterr().out.rstrip().endswith("cf lifecycle: done")
    doc = check_obs.check_metrics(str(m), groups=("retrieval.",
                                                  "lifecycle."))
    json.loads(m.read_text(),
               parse_constant=lambda s: pytest.fail(f"non-strict {s}"))
    assert doc["counters"]["lifecycle.refreshes"] >= 1
    assert doc["gauges"]["retrieval.clusters"] > 0
    assert doc["gauges"]["exec.fold.compiles"] >= 1
    trace = json.loads((t / "trace.json").read_text())
    names = {e["name"] for e in trace["traceEvents"] if e.get("ph") == "X"}
    assert {"refresh.fit", "refresh.commit",
            "refresh.ivf_rebuild"} <= names
