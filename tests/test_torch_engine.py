"""The port's request engine (``repro_torch.serving``) on the CPU: the
single-device cases of ``tests/test_serving_engine.py`` against the port,
parity with the reference engine on the same scripted traffic, and the
``serve --engine`` CLI end to end.

Tolerances (``ROADMAP.md``'s parity rule):
- the port's engine against itself (micro-batched against solo): bitwise;
- against the reference engine: pair predictions within rtol=1e-5,
  atol=1e-6; top-N lists within that tolerance, ids equal except where
  the reference's scores tie within it at the cut
  (``core.topk.list_mismatches``); generations, batch counts, pad rows,
  shed counts and the per-(kind, shape) launch counts equal exactly.

Every wait on a thread has a timeout.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.lifecycle import buckets as jbuckets
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import LocalBackend as JLocalBackend
from repro.serving import RequestEngine as JRequestEngine
import repro_torch.core as T
from repro_torch.core.convert import landmark_state_from_numpy
from repro_torch.core.topk import list_mismatches
from repro_torch.launch import serve
from repro_torch.lifecycle import buckets
from repro_torch.serving import (EngineConfig, LocalBackend, RequestEngine,
                                 histogram_latency, latency_stats)
from repro_torch.serving import engine as engine_mod
from repro_torch.obs import Histogram

RTOL, ATOL = 1e-5, 1e-6
SPEC = T.LandmarkSpec(n_landmarks=8, selection="popularity", k_neighbors=5)
JSPEC = J.LandmarkSpec(n_landmarks=8, selection="popularity", k_neighbors=5)
U, P = 64, 24
CFG = EngineConfig(max_batch=16, min_shape=4, queue_cap=64, max_wait_ms=1.0,
                   slo_ms=250.0, fold_bq=8, topn=5)


def _ratings(u, p, density=0.35, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    r *= rng.random((u, p)) < density
    return r


@pytest.fixture(scope="module")
def fitted():
    """The reference's fit of a (64, 24) block, carried into the port."""
    r = _ratings(U, P, seed=3)
    jst = J.fit(jax.random.PRNGKey(0), J.RatingMatrix(jnp.asarray(r), U, P),
                JSPEC)
    st = landmark_state_from_numpy({
        "landmark_idx": np.asarray(jst.landmark_idx),
        "representation": np.asarray(jst.representation),
        "ratings": np.asarray(jst.ratings),
        "graph.indices": np.asarray(jst.graph.indices),
        "graph.weights": np.asarray(jst.graph.weights)}, device="cpu")
    return jst, st


@pytest.fixture
def state(fitted):
    return fitted[1]


def _local_backend(state, **kw):
    return LocalBackend(buckets.from_state(state, min_bucket=U), SPEC,
                        min_bucket=U, **kw)


def _solo(backend, pub, req, cfg):
    """Replay one request alone, padded exactly as the engine pads it."""
    m = req.n_rows
    u = np.zeros(cfg.pad_shape(m), np.int64)
    u[:m] = req.users
    if req.kind == "pair":
        it = np.zeros_like(u)
        it[:m] = req.items
        return backend.predict_pairs(pub, u, it)[:m]
    ti, ts = backend.recommend_topn(pub, u, cfg.topn)
    return ti[:m], ts[:m]


# ------------------------------------------------------------ stats helper
def test_latency_stats_empty_and_known():
    empty = latency_stats([])
    assert empty.count == 0 and "--" in empty.brief()
    s = latency_stats([0.001] * 99 + [0.101])
    assert s.count == 100
    assert abs(s.p50_ms - 1.0) < 1e-6
    assert s.p99_ms > s.p95_ms >= s.p50_ms
    assert "p95=" in s.brief()


def test_histogram_latency_view():
    assert histogram_latency(Histogram()).count == 0
    h = Histogram()
    for v in (1.0, 2.0, 3.0, 100.0):
        h.record(v)
    s = histogram_latency(h)
    assert s.count == 4
    assert s.p50_ms == h.percentile(50) and s.p99_ms == h.percentile(99)
    assert s.p99_ms == 100.0  # clamped to the observed max


@pytest.mark.parametrize("kw", [
    dict(max_batch=16, min_shape=4), dict(max_batch=128, min_shape=32),
    dict(max_batch=100, min_shape=8), dict(max_batch=1, min_shape=1)])
def test_engine_config_shapes(kw):
    cfg, ref = EngineConfig(**kw), JEngineConfig(**kw)
    assert cfg.batch_shapes() == ref.batch_shapes()
    for rows in range(1, kw["max_batch"] + 1):
        assert cfg.pad_shape(rows) == ref.pad_shape(rows)
    assert CFG.batch_shapes() == (4, 8, 16)
    assert CFG.pad_shape(1) == 4 and CFG.pad_shape(5) == 8
    assert CFG.pad_shape(16) == 16


# -------------------------------------------- micro-batching bit-identity
def test_micro_batched_results_bitwise_vs_solo(state):
    """Random mixed interleavings through the batch former give results
    bitwise equal to padded per-request execution."""
    backend = _local_backend(state)
    cfg = EngineConfig(max_batch=16, min_shape=4, queue_cap=512,
                       slo_ms=250.0, topn=5)
    eng = RequestEngine(backend, cfg)
    rng = np.random.default_rng(11)
    reqs = []
    for _ in range(24):
        m = int(rng.integers(1, 9))
        uu = rng.integers(0, U, m)
        if rng.random() < 0.3:
            reqs.append(eng.submit("topn", users=uu))
        else:
            reqs.append(eng.submit("pair", users=uu,
                                   items=rng.integers(0, P, m)))
        if rng.random() < 0.3:  # interleave draining with arrivals
            eng.pump_reads(max_batches=1)
    assert all(r is not None for r in reqs)
    eng.pump_reads()
    pub = backend.snapshot()
    assert len({r.seq for r in reqs}) == 24
    assert all(r.done.is_set() for r in reqs)
    for r in reqs:
        ref = _solo(backend, pub, r, cfg)
        if r.kind == "pair":
            assert np.array_equal(r.result, ref)
        else:
            assert np.array_equal(r.result[0], ref[0])
            assert np.array_equal(r.result[1], ref[1])
    checked, bad = eng.verify_sample(limit=24)
    assert checked > 0 and bad == 0


@pytest.mark.parametrize("shape", CFG.batch_shapes())
def test_reads_bitwise_at_every_padded_shape(state, shape):
    """A request's rows are the same bits wherever they sit in a batch of
    any padded shape as when the request runs alone at its own shape: the
    k sums of Eq. (1) run in an order fixed by k alone."""
    backend = _local_backend(state)
    pub = backend.snapshot()
    rng = np.random.default_rng(shape)
    for m in sorted({1, 3, shape}):
        uu = rng.integers(0, U, m)
        it = rng.integers(0, P, m)
        solo_u = np.zeros(CFG.pad_shape(m), np.int64)
        solo_u[:m] = uu
        solo_i = np.zeros_like(solo_u)
        solo_i[:m] = it
        want_p = backend.predict_pairs(pub, solo_u, solo_i)[:m]
        want_i, want_s = backend.recommend_topn(pub, solo_u, CFG.topn)
        for off in sorted({0, shape - m}):
            bu = rng.integers(0, U, shape)  # other rows around the request
            bi = rng.integers(0, P, shape)
            bu[off:off + m], bi[off:off + m] = uu, it
            got_p = backend.predict_pairs(pub, bu, bi)[off:off + m]
            got_i, got_s = backend.recommend_topn(pub, bu, CFG.topn)
            assert np.array_equal(got_p, want_p)
            assert np.array_equal(got_i[off:off + m], want_i[:m])
            assert np.array_equal(got_s[off:off + m], want_s[:m])


def test_batch_former_kind_skip_and_per_kind_deadline_order(state):
    """A same-kind batch skips over other-kind entries without reordering
    either kind; the skipped kind forms the next batch."""
    eng = RequestEngine(_local_backend(state), CFG)
    p1 = eng.submit("pair", users=[1, 2, 3], items=[0, 1, 2])
    t1 = eng.submit("topn", users=[4, 5])
    p2 = eng.submit("pair", users=[6, 7], items=[3, 4])
    assert eng.pump_reads(max_batches=1) == 1
    assert p1.done.is_set() and p2.done.is_set() and not t1.done.is_set()
    assert eng.pump_reads(max_batches=1) == 1
    assert t1.done.is_set()


def test_deadline_ordering_across_batches(state):
    eng = RequestEngine(_local_backend(state), CFG)
    # max_batch rows each: one request per batch, so execution order is
    # exactly deadline order regardless of submission order
    rows = CFG.max_batch
    z = np.zeros(rows, int)
    late = eng.submit("pair", users=z, items=z, deadline_ms=300.0)
    early = eng.submit("pair", users=z, items=z, deadline_ms=50.0)
    mid = eng.submit("pair", users=z, items=z, deadline_ms=150.0)
    assert eng.pump_reads(max_batches=1) == 1
    assert early.done.is_set() and not mid.done.is_set()
    assert eng.pump_reads(max_batches=1) == 1
    assert mid.done.is_set() and not late.done.is_set()
    eng.pump_reads()
    assert late.done.is_set()


# ---------------------------------------------------------------- admission
def test_admission_sheds_on_overflow(state):
    eng = RequestEngine(_local_backend(state), CFG)
    admitted, shed = [], 0
    for _ in range(20):  # 20 x 8 rows > queue_cap=64
        r = eng.submit("pair", users=np.zeros(8, int), items=np.zeros(8, int))
        if r is None:
            shed += 1
        else:
            admitted.append(r)
    assert sum(r.n_rows for r in admitted) <= CFG.queue_cap
    assert shed > 0 and eng.stats()["shed"]["pair"] == shed
    eng.pump_reads()  # every admitted request still completes
    assert all(r.done.is_set() for r in admitted)
    assert eng.stats()["shed_frac"] == pytest.approx(shed / 20)


def test_oversized_request_rejected(state):
    eng = RequestEngine(_local_backend(state), CFG)
    with pytest.raises(ValueError, match="max_batch"):
        eng.submit("pair", users=np.zeros(CFG.max_batch + 1, int),
                   items=np.zeros(CFG.max_batch + 1, int))


@pytest.mark.parametrize("kind", engine_mod.MUTATION_KINDS)
def test_mutations_need_a_mutable_backend(state, fitted, kind):
    """``update``/``remove`` are refused as the reference refuses them for a
    backend without a write path; nothing is queued."""
    eng = RequestEngine(_local_backend(state), CFG)
    with pytest.raises(ValueError, match="needs a mutable backend") as got:
        eng.submit(kind, users=[0], rows=np.zeros((1, P), np.float32))
    jeng = JRequestEngine(JLocalBackend(
        jbuckets.from_state(fitted[0], min_bucket=U), JSPEC, min_bucket=U),
        JEngineConfig(max_batch=16, min_shape=4, queue_cap=64))
    with pytest.raises(ValueError) as want:
        jeng.submit(kind, users=[0], rows=np.zeros((1, P), np.float32))
    assert str(got.value) == str(want.value)
    assert eng.stats()["offered"] == 0
    with pytest.raises(ValueError, match="unknown request kind"):
        eng.submit("scan", users=[0])


# ---------------------------------------------------------------- fold lane
def test_fold_swaps_generation_and_new_users_serve(state):
    backend = _local_backend(state)
    eng = RequestEngine(backend, CFG)
    assert backend.generation == 0 and backend.n_users == U
    eng.submit("fold", rows=_ratings(8, P, seed=9))
    assert eng.pump_folds() == 1
    assert backend.generation == 1 and backend.n_users == U + 8
    r = eng.submit("pair", users=np.arange(U, U + 8), items=np.zeros(8, int))
    eng.pump_reads()
    assert r.done.is_set() and np.isfinite(r.result).all()
    assert r.generation == 1
    assert eng.stats()["folded_rows"] == 8


def test_fold_never_writes_the_published_generation(state):
    """The fold lane folds into a clone of every tensor: the generation a
    read holds keeps its bits through a fold that regrows the bucket and
    one into the same bucket (written in place in the clone)."""
    backend = _local_backend(state)
    caps = []
    for seed in (20, 21):
        pub = backend.snapshot()
        before = [t.clone() for t in engine_mod._tensors(pub[0])]
        backend.fold_in(_ratings(3, P, seed=seed), 8)
        caps.append(backend.snapshot()[0].capacity)
        for a, b in zip(before, engine_mod._tensors(pub[0])):
            assert torch.equal(a, b)
    assert backend.generation == 2 and backend.n_users == U + 6
    assert caps == [2 * U, 2 * U]  # the first regrew, the second did not
    assert backend.caps_used == {U, 2 * U}


def test_verify_ring_cleared_on_fold(state):
    backend = _local_backend(state)
    eng = RequestEngine(backend, CFG)
    eng.submit("pair", users=[0, 1], items=[0, 1])
    eng.pump_reads()
    eng.submit("fold", rows=_ratings(8, P, seed=10))
    eng.pump_folds()
    checked, bad = eng.verify_sample()  # stale-generation entries retired
    assert checked == 0 and bad == 0
    eng.submit("pair", users=[2, 3], items=[2, 3])
    eng.pump_reads()
    checked, bad = eng.verify_sample()
    assert checked == 1 and bad == 0


def test_fold_lane_never_blocks_reads(state):
    """A slow in-flight fold must not delay read batches (one device:
    serialize_folds is False, the lanes overlap)."""

    class SlowFold(LocalBackend):
        def fold_in(self, rows, bq):
            time.sleep(0.5)
            return super().fold_in(rows, bq)

    backend = SlowFold(buckets.from_state(state, min_bucket=U), SPEC,
                       min_bucket=U)
    assert not backend.serialize_folds
    eng = RequestEngine(backend, CFG)
    eng.submit("pair", users=[0], items=[0])
    eng.pump_reads()
    eng.start()
    try:
        assert set(eng.lane_ids) == {"engine-reads", "engine-folds"}
        fold = eng.submit("fold", rows=_ratings(8, P, seed=12))
        time.sleep(0.1)  # let the fold thread enter the slow fold
        r = eng.submit("pair", users=[1, 2], items=[1, 2])
        assert r.done.wait(timeout=0.35), "read stalled behind the fold"
        assert not fold.done.is_set(), "fold finished too fast to prove overlap"
        assert fold.done.wait(timeout=30.0)
    finally:
        eng.stop()
    assert backend.generation == 1


def test_serialized_backend_holds_exec_lock_across_folds(state):
    """A backend that sets ``serialize_folds`` gets its folds launched under
    ``exec_lock``, as read batches are."""
    backend = _local_backend(state)
    backend.serialize_folds = True
    eng = RequestEngine(backend, CFG)
    witnessed = []
    orig = backend.fold_in

    def locked_probe(rows, bq):
        witnessed.append(eng.exec_lock.locked())
        return orig(rows, bq)

    backend.fold_in = locked_probe
    eng.submit("fold", rows=_ratings(8, P, seed=13))
    eng.pump_folds()
    assert witnessed == [True]


def test_threaded_engine_concurrent_reads_and_folds(state):
    """Four client threads and two folds through the threaded engine: every
    admitted request completes against some generation, and the live
    generation's sample re-runs bitwise."""
    backend = _local_backend(state)
    cfg = EngineConfig(max_batch=16, min_shape=4, queue_cap=4096,
                       max_wait_ms=0.5, slo_ms=500.0, fold_bq=8, topn=5)
    eng = RequestEngine(backend, cfg)
    eng.start()
    done, lock = [], threading.Lock()

    def client(seed):
        rng = np.random.default_rng(seed)
        mine = []
        for _ in range(15):
            m = int(rng.integers(1, 6))
            uu = rng.integers(0, U, m)
            r = (eng.submit("topn", users=uu) if rng.random() < 0.3 else
                 eng.submit("pair", users=uu, items=rng.integers(0, P, m)))
            assert r is not None and r.done.wait(10.0)
            mine.append(r)
        with lock:
            done.extend(mine)

    threads = [threading.Thread(target=client, args=(40 + i,))
               for i in range(4)]
    try:
        for t in threads:
            t.start()
        folds = [eng.submit("fold", rows=_ratings(4, P, seed=50 + i))
                 for i in range(2)]
        for t in threads:
            t.join(timeout=30.0)
            assert not t.is_alive()
        assert all(f.done.wait(10.0) for f in folds)
    finally:
        eng.stop()
    assert len(done) == 60
    assert {r.generation for r in done} <= {0, 1, 2}
    assert all(np.isfinite(r.result).all() for r in done if r.kind == "pair")
    assert backend.generation == 2
    eng.submit("pair", users=np.arange(U, U + 8), items=np.zeros(8, int))
    eng.pump_reads()
    checked, bad = eng.verify_sample()
    assert checked >= 1 and bad == 0


# ---------------------------------------------- parity with the reference
def _script(eng, kinds_rng):
    """A scripted run: submits (pair/top-N of 1-7 rows, folds, an explicit
    deadline on some), ``pump_reads`` of one or all batches and
    ``pump_folds``, in one fixed order. Returns the requests (None where
    shed), in submit order."""
    rng = np.random.default_rng(kinds_rng)
    reqs = []
    for step in range(40):
        roll = rng.random()
        if roll < 0.08 and step:
            reqs.append(eng.submit("fold", rows=_ratings(
                int(rng.integers(1, 9)), P, seed=100 + step)))
        else:
            m = int(rng.integers(1, 8))
            users = rng.integers(0, eng.backend.n_users, m)
            dl = float(rng.choice([50.0, 150.0, 250.0]))
            if roll < 0.35:
                reqs.append(eng.submit("topn", users=users, deadline_ms=dl))
            else:
                reqs.append(eng.submit("pair", users=users,
                                       items=rng.integers(0, P, m),
                                       deadline_ms=dl))
        pump = rng.random()
        if pump < 0.25:
            eng.pump_reads(max_batches=1)
        elif pump < 0.35:
            eng.pump_reads()
        if rng.random() < 0.15:
            eng.pump_folds()
    eng.pump_folds()
    eng.pump_reads()
    return reqs


def test_engine_parity_with_the_reference_engine(fitted):
    """The same scripted traffic through the reference's
    ``RequestEngine(LocalBackend)`` (JAX on the CPU) and the port's (torch
    on the CPU), from one fitted state, on a frozen clock so deadline order
    is the same in both: equal admission, batching, generations and
    counters; predictions and top-N lists under the parity rule."""
    jst, st = fitted
    kw = dict(max_batch=16, min_shape=4, queue_cap=40, slo_ms=250.0,
              fold_bq=8, topn=5)
    jeng = JRequestEngine(
        JLocalBackend(jbuckets.from_state(jst, min_bucket=U), JSPEC,
                      min_bucket=U, warm_shapes=(4, 8, 16), warm_topn=5),
        JEngineConfig(**kw), clock=lambda: 0.0)
    eng = RequestEngine(
        LocalBackend(buckets.from_state(st, min_bucket=U), SPEC, min_bucket=U,
                     warm_shapes=(4, 8, 16), warm_topn=5),
        EngineConfig(**kw), clock=lambda: 0.0)
    want, got = _script(jeng, 7), _script(eng, 7)
    assert len(want) == len(got) == 40
    shed = 0
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if g is None:
            shed += 1
            continue
        assert g.kind == w.kind and g.seq == w.seq
        assert g.done.is_set() and w.done.is_set()
        assert g.generation == w.generation
        if g.kind == "pair":
            np.testing.assert_allclose(g.result, np.asarray(w.result),
                                       rtol=RTOL, atol=ATOL)
        elif g.kind == "topn":
            bad = list_mismatches(np.asarray(w.result[1]),
                                  np.asarray(w.result[0]), g.result[1],
                                  g.result[0], RTOL, ATOL)
            assert bad.size == 0, f"top-N rows beyond the tie rule: {bad}"
        else:
            assert g.result == w.result
    assert shed > 0  # the script overflows the 40-row queue
    js, ps = jeng.stats(), eng.stats()
    for key in ("batches", "generation", "reads_completed", "folded_rows",
                "offered", "nonfinite"):
        assert ps[key] == js[key], key
    for key in ("submitted", "completed", "shed"):
        assert ps[key] == {k: js[key][k] for k in ps[key]}, key
        assert not any(js[key][k] for k in js[key] if k not in ps[key])
    assert eng.pad_rows == jeng.pad_rows and eng.exec_rows == jeng.exec_rows
    assert eng.launches == jeng.launches
    assert eng.backend.caps_used == jeng.backend.caps_used
    assert eng.backend.n_users == jeng.backend.n_users
    assert eng.verify_sample(limit=64)[1] == 0


# ----------------------------------------------------------------- the CLI
@pytest.mark.parametrize("extra", [[], ["--retrieval", "ivf",
                                        "--early-exit"]])
def test_engine_cli_smoke_on_cpu(capsys, extra):
    """The CLI end to end on the CPU, at a fixed 500 requests/s: the auto
    rate (twice the closed-loop capacity) overloads the engine by design,
    and on a CPU shared with other test workers that overload's queueing
    delay, not the engine, would decide the smoke's p95 SLO."""
    out = serve.main(["--workload", "cf", "--engine", "--smoke", "--device",
                      "cpu", "--duration", "2", "--rate", "500"] + extra)
    text = capsys.readouterr().out
    assert text.rstrip().endswith("cf engine: done")
    assert " 0 mismatches | non-finite predictions: 0" in text
    assert out["mismatches"] == 0 and out["checked"] > 0
    assert out["completed"]["fold"] >= 1 and out["qps"] > 0
    assert max(out["geometries"].values()) <= out["geometry_budget"]
    assert set(out["lane_ids"]) == {"engine-reads", "engine-folds"}
    if extra:
        assert "ivf under load: " in text and out["recalls"]


def test_engine_cli_asks_for_the_card_by_default():
    """Without ``--device cpu`` the engine serves on the card; here there is
    none, so it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        serve.main(["--workload", "cf", "--engine", "--smoke",
                    "--duration", "1"])


@pytest.mark.parametrize("flag,slice_", [(["--mutations"], "mutation"),
                                         (["--mesh", "data=2"], "multi-GPU")])
def test_engine_cli_refuses_what_later_slices_bring(flag, slice_):
    """``--mesh`` runs the multi-GPU paths (the lifecycle replay or the
    engine, tests/test_torch_engine_mesh.py): alone it is refused.
    ``--mutations`` rides the engine's write lane: without ``--engine`` it
    is refused with the reference's message."""
    with pytest.raises(SystemExit, match=slice_) as got:
        serve.main(["--workload", "cf", "--smoke", "--device", "cpu"]
                   + flag)
    if slice_ == "mutation":
        from repro.launch import serve as jserve

        with pytest.raises(SystemExit) as want:
            jserve.main(["--workload", "cf", "--smoke"] + flag)
        assert str(got.value) == str(want.value)
