"""Serving launcher — mode-dispatched on ``--workload``, on one device.

- ``lm`` (default): prefill a batch of prompts, then decode with the exact
  KV cache or, with ``--landmark``, through O(n) landmark summaries.
  ``python -m repro_torch.launch.serve --arch smollm-360m --smoke --tokens 16``
  As in the reference, ``--landmark`` decodes from an empty landmark cache
  with random landmark keys and queries (seeds 1 and 2): the prompt's
  prefill cache is not folded in.
- ``cf``: loads a fitted ``LandmarkState`` artifact from ``--ckpt``
  (fitting and checkpointing one first when the directory holds none),
  then runs waves of Eq. (1) pair predictions and top-N recommendations,
  folding a batch of new users into the state between waves
  (``core.fold_in``: no refit). ``--workload cf [--smoke]``;
  ``--compact`` stores the artifact as uint16 ids + bf16 weights (half the
  bytes), widened after loading.
- ``cf --lifecycle``: the continual-serving loop — a drifting arrival stream
  (``data.synthetic.drifting_ratings``) through bucket-padded state
  (``lifecycle.buckets``), drift monitoring (holdout-MAE reservoir, fold-in
  volume, landmark coverage) and a policy-triggered background refresh
  with a generation-stamped artifact swap. ``--compact-serving`` serves
  (and checkpoints) the uint16/bf16 graph after each swap while the
  capacity fits uint16 (and the IVF index's uint16 posting lists under
  ``--retrieval ivf``); the next fold-in or growth widens it.
- ``cf --lifecycle --retrieval ivf``: the same loop with an IVF index over the
  landmark embedding: fold-in appends arrivals under the frozen quantizer,
  the refresh rebuilds it inside the swap, a list-skew gate repacks it,
  and every wave reports recall@k of the serving-nprobe search against the
  exact (full-probe) search, escalating nprobe to hold a 0.95 SLO;
  ``--early-exit`` adds per-query adaptive probing.
- ``cf --engine``: open-loop serving through the request engine
  (``serving.engine``): a load generator drives mixed pair/top-N/fold
  traffic at ``--rate`` for ``--duration`` seconds through continuous
  micro-batching, bounded admission and the async fold lane (its own CUDA
  stream on the card), and reports sustained QPS, p50/p95/p99 under load,
  the shed fraction and a bitwise-vs-solo audit; ``--retrieval ivf``
  probes IVF recall while the engine is under load.
- ``cf --engine --mutations``: the same server with the write path open
  (``serving.MutableLocalBackend``): waves of re-rate, un-rate and delete
  events (``data.synthetic.mutation_events``) ride the write lane beside
  the folds, each publish drains its repairs, an engine-fed drift monitor
  accumulates holdout, fold-in volume and tombstone stats from the live
  traffic, and after the window the lifecycle policy's verdict can fire a
  tombstone-compacting refresh.

``--trace-dir`` and ``--metrics-json`` export the engine's, the
lifecycle's and the retrieval sidecar's spans and series (``obs``), on the
``--engine`` and ``--lifecycle`` paths; ``--torch-profile DIR`` captures a
``torch.profiler`` trace of the engine's load window.

Everything runs on the card unless ``--device cpu`` is given; asking for
``cuda`` on a machine without one raises. TF32 is switched off for matmuls
and cuDNN at start: the reference scores in full f32
(``Precision.HIGHEST``). CF latency is reported per wave as p50/p95/p99 of
the timed requests, each timed to the end of its device work; LM prefill
and decode times end in a device synchronize.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import tempfile
import time

import numpy as np
import torch

from .. import obs as obslib
from ..configs import landmark_cf as cfg
from ..configs import registry
from ..core import RatingMatrix, fit, fold_in, knn
from ..data import synthetic
from ..distributed.sharding import materializations
from ..models import transformer as lm_mod
from ..serving.stats import latency_stats
from ..train.checkpoint import (landmark_state_meta, latest_step,
                                load_landmark_state, save_landmark_state)

IVF_RECALL_SLO = 0.95  # serving recall target; nprobe escalates to hold it
# torch intra-op threads of the request engine on the CPU: its lanes run
# many small ops, and an op split over a pool waits for the pool's slowest
# thread, which other processes may keep off a core (the read tail under a
# loaded CPU); one thread a lane waits on none
ENGINE_CPU_THREADS = 1


@contextlib.contextmanager
def _engine_cpu_threads(device):
    """Bound torch's intra-op threads to ``ENGINE_CPU_THREADS`` while the
    engine serves on the CPU, and restore the count after; on a card
    nothing changes. Threads the engine starts inside take the bound."""
    if torch.device(device).type != "cpu":
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, ENGINE_CPU_THREADS))
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------------------- lm
def _serve_lm(args):
    device = torch.device(args.device)
    arch = registry.get(args.arch)
    lcfg = arch.smoke_model if args.smoke else arch.model
    model = lm_mod.init_lm(lcfg, torch.Generator(device).manual_seed(0),
                           device)
    prompts = torch.as_tensor(synthetic.lm_batch(
        0, 0, args.batch, args.prompt_len, lcfg.vocab)["tokens"],
        device=device)
    max_seq = args.prompt_len + args.tokens

    t0 = time.perf_counter()
    logits, cache = lm_mod.lm_prefill(model, prompts, max_seq=max_seq)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    print(f"prefill {args.batch}x{args.prompt_len}: {t_prefill*1e3:.0f}ms")

    if args.landmark:
        cache = lm_mod.make_landmark_cache(lcfg, args.batch, device)
        for key, seed in (("k_lm", 1), ("q_lm", 2)):
            g = torch.Generator(device).manual_seed(seed)
            cache[key] = torch.randn(cache[key].shape, generator=g,
                                     device=device).to(lcfg.dtype)
        step = lm_mod.lm_landmark_decode_step
    else:
        step = lm_mod.lm_decode_step

    tok = logits[:, -1:].argmax(-1).to(torch.int32)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for _ in range(args.tokens):
        logits, cache = step(model, cache, tok)
        tok = logits.argmax(-1).to(torch.int32)
        out_tokens.append(tok)
    _sync(device)
    dt = time.perf_counter() - t0
    mode = "landmark O(n)" if args.landmark else "exact KV"
    print(f"decode {args.tokens} tokens ({mode}): "
          f"{dt/args.tokens*1e3:.1f} ms/token")
    print("sample ids:", torch.cat(out_tokens, 1).cpu().numpy()[0][:12])


# ------------------------------------------------------------------------- cf
def _synth_ratings(rng, users, items, device, density=0.08):
    """Uniform ratings 1..5 at ``density`` — the reference's generator, so
    one seed gives the same matrix in both packages."""
    r = rng.integers(1, 6, (users, items)).astype(np.float32)
    r *= rng.random((users, items)) < density
    return torch.as_tensor(r, device=device)


def _ids(rng, n, size, device):
    return torch.as_tensor(rng.integers(0, n, size).astype(np.int32),
                           device=device)


def _cf_wave(state, rng, args, wave, device):
    """One request wave: batched pair predictions + top-N recommendations,
    each warmed once, then timed per call to the end of its device work."""
    u, p = state.ratings.shape
    knn.predict_pairs_graph(state.graph, state.ratings,
                            _ids(rng, u, args.batch, device),
                            _ids(rng, p, args.batch, device))  # warm
    _sync(device)
    pair_ts = []
    for _ in range(args.requests):
        users = _ids(rng, u, args.batch, device)
        items = _ids(rng, p, args.batch, device)
        t0 = time.perf_counter()
        out = knn.predict_pairs_graph(state.graph, state.ratings, users, items)
        _sync(device)
        pair_ts.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("non-finite predictions in serve wave")

    knn.recommend_topn_graph(state.graph, state.ratings,
                             _ids(rng, u, args.batch, device),
                             n=args.topn)  # warm
    _sync(device)
    topn_ts = []
    for _ in range(max(1, args.requests // 4)):
        users = _ids(rng, u, args.batch, device)
        t0 = time.perf_counter()
        knn.recommend_topn_graph(state.graph, state.ratings, users, n=args.topn)
        _sync(device)
        topn_ts.append(time.perf_counter() - t0)

    ps, ts = latency_stats(pair_ts), latency_stats(topn_ts)
    print(f"wave {wave}: U={u} predict {args.requests}x{args.batch} pairs "
          f"{ps.brief()} | top-{args.topn} x{args.batch} users {ts.brief()}")


def _serve_cf(args):
    device = torch.device(args.device)
    spec = cfg.SMOKE if args.smoke else cfg.MODEL
    if args.smoke:
        args.users, args.items = min(args.users, 512), min(args.items, 128)
        args.requests = min(args.requests, 8)
        args.foldin = min(args.foldin, 16)
        args.waves = min(args.waves, 2)
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="cf_serve_")
    rng = np.random.default_rng(0)

    if latest_step(ckpt_dir) is None:
        r = _synth_ratings(rng, args.users, args.items, device)
        t0 = time.perf_counter()
        st = fit(RatingMatrix(r, args.users, args.items), spec,
                 backend=args.graph_backend,
                 generator=torch.Generator().manual_seed(0))
        _sync(device)
        t_fit = time.perf_counter() - t0
        save_landmark_state(ckpt_dir, st, compact=args.compact)
        print(f"fit U={args.users} P={args.items} n={spec.n_landmarks} "
              f"k={st.graph.k} on {device}: {t_fit*1e3:.0f}ms -> "
              f"checkpointed {ckpt_dir}")

    t0 = time.perf_counter()
    state = load_landmark_state(ckpt_dir, widen=False, device=device)
    t_load = time.perf_counter() - t0
    stored_compact = state.graph.is_compact  # what is on disk
    art_kb = (state.graph.indices.nbytes + state.graph.weights.nbytes) / 1024
    if stored_compact:
        state = dataclasses.replace(state, graph=state.graph.to_full())
    print(f"loaded U={state.ratings.shape[0]} graph k={state.graph.k} "
          f"({art_kb:.0f}KB{', stored compact' if stored_compact else ''}) "
          f"on {device}: {t_load*1e3:.0f}ms")

    # the fold-in stream is sized from the artifact's item space, so a
    # reused --ckpt with other --users/--items flags stays consistent
    n_items = state.ratings.shape[1]
    fold_stream = _synth_ratings(rng, args.foldin * max(args.waves - 1, 0),
                                 n_items, device)
    for wave in range(args.waves):
        _cf_wave(state, rng, args, wave, device)
        if wave == args.waves - 1:
            break
        batch = fold_stream[wave * args.foldin:(wave + 1) * args.foldin]
        t0 = time.perf_counter()
        state = fold_in(state, batch, spec, backend=args.graph_backend)
        _sync(device)
        dt = time.perf_counter() - t0
        print(f"fold-in +{args.foldin} users: {dt*1e3:.1f}ms "
              f"(U {state.ratings.shape[0] - args.foldin}"
              f"->{state.ratings.shape[0]}, no refit)")
    print("cf serve: done")


# -------------------------------------------------------------- cf lifecycle
def _timed_requests(bst, rng, args, device):
    """One request wave against a BucketedState: warm, then time each call
    to the end of its device work. Returns (pair_ts, topn_ts)."""
    from ..lifecycle import buckets

    u = bst.n_valid
    p = bst.state.ratings.shape[1]
    users, items = _ids(rng, u, args.batch, device), _ids(rng, p, args.batch,
                                                          device)
    buckets.predict_pairs(bst, users, items)
    buckets.recommend_topn(bst, users, n=args.topn)
    _sync(device)
    pair_ts, topn_ts = [], []
    for _ in range(args.requests):
        users, items = (_ids(rng, u, args.batch, device),
                        _ids(rng, p, args.batch, device))
        t0 = time.perf_counter()
        out = buckets.predict_pairs(bst, users, items)
        _sync(device)
        pair_ts.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("non-finite predictions in lifecycle wave")
    for _ in range(max(1, args.requests // 4)):
        users = _ids(rng, u, args.batch, device)
        t0 = time.perf_counter()
        buckets.recommend_topn(bst, users, n=args.topn)
        _sync(device)
        topn_ts.append(time.perf_counter() - t0)
    return pair_ts, topn_ts


def _withhold(rng, batch, frac):
    """Split an arrival block into (train, holdout triples): each rated
    entry is withheld with probability ``frac`` (zeroed in the train
    block)."""
    rated = batch != 0
    hold = rated & (rng.random(batch.shape) < frac)
    rows, cols = np.nonzero(hold)
    train = batch * ~hold
    return (train.astype(np.float32), rows.astype(np.int32),
            cols.astype(np.int32), batch[rows, cols].astype(np.float32))


def _clamp_lifecycle_smoke(args):
    args.users, args.items = min(args.users, 256), min(args.items, 96)
    args.waves = min(args.waves, 8)
    args.arrivals = min(args.arrivals, 48)
    args.requests = min(args.requests, 8)
    args.batch = min(args.batch, 128)
    args.foldin = min(args.foldin, 32)
    args.min_bucket = min(args.min_bucket, 256)


def _offer_holdout(mon, rng, gen, start_id, hrows, hcols, hvals, res_batch):
    """Offer withheld triples to the reservoir in one fixed-size batch
    (subsampled when the arrival withheld more than a batch holds)."""
    from ..lifecycle import monitor

    if len(hrows) > res_batch:
        pick = rng.choice(len(hrows), res_batch, replace=False)
        hrows, hcols, hvals = hrows[pick], hcols[pick], hvals[pick]
    return monitor.reservoir_add(
        mon, gen, torch.as_tensor(start_id + hrows),
        torch.as_tensor(hcols), torch.as_tensor(hvals), len(hrows))


def _ivf_probe_sample(index, bst, rng, spec, args, device):
    """One wave's retrieval probe sample: fresh query rows and their exact
    (full-probe) reference. Every escalation step is judged on this same
    sample."""
    from .. import retrieval as rt

    u = bst.n_valid
    k = bst.state.graph.k
    qids = _ids(rng, u, min(args.batch, u), device)
    qrep = bst.state.representation[qids.long()]
    exact = rt.search(index, qrep, k, index.n_clusters, spec.d2,
                      self_ids=qids)
    return qids, qrep, k, exact


def _ivf_probe_recall(index, probe, nprobe, measure):
    """(recall@k by id, recall@k by score) of the serving-nprobe search
    against the wave's exact reference; the SLO holds the first, as the
    reference does, and the second shows how much of its shortfall is
    exact score ties at the cut."""
    from .. import retrieval as rt

    qids, qrep, k, (ve, ie) = probe
    va, ia = rt.search(index, qrep, k, nprobe, measure, self_ids=qids)
    return rt.recall_at_k(ia, ie, va, ve), rt.score_recall_at_k(va, ve)


def _serve_cf_lifecycle(args):
    """Replay a drifting stream through the fit→serve→monitor→refresh loop."""
    from ..data.synthetic import drifting_ratings
    from ..lifecycle import buckets, monitor, policy
    from ..lifecycle.refresh import RefreshManager

    device = torch.device(args.device)
    spec = cfg.SMOKE if args.smoke else cfg.MODEL
    # refresh helps only if reselection can move the landmarks to the
    # drifted population: coresets (diversity-seeking) does, popularity
    # (count-ranked, ties to the incumbents) does not
    spec = dataclasses.replace(spec, selection=args.selection)
    rspec = cfg.SMOKE_REFRESH if args.smoke else cfg.REFRESH
    if args.compact_serving:
        rspec = dataclasses.replace(rspec, compact_serving=True)
    if args.smoke:
        _clamp_lifecycle_smoke(args)
    stream = dict(n_waves=args.waves, drift=args.drift)
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="cf_lifecycle_")
    rng = np.random.default_rng(0)
    bq = args.foldin  # fold-in batch bucket: b is padded to this, always
    buckets.reset_geometries()
    o = None
    if args.trace_dir or args.metrics_json:
        # per-wave drift gauges land in the registry, and the installed
        # tracer catches the background refresh spans (refresh.fit /
        # refresh.commit / refresh.ivf_rebuild)
        o = obslib.Observability(sample_rate=args.sample_rate, seed=0)
        obslib.install(o)

    # ---- base generation: fit on the wave-0 population, commit, bucket ----
    # a reused --ckpt keeps earlier runs' steps; this run's generations go
    # above them so latest_step stays this run's artifact
    prev = latest_step(ckpt_dir)
    gen0 = prev + 1 if prev is not None else 0
    r0 = drifting_ratings(0, 0, args.users, args.items, **stream)
    t0 = time.perf_counter()
    st = fit(RatingMatrix(torch.as_tensor(r0, device=device), args.users,
                          args.items), spec,
             generator=torch.Generator().manual_seed(0))
    _sync(device)
    t_fit = time.perf_counter() - t0
    save_landmark_state(ckpt_dir, st, step=gen0)
    base_cov = monitor.batch_coverage(
        st.representation, torch.ones(args.users, device=device))
    bst = buckets.from_state(st, args.min_bucket, args.growth)
    caps_used = {bst.capacity}
    mon = monitor.init_monitor(rspec.reservoir, args.users, base_cov, device)
    pol = policy.PolicyState(generation=gen0)

    use_ivf = args.retrieval == "ivf"
    index = retrieval = user_ivf = None
    recalls = []
    if use_ivf:
        from .. import retrieval as rt

        user_ivf = rt.IVFSpec(n_clusters=args.clusters or None,
                              nprobe=args.nprobe or None)

        def resolve_serving_ivf(u):
            ivf = rt.resolve_ivf(user_ivf, u)
            if args.smoke and not args.nprobe:
                # smoke scale asks for k=13 of ~256 rows, a twentieth of
                # the population per query, so a quarter of the cells
                # cannot hold recall >= 0.95; probe half instead
                ivf = dataclasses.replace(
                    ivf, nprobe=max(ivf.nprobe, ivf.n_clusters // 2))
            return ivf

        retrieval = resolve_serving_ivf(args.users)
        index = rt.build_index(bst.state.representation, retrieval, spec.d2,
                               n_valid=bst.n_valid)
    manager = RefreshManager(ckpt_dir, spec, compact=rspec.compact_serving,
                             compact_max_rows=rspec.compact_max_rows,
                             ivf=user_ivf, device=device)
    pending = last_refit = None  # (generation, rows) of a refit
    swap_wave = pre_post = None
    print(f"gen {gen0}: fit U={args.users} P={args.items} "
          f"n={spec.n_landmarks} k={st.graph.k} on {device} in "
          f"{t_fit*1e3:.0f}ms, bucket {bst.capacity} (schedule: "
          f"min={args.min_bucket} x{args.growth:g}) -> {ckpt_dir}")
    if use_ivf:
        print(f"retrieval: ivf C={index.n_clusters} cap={index.capacity} "
              f"nprobe={retrieval.nprobe} (exact at "
              f"nprobe={index.n_clusters})")

    res_gen = torch.Generator().manual_seed(42)  # reservoir draws
    for wave in range(args.waves):
        t_wave = time.perf_counter()
        pair_ts, topn_ts = _timed_requests(bst, rng, args, device)
        ps, ts_ = latency_stats(pair_ts), latency_stats(topn_ts)

        # ---- arrivals: withhold holdout ratings, fold the rest in ---------
        if wave + 1 < args.waves:
            arr = drifting_ratings(0, wave + 1, args.arrivals, args.items,
                                   **stream)
            train, hrows, hcols, hvals = _withhold(rng, arr,
                                                   rspec.holdout_frac)
            start_id = bst.n_valid  # arrival i becomes row start_id + i
            bst = buckets.fold_in_rows(bst, train, bq, spec, args.min_bucket,
                                       args.growth)
            caps_used.add(bst.capacity)
            rep_rows = bst.state.representation[start_id:start_id + len(train)]
            mon = monitor.observe_fold_in(mon, rep_rows, len(train))
            mon = _offer_holdout(mon, rng, res_gen, start_id, hrows, hcols,
                                 hvals, rspec.reservoir)
            if use_ivf:  # append under the frozen quantizer
                index, _ = rt.ensure_index_capacity(index, len(train))
                index = rt.append(
                    index.to_full(), rep_rows,
                    start_id + torch.arange(len(train), device=device),
                    spec.d2, spill_choices=retrieval.spill_choices)

        # ---- drift detection + refresh decision ---------------------------
        snap = monitor.holdout_snapshot(mon, bst)
        if o is not None:
            monitor.publish_snapshot(o.registry, snap)
        if math.isnan(pol.base_mae) and snap.holdout_count >= rspec.min_holdout:
            pol.base_mae = snap.mae  # post-fit baseline, first healthy holdout
        fire, reasons = policy.decide(pol, rspec, snap)
        if fire:
            gen = pol.generation + 1
            rows = bst.state.ratings[:bst.n_valid].cpu().numpy().copy()
            # request() declines while the previous refit is winding down:
            # keep the streak and retry next wave
            if manager.request(rows, gen):
                policy.on_fire(pol)
                pending = (gen, rows)
                print(f"wave {wave}: gen {pol.generation} refresh -> gen "
                      f"{gen} launched in background ({'; '.join(reasons)})")

        # ---- poll the background refit; swap when committed ---------------
        done = manager.poll()
        if done is None and wave == args.waves - 1 and manager.busy:
            manager.join()  # drain so the replay always reports the swap
            done = manager.poll()
        if done is not None:
            if use_ivf:
                gen, st_new, new_index = done  # index rebuilt in the swap
            else:
                gen, st_new = done
            mae_pre = snap.mae
            snap_u = st_new.ratings.shape[0]
            cur_n = bst.n_valid
            new_bst = buckets.from_state(st_new, args.min_bucket, args.growth)
            # users folded while the refit ran: fold the delta into the new
            # generation
            delta = bst.state.ratings[snap_u:cur_n]
            bst = buckets.fold_in_rows(new_bst, delta, bq, spec,
                                       args.min_bucket, args.growth)
            caps_used.add(bst.capacity)
            if use_ivf and len(delta):
                new_index, _ = rt.ensure_index_capacity(new_index, len(delta))
                new_index = rt.append(
                    new_index, bst.state.representation[snap_u:cur_n],
                    snap_u + torch.arange(len(delta), device=device),
                    spec.d2, spill_choices=retrieval.spill_choices)
            if use_ivf:
                index = new_index
                # refreshed landmarks restore cell structure: drop any SLO
                # escalation back to the default probe budget
                retrieval = resolve_serving_ivf(bst.n_valid)
            if policy.should_compact(rspec, bst.capacity):
                # lifecycle-driven compaction: serve the uint16/bf16 graph
                # until the next fold-in or growth widens it
                bst = buckets.compact_state(bst)
                art_kb = (bst.state.graph.indices.nbytes
                          + bst.state.graph.weights.nbytes) / 1024
                if use_ivf:  # --compact-serving covers the index too
                    index = index.to_compact()
                    art_kb += (index.lists.nbytes + index.rows.nbytes
                               + index.centroids.nbytes) / 1024
                print(f"wave {wave}: serving graph compacted "
                      f"(uint16/bf16, {art_kb:.0f}KB resident)")
            new_cov = monitor.batch_coverage(
                st_new.representation, torch.ones(snap_u, device=device))
            mon = monitor.rebase(mon, bst.n_valid, new_cov)
            snap, reasons = monitor.holdout_snapshot(mon, bst), []
            if o is not None:
                monitor.publish_snapshot(o.registry, snap)
            mae_post = snap.mae
            policy.on_swap(pol, gen, mae_post, rspec)
            last_refit, pending = pending, None
            swap_wave, pre_post = wave, (mae_pre, mae_post)
            print(f"wave {wave}: swapped in gen {gen} (U={snap_u}+"
                  f"{len(delta)} delta, serving uninterrupted) holdout MAE "
                  f"{mae_pre:.4f} -> {mae_post:.4f}")

        ivf_note = ""
        if use_ivf:
            # the list-skew gate first: drifted arrivals pile into cells the
            # frozen quantizer does not cover, and the repack re-cells them
            skew = monitor.shard_skew(index.fill)
            if policy.should_rebalance(pol, rspec, skew):
                retrieval = resolve_serving_ivf(bst.n_valid)
                index = rt.build_index(bst.state.representation, retrieval,
                                       spec.d2, n_valid=bst.n_valid)
                print(f"wave {wave}: ivf lists rebalanced (skew {skew:.2f} > "
                      f"{rspec.max_skew:.2f}) -> C={index.n_clusters} "
                      f"cap={index.capacity}")
                skew = monitor.shard_skew(index.fill)
            # then the retrieval health of what the next wave serves:
            # recall@k of the serving-nprobe search against the exact
            # search, probing more cells until the SLO holds
            probe = _ivf_probe_sample(index, bst, rng, spec, args, device)
            rec, rec_score = _ivf_probe_recall(index, probe,
                                               retrieval.nprobe, spec.d2)
            while rec < IVF_RECALL_SLO and retrieval.nprobe < index.n_clusters:
                esc = min(index.n_clusters, max(retrieval.nprobe + 1,
                                                (retrieval.nprobe * 3) // 2))
                retrieval = dataclasses.replace(retrieval, nprobe=esc)
                rec, rec_score = _ivf_probe_recall(index, probe, esc,
                                                   spec.d2)
                print(f"wave {wave}: ivf recall below SLO -> nprobe "
                      f"escalated to {esc}/{index.n_clusters} "
                      f"(recall {rec:.3f})")
            ee_note = ""
            if args.early_exit:
                # adaptive probing atop the escalated budget: each query
                # stops once its own top-k stops moving
                qids, qrep, kk, (ve, ie) = probe
                va, ia, probed = rt.search_early_exit(
                    index, qrep, kk, retrieval.nprobe, spec.d2,
                    self_ids=qids)
                ee_rec = rt.recall_at_k(ia, ie, va, ve)
                ee_note = (f" probed/q={float(probed.float().mean()):.1f}/"
                           f"{retrieval.nprobe} (early-exit recall "
                           f"{ee_rec:.3f}, by score "
                           f"{rt.score_recall_at_k(va, ve):.3f})")
            recalls.append(rec)
            ivf_note = (f" | ivf recall@{bst.state.graph.k}={rec:.3f} "
                        f"(by score {rec_score:.3f}) "
                        f"nprobe={retrieval.nprobe} skew={skew:.2f}"
                        + ee_note)
        _sync(device)
        print(f"wave {wave}: gen {pol.generation} U={bst.n_valid}"
              f"/cap{bst.capacity} predict {args.requests}x{args.batch} pairs "
              f"{ps.brief()} | top-{args.topn} {ts_.brief()} | "
              f"mae={snap.mae:.4f} cov={snap.coverage_ratio:.2f} "
              f"fold={snap.foldin_frac:.2f}" + ivf_note
              + f" | wave {(time.perf_counter() - t_wave)*1e3:.1f}ms"
              + (f" | breach: {'; '.join(reasons)}" if reasons else ""))

    # ---- replay report: geometries, swap, oracle-exactness ----------------
    counts = buckets.geometry_counts()
    print(f"geometries per request-path family: {counts} "
          f"(buckets used: {sorted(caps_used)})")
    worst = max(counts.values())
    assert worst <= len(caps_used), (
        f"geometry count {counts} exceeds bucket count {len(caps_used)} — "
        "the bucketed steps must run at one geometry per bucket")
    if pre_post is not None:
        mae_pre, mae_post = pre_post
        print(f"refresh: fired gen {pol.generation} at wave {swap_wave}, "
              f"holdout MAE {mae_pre:.4f} -> {mae_post:.4f}")
        assert mae_post <= mae_pre + 1e-6, (
            "refresh must not degrade holdout MAE on the drifting stream")
        # oracle: the served artifact equals a from-scratch fit on the
        # accumulated rows (checkpoint round trip included)
        gen, rows = last_refit
        loaded = load_landmark_state(ckpt_dir, step=gen, device=device)
        assert latest_step(ckpt_dir) == gen, (latest_step(ckpt_dir), gen)
        oracle = fit(RatingMatrix(torch.as_tensor(rows, device=device),
                                  *rows.shape), spec,
                     generator=torch.Generator().manual_seed(gen))
        og = oracle.graph
        if landmark_state_meta(ckpt_dir, gen)["compact"]:
            og = og.to_compact().to_full()  # artifact stored uint16/bf16
        exact = (torch.equal(loaded.graph.indices, og.indices)
                 and torch.equal(loaded.graph.weights, og.weights))
        print(f"swap oracle-exact vs from-scratch fit (gen {gen}): {exact}")
        assert exact, "swapped artifact diverged from a from-scratch fit"
    else:
        print("refresh: never fired (stream did not drift past thresholds)")
        if args.smoke:
            raise AssertionError(
                "smoke lifecycle replay must exercise a refresh; "
                "tune --drift/--waves or the smoke RefreshSpec")
    if use_ivf:
        print(f"ivf retrieval: recall@k per wave "
              f"{[f'{r:.3f}' for r in recalls]} (mean "
              f"{np.mean(recalls):.3f}, SLO {IVF_RECALL_SLO}) ending at "
              f"nprobe={retrieval.nprobe}/{index.n_clusters}")
        if args.smoke:
            assert np.mean(recalls) >= IVF_RECALL_SLO, (
                f"ivf smoke recall {np.mean(recalls):.3f} < {IVF_RECALL_SLO} "
                "on the drifting stream")
    if o is not None:
        from ..retrieval import publish_retrieval

        obslib.publish_compile_counts(o.registry)
        if use_ivf:
            publish_retrieval(
                o.registry, nprobe=retrieval.nprobe,
                clusters=index.n_clusters,
                recall=(float(np.mean(recalls)) if recalls
                        else float("nan")),
                early_exit=bool(args.early_exit), probes=len(recalls))
        else:
            publish_retrieval(o.registry)
        _export_obs(o, args)
    print("cf lifecycle: done")


def _export_obs(o, args):
    """Write the trace and the metrics snapshot that were asked for, then
    uninstall the process-wide instance."""
    if args.trace_dir:
        tp = o.export_trace(args.trace_dir)
        print(f"obs: {len(o.tracer.events())} spans "
              f"({o.tracer.dropped} dropped) -> {tp}")
    if args.metrics_json:
        print(f"obs: metrics snapshot -> "
              f"{o.export_metrics(args.metrics_json)}")
    obslib.uninstall()


# ------------------------------------------------------ cf lifecycle, sharded
def _parse_mesh(arg: str):
    """``pod=2,data=4`` -> (("pod", "data"), (2, 4))."""
    names, sizes = [], []
    for part in arg.split(","):
        name, _, size = part.partition("=")
        if not size:
            raise ValueError(f"--mesh expects name=size pairs, got {part!r}")
        names.append(name.strip())
        sizes.append(int(size))
    return tuple(names), tuple(sizes)


def _sync_mesh(mesh) -> None:
    for dev in set(mesh.devices):
        _sync(dev)


class _SideTally:
    """The kernel launches and wall ms of the calls made beside the mesh
    path — the one-device shadow replay, the oracle fit and the
    materialization checks — so that the mesh path's own are the rest.
    Launches are tallied on the calling thread only (``kernels.build.tally``):
    a background refit's, on its own thread, are the mesh path's and never
    land here. Each block is timed between two syncs of the mesh; a refit
    shares the default stream, so its queued work may fall in the time."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.launches: dict = {}
        self.ms = 0.0

    @contextlib.contextmanager
    def __call__(self):
        from ..kernels import build

        _sync_mesh(self.mesh)
        t0 = time.perf_counter()
        with build.tally() as counts:
            yield
            _sync_mesh(self.mesh)
        self.ms += (time.perf_counter() - t0) * 1e3
        for name, c in counts.items():
            self.launches[name] = self.launches.get(name, 0) + c


def _foldin_replication_check(sst, bq, spec):
    """Prove the sharded fold-in keeps the row space sharded: no tensor of
    rows (two or more dimensions; a kernel's flat scratch buffer is none)
    that a fold-in of one row builds has S·C rows or more (on a copy of the
    state). Returns (tensors scanned, offenders, row-sharded outputs)."""
    from ..core.landmark_cf import fold_in_sharded
    from ..lifecycle.buckets import ensure_capacity_sharded

    probe, _ = ensure_capacity_sharded(sst.clone(), 0, bq)
    rows = probe.shard_count * probe.capacity
    batch = torch.zeros((bq, sst.ratings[0].shape[1]),
                        device=sst.devices[0])
    out = []
    n, bad = materializations(
        lambda: out.append(fold_in_sharded(probe, batch, 1, 0, spec)),
        lambda shp: probe.shard_count > 1 and len(shp) > 1
        and shp[0] >= rows)
    res = out[0]
    blocks = (res.ratings, res.representation, res.row_rank,
              [g.indices for g in res.graph], [g.weights for g in res.graph])
    row_sharded = sum(
        len(b) == res.shard_count
        and all(x.shape[0] == res.capacity and x.device == d
                for x, d in zip(b, res.devices)) for b in blocks)
    return n, bad, row_sharded


def _ivf_materialization_check(index, qb, k, nprobe, measure, budget):
    """Prove the sharded probe path never builds a per-query candidate
    tensor of nprobe·cap rows, the (qb, nprobe·cap[, n]) a gather-then-score
    of every probed cell would. Returns (tensors scanned, offenders)."""
    from .. import retrieval as rt

    bound = nprobe * index.capacity
    if bound <= max(index.shard_count * k, k + index.capacity):
        raise ValueError(  # merge widths would alias the candidate bound
            f"materialization check is vacuous at nprobe*cap={bound}; "
            "probe more cells")
    q = torch.zeros((qb, index.centroids.shape[1]),
                    device=index.centroids.device)
    return materializations(
        lambda: rt.search_sharded(index, q, k, nprobe, measure,
                                  local_budget=budget),
        lambda shp: len(shp) >= 2 and shp[0] == qb and shp[1] >= bound)


def _ivf_probe_sample_sharded(index, sst, sharded_ids, n_live, rng, spec,
                              args):
    """One wave's probe sample on the mesh: fresh logical query ids, their
    representation rows gathered from their owner shards, and the
    full-probe (exact) sharded search as the reference."""
    from .. import retrieval as rt
    from ..distributed.sharding import gather_rows

    k = sst.k
    qids = rng.integers(0, n_live, min(args.batch, n_live)).astype(np.int32)
    qrep = gather_rows(sst.representation, sharded_ids(qids), sst.capacity,
                       sst.devices[0])
    lq = torch.as_tensor(qids, device=sst.devices[0])
    ve, ie, _ = rt.search_sharded(index, qrep, k, index.n_clusters, spec.d2,
                                  self_ids=lq)
    return lq, qrep, k, (ve, ie)


def _ivf_probe_recall_sharded(index, probe, nprobe, measure, local_budget):
    """(recall@k by id, mean probed cells a query) of the serving-nprobe
    sharded search against the wave's exact reference."""
    from .. import retrieval as rt

    qids, qrep, k, (ve, ie) = probe
    va, ia, probed = rt.search_sharded(index, qrep, k, nprobe, measure,
                                       self_ids=qids,
                                       local_budget=local_budget)
    return (rt.recall_at_k(ia, ie, va, ve),
            float(probed.to(torch.float32).mean()))


def _serve_cf_lifecycle_sharded(args):
    """The lifecycle replay on a mesh: fit_distributed →
    ShardedLandmarkState serving → shard-local-append fold-in → monitor →
    distributed refresh → swap, with a single-device shadow replay (same landmarks, same seeds,
    same arrival stream) that every wave's predictions must equal bit for
    bit. Returns the replay's stats."""
    from ..core.landmark_cf import fit_distributed
    from ..data.synthetic import drifting_ratings
    from ..distributed.sharding import gather_rows
    from ..lifecycle import buckets, monitor, policy
    from ..lifecycle.refresh import RefreshManager
    from .mesh import make_mesh

    device = torch.device(args.device)
    names, sizes = _parse_mesh(args.mesh)
    mesh = make_mesh(names, sizes, device)
    axes = names
    n_shards = mesh.size
    print(f"mesh {mesh.describe()}")
    spec = cfg.SMOKE if args.smoke else cfg.MODEL
    spec = dataclasses.replace(spec, selection=args.selection)
    rspec = cfg.SMOKE_REFRESH if args.smoke else cfg.REFRESH
    if args.compact_serving:
        print("--compact-serving is a single-device serving policy; "
              "ignored under --mesh (the sharded artifact stays f32/int32)")
    if args.smoke:
        _clamp_lifecycle_smoke(args)
    min_shard_bucket = max(8, args.min_bucket // n_shards)
    stream = dict(n_waves=args.waves, drift=args.drift)
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="cf_sharded_")
    rng = np.random.default_rng(0)
    bq = args.foldin
    buckets.reset_geometries()
    o = None
    if args.trace_dir or args.metrics_json:
        o = obslib.Observability(sample_rate=args.sample_rate, seed=0)
        obslib.install(o)

    # ---- base generation: fit_distributed + the single-device shadow -----
    prev = latest_step(ckpt_dir)
    gen0 = prev + 1 if prev is not None else 0
    r0 = torch.as_tensor(drifting_ratings(0, 0, args.users, args.items,
                                          **stream), device=device)
    t0 = time.perf_counter()
    st = fit_distributed(r0, spec, mesh, axes,
                         generator=torch.Generator().manual_seed(0))
    _sync_mesh(mesh)
    t_fit = time.perf_counter() - t0
    save_landmark_state(ckpt_dir, st, step=gen0, row_shards=n_shards)
    side = _SideTally(mesh)  # the shadow's and the checks' share
    mesh_fits, mesh_fold_batches = 1, 0
    with side():
        shadow_st = fit(RatingMatrix(r0, args.users, args.items), spec,
                        generator=torch.Generator().manual_seed(0))
        bst = buckets.from_state(shadow_st, args.min_bucket, args.growth)
    sst = buckets.from_state_sharded(st, mesh, axes, min_shard_bucket,
                                     args.growth)
    # logical row id -> (shard, slot); slots survive capacity regrowth
    u_per = -(-args.users // n_shards)
    id_shard = (np.arange(args.users) // u_per).astype(np.int64)
    id_slot = (np.arange(args.users) % u_per).astype(np.int64)
    meta0 = landmark_state_meta(ckpt_dir, gen0)
    print(f"gen {gen0}: fit_distributed U={args.users} over "
          f"{'x'.join(f'{a}={s}' for a, s in zip(axes, sizes))} "
          f"(S={n_shards}, u/shard={u_per}) n={spec.n_landmarks} "
          f"k={st.graph.k} in {t_fit*1e3:.0f}ms; per-shard bucket "
          f"C={sst.capacity} (min={min_shard_bucket} x{args.growth:g}); "
          f"checkpoint row shards: {meta0['row_shards']} -> {ckpt_dir}")

    # ---- one-time proof: a fold-in never builds an S·C-row tensor ---------
    with side():
        n_t, offenders, row_sharded = _foldin_replication_check(sst, bq,
                                                                spec)
    print(f"fold-in sharding check: {n_t} tensors scanned, "
          f"{len(offenders)} full-row materializations, "
          f"{row_sharded} row-sharded outputs")
    assert not offenders, offenders
    assert row_sharded >= 4, "rep/ratings/graph outputs must stay row-sharded"

    def sharded_ids(logical):
        return torch.as_tensor(id_shard[logical] * sst.capacity
                               + id_slot[logical], device=sst.devices[0])

    def id_map():
        return id_shard * sst.capacity + id_slot

    use_ivf = args.retrieval == "ivf"
    index = retrieval = user_ivf = None
    recalls = []
    if use_ivf:
        from .. import retrieval as rt

        user_ivf = rt.IVFSpec(n_clusters=args.clusters or None,
                              nprobe=args.nprobe or None)

        def resolve_serving_ivf(u):
            ivf = rt.resolve_ivf_sharded(user_ivf, u, n_shards)
            if args.smoke and not args.nprobe:
                # as on one device: k is a large share of U at smoke size,
                # a quarter of the cells cannot hold recall
                ivf = dataclasses.replace(
                    ivf, nprobe=max(ivf.nprobe, ivf.n_clusters // 2))
            return ivf

        def probe_budget(nprobe):
            # a hot shard's work bounded to ~2x the even split; at full
            # probe search_sharded takes C/S whatever this says
            return min(nprobe, max(1, 2 * (-(-nprobe // n_shards))))

        retrieval = resolve_serving_ivf(args.users)
        # built on the logical-order representation (the fit's), placed
        # on the mesh: bitwise the index one device would build
        index = rt.build_index_sharded(st.representation, retrieval, mesh,
                                       axes, spec.d2)
        print(f"retrieval: sharded ivf C={index.n_clusters} "
              f"({index.cells_per_shard} cells/shard) cap={index.capacity} "
              f"nprobe={retrieval.nprobe} "
              f"budget={probe_budget(retrieval.nprobe)}/shard")
        ck_np = max(2, retrieval.nprobe)
        with side():
            n_t, offenders = _ivf_materialization_check(
                index, min(args.batch, args.users), sst.k, ck_np, spec.d2,
                probe_budget(ck_np))
        print(f"ivf serve-path check: {n_t} tensors scanned, "
              f"{len(offenders)} candidate-tensor materializations")
        assert not offenders, offenders

    base_cov = monitor.batch_coverage(
        shadow_st.representation, torch.ones(args.users, device=device))
    mon = monitor.init_monitor(rspec.reservoir, args.users, base_cov,
                               sst.devices[0])
    pol = policy.PolicyState(generation=gen0)
    manager = RefreshManager(ckpt_dir, spec, ivf=user_ivf, device=device,
                             mesh=mesh, row_axes=axes)
    pending = None
    swap_wave = pre_post = None
    identical_waves = 0
    caps_sh, caps_lo = {sst.capacity}, {bst.capacity}
    wave_ms, side_ms = [], []
    res_gen = torch.Generator().manual_seed(42)  # reservoir draws

    for wave in range(args.waves):
        t_wave, side0 = time.perf_counter(), side.ms
        # ---- bit-identity probe against the single-device shadow --------
        prng = np.random.default_rng(10_000 + wave)
        n_live = len(id_shard)
        pu = prng.integers(0, n_live, args.batch).astype(np.int64)
        pi = torch.as_tensor(prng.integers(0, args.items, args.batch),
                             device=device)
        lo_u = torch.as_tensor(pu, device=device)
        p_sh = buckets.predict_pairs_sharded(sst, sharded_ids(pu), pi)
        t_sh, s_sh = buckets.recommend_topn_sharded(sst, sharded_ids(pu),
                                                    n=args.topn)
        with side():
            p_lo = buckets.predict_pairs(bst, lo_u, pi)
            t_lo, s_lo = buckets.recommend_topn(bst, lo_u, n=args.topn)
        same = (torch.equal(p_sh.to(device), p_lo)
                and torch.equal(t_sh.to(device), t_lo)
                and torch.equal(s_sh.to(device), s_lo))
        identical_waves += bool(same)
        assert same, (
            f"wave {wave}: sharded predictions diverged from the "
            f"single-device shadow (max |d|="
            f"{float((p_sh.to(device) - p_lo).abs().max())})")

        # ---- timed requests on the sharded path (the probe warmed it) ----
        pair_ts, topn_ts = [], []
        for _ in range(args.requests):
            qu = sharded_ids(rng.integers(0, n_live, args.batch))
            qi = torch.as_tensor(rng.integers(0, args.items, args.batch),
                                 device=sst.devices[0])
            t0 = time.perf_counter()
            out = buckets.predict_pairs_sharded(sst, qu, qi)
            _sync_mesh(mesh)
            pair_ts.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError("non-finite predictions in sharded wave")
        for _ in range(max(1, args.requests // 4)):
            qu = sharded_ids(rng.integers(0, n_live, args.batch))
            t0 = time.perf_counter()
            buckets.recommend_topn_sharded(sst, qu, n=args.topn)
            _sync_mesh(mesh)
            topn_ts.append(time.perf_counter() - t0)
        ps, ts_ = latency_stats(pair_ts), latency_stats(topn_ts)

        # ---- arrivals: fold into both states; the reservoir keeps logical
        # ids -------------------------------------------------------------
        if wave + 1 < args.waves:
            arr = drifting_ratings(0, wave + 1, args.arrivals, args.items,
                                   **stream)
            train, hrows, hcols, hvals = _withhold(rng, arr,
                                                   rspec.holdout_frac)
            start_logical = n_live
            sst, fsh, fsl = buckets.fold_in_rows_sharded(
                sst, train, bq, spec, min_shard_bucket, args.growth)
            mesh_fold_batches += -(-len(train) // bq)
            caps_sh.add(sst.capacity)
            id_shard = np.concatenate([id_shard, fsh.astype(np.int64)])
            id_slot = np.concatenate([id_slot, fsl.astype(np.int64)])
            with side():
                bst = buckets.fold_in_rows(bst, train, bq, spec,
                                           args.min_bucket, args.growth)
            caps_lo.add(bst.capacity)
            rep_rows = gather_rows(
                sst.representation,
                fsh.astype(np.int64) * sst.capacity + fsl, sst.capacity,
                sst.devices[0])
            mon = monitor.observe_fold_in(mon, rep_rows, len(train))
            mon = _offer_holdout(mon, rng, res_gen, start_logical, hrows,
                                 hcols, hvals, rspec.reservoir)
            if use_ivf:
                # plan once, scatter shard-locally: bitwise the
                # single-device append on the gathered arrays
                index, _ = rt.ensure_index_capacity_sharded(index,
                                                            len(train))
                index = rt.append_sharded(
                    index, rep_rows,
                    start_logical + torch.arange(len(train)), spec.d2,
                    spill_choices=retrieval.spill_choices)

        # ---- drift detection + distributed refresh ------------------------
        snap = monitor.holdout_snapshot_sharded(mon, sst, id_map())
        if o is not None:
            monitor.publish_snapshot(o.registry, snap)
        if math.isnan(pol.base_mae) and snap.holdout_count >= rspec.min_holdout:
            pol.base_mae = snap.mae
        fire, reasons = policy.decide(pol, rspec, snap)
        if fire:
            gen = pol.generation + 1
            rows = gather_rows(sst.ratings, id_map(), sst.capacity,
                               "cpu").numpy()  # logical row order
            if manager.request(rows, gen):
                mesh_fits += 1
                policy.on_fire(pol)
                pending = (gen, rows)
                print(f"wave {wave}: gen {pol.generation} refresh -> gen "
                      f"{gen} launched on the mesh ({'; '.join(reasons)})")

        # ---- poll; swap both replicas when the refit commits --------------
        done = manager.poll()
        if done is None and wave == args.waves - 1 and manager.busy:
            manager.join()
            done = manager.poll()
        if done is not None:
            if use_ivf:
                gen, st_new, new_index = done  # on the mesh, rebuilt
            else:
                gen, st_new = done
            mae_pre = snap.mae
            snap_u = st_new.ratings.shape[0]
            delta = gather_rows(sst.ratings, id_map()[snap_u:],
                                sst.capacity, "cpu").numpy()
            # oracle: the committed sharded artifact == a one-device fit
            gen_p, rows_p = pending
            assert gen_p == gen
            with side():
                oracle = fit(RatingMatrix(torch.as_tensor(rows_p,
                                                          device=device),
                                          *rows_p.shape), spec,
                             generator=torch.Generator().manual_seed(gen))
                loaded = load_landmark_state(ckpt_dir, step=gen,
                                             device=device)
                exact = (torch.equal(loaded.graph.indices,
                                     oracle.graph.indices)
                         and torch.equal(loaded.graph.weights,
                                         oracle.graph.weights))
            assert exact, ("distributed refresh artifact diverged from the "
                           "single-device from-scratch fit")
            # swap the sharded replica and rebuild the logical id map
            sst = buckets.from_state_sharded(st_new, mesh, axes,
                                             min_shard_bucket, args.growth)
            u_per = -(-snap_u // n_shards)
            id_shard = (np.arange(snap_u) // u_per).astype(np.int64)
            id_slot = (np.arange(snap_u) % u_per).astype(np.int64)
            sst, fsh, fsl = buckets.fold_in_rows_sharded(
                sst, delta, bq, spec, min_shard_bucket, args.growth)
            mesh_fold_batches += -(-len(delta) // bq)
            caps_sh.add(sst.capacity)
            id_shard = np.concatenate([id_shard, fsh.astype(np.int64)])
            id_slot = np.concatenate([id_slot, fsl.astype(np.int64)])
            if use_ivf:
                # the index with its refreshed quantizer, plus the rows
                # folded while the refit ran; the nprobe escalation drops
                if len(delta):
                    new_index, _ = rt.ensure_index_capacity_sharded(
                        new_index, len(delta))
                    drep = gather_rows(
                        sst.representation,
                        fsh.astype(np.int64) * sst.capacity + fsl,
                        sst.capacity, sst.devices[0])
                    new_index = rt.append_sharded(
                        new_index, drep, snap_u + torch.arange(len(delta)),
                        spec.d2, spill_choices=retrieval.spill_choices)
                index = new_index
                retrieval = resolve_serving_ivf(len(id_shard))
            # the shadow swaps through its own one-device fit
            with side():
                bst = buckets.from_state(oracle, args.min_bucket,
                                         args.growth)
                bst = buckets.fold_in_rows(bst, delta, bq, spec,
                                           args.min_bucket, args.growth)
            caps_lo.add(bst.capacity)
            new_cov = monitor.batch_coverage(
                st_new.representation, torch.ones(snap_u, device=device))
            mon = monitor.rebase(mon, len(id_shard), new_cov)
            snap, reasons = monitor.holdout_snapshot_sharded(
                mon, sst, id_map()), []
            mae_post = snap.mae
            policy.on_swap(pol, gen, mae_post, rspec)
            pending = None
            swap_wave, pre_post = wave, (mae_pre, mae_post)
            print(f"wave {wave}: swapped in gen {gen} on all {n_shards} "
                  f"shards (U={snap_u}+{len(delta)} delta, oracle-exact, "
                  f"serving uninterrupted) holdout MAE "
                  f"{mae_pre:.4f} -> {mae_post:.4f}")

        ivf_note = ""
        if use_ivf:
            # the cell-skew gate: a breach re-cells the population in
            # logical row order (bitwise the same rebuild on any mesh)
            cskew = monitor.shard_skew(index.fill)
            if policy.should_rebalance(pol, rspec, cskew):
                retrieval = resolve_serving_ivf(len(id_shard))
                rep_log = gather_rows(sst.representation, id_map(),
                                      sst.capacity, sst.devices[0])
                index = rt.build_index_sharded(rep_log, retrieval, mesh,
                                               axes, spec.d2)
                print(f"wave {wave}: ivf lists rebalanced (cell skew "
                      f"{cskew:.2f} > {rspec.max_skew:.2f}) -> "
                      f"C={index.n_clusters} cap={index.capacity}")
                cskew = monitor.shard_skew(index.fill)
            # the retrieval health of what the next wave serves, through
            # the sharded posting lists; probed counts cells scored
            probe = _ivf_probe_sample_sharded(index, sst, sharded_ids,
                                              len(id_shard), rng, spec, args)
            rec, probed_q = _ivf_probe_recall_sharded(
                index, probe, retrieval.nprobe, spec.d2,
                probe_budget(retrieval.nprobe))
            while rec < IVF_RECALL_SLO and retrieval.nprobe < index.n_clusters:
                esc = min(index.n_clusters, max(retrieval.nprobe + 1,
                                                (retrieval.nprobe * 3) // 2))
                retrieval = dataclasses.replace(retrieval, nprobe=esc)
                rec, probed_q = _ivf_probe_recall_sharded(
                    index, probe, esc, spec.d2, probe_budget(esc))
                print(f"wave {wave}: ivf recall below SLO -> nprobe "
                      f"escalated to {esc}/{index.n_clusters} "
                      f"(recall {rec:.3f}, probed/q={probed_q:.1f})")
            ee_note = ""
            if args.early_exit:
                qids_p, qrep_p, kk, (ve, ie) = probe
                va, ia, probed = rt.search_early_exit_sharded(
                    index, qrep_p, kk, retrieval.nprobe, spec.d2,
                    self_ids=qids_p,
                    local_budget=probe_budget(retrieval.nprobe))
                ee_note = (f" probed/q={float(probed.float().mean()):.1f}/"
                           f"{retrieval.nprobe} (early-exit recall "
                           f"{rt.recall_at_k(ia, ie, va, ve):.3f})")
            recalls.append(rec)
            ivf_note = (f" | ivf recall@{sst.k}={rec:.3f} "
                        f"nprobe={retrieval.nprobe} probed/q={probed_q:.1f} "
                        f"cellskew={cskew:.2f}" + ee_note)

        _sync_mesh(mesh)
        side_ms.append(side.ms - side0)
        wave_ms.append((time.perf_counter() - t_wave) * 1e3 - side_ms[-1])
        fills = sst.n_valid
        rebal = policy.should_rebalance(pol, rspec, snap.shard_skew)
        print(f"wave {wave}: gen {pol.generation} U={len(id_shard)} "
              f"shards[{min(fills)}..{max(fills)}]/cap{sst.capacity} "
              f"predict {args.requests}x{args.batch} pairs {ps.brief()} | "
              f"top-{args.topn} {ts_.brief()} | mae={snap.mae:.4f} "
              f"cov={snap.coverage_ratio:.2f} fold={snap.foldin_frac:.2f} "
              f"skew={snap.shard_skew:.2f} | bit-identical: {bool(same)}"
              + ivf_note + f" | wave {wave_ms[-1]:.1f}ms (+{side_ms[-1]:.1f}"
              "ms shadow and checks)"
              + (" | shard skew breach: repack at next swap" if rebal else "")
              + (f" | breach: {'; '.join(reasons)}" if reasons else ""))

    # ---- replay report ---------------------------------------------------
    counts = buckets.geometry_counts()
    budget = len(caps_sh) + len(caps_lo)  # sharded + shadow buckets
    print(f"geometries per request-path family: {counts} (per-shard "
          f"buckets: {sorted(caps_sh)}, shadow buckets: {sorted(caps_lo)})")
    assert max(counts.values()) <= budget, (
        f"geometry count {counts} exceeds bucket budget {budget}: the "
        "sharded steps must run at one geometry per (capacity, batch)")
    print(f"predictions bit-identical to the single-device run: "
          f"{identical_waves}/{args.waves} waves")
    print(f"launches beside the mesh path (shadow replay, oracle, checks): "
          f"{dict(sorted(side.launches.items()))} in {side.ms:.1f}ms; "
          f"mesh path: {mesh_fits} fit(s), {mesh_fold_batches} fold-in "
          f"batches over {n_shards} shards")
    assert identical_waves == args.waves
    if pre_post is not None:
        mae_pre, mae_post = pre_post
        print(f"refresh: fired gen {pol.generation} at wave {swap_wave}, "
              f"holdout MAE {mae_pre:.4f} -> {mae_post:.4f}")
        assert mae_post <= mae_pre + 1e-6, (
            "refresh must not degrade holdout MAE on the drifting stream")
    else:
        print("refresh: never fired (stream did not drift past thresholds)")
        if args.smoke:
            raise AssertionError(
                "sharded smoke replay must exercise a distributed refresh; "
                "tune --drift/--waves or the smoke RefreshSpec")
    if use_ivf:
        print(f"ivf retrieval (sharded): recall@k per wave "
              f"{[f'{r:.3f}' for r in recalls]} (mean "
              f"{np.mean(recalls):.3f}, SLO {IVF_RECALL_SLO}) ending at "
              f"nprobe={retrieval.nprobe}/{index.n_clusters}")
        if args.smoke:
            assert np.mean(recalls) >= IVF_RECALL_SLO, (
                f"sharded ivf smoke recall {np.mean(recalls):.3f} < "
                f"{IVF_RECALL_SLO}")
    if o is not None:
        from ..retrieval import publish_retrieval

        obslib.publish_compile_counts(o.registry)
        if use_ivf:
            publish_retrieval(
                o.registry, nprobe=retrieval.nprobe,
                clusters=index.n_clusters,
                recall=(float(np.mean(recalls)) if recalls
                        else float("nan")),
                early_exit=bool(args.early_exit), probes=len(recalls))
        else:
            publish_retrieval(o.registry)
        _export_obs(o, args)
    blocks = sst.ratings + sst.representation + sst.row_rank + [
        t for g in sst.graph for t in (g.indices, g.weights)]
    print("cf sharded lifecycle: done")
    return dict(
        mesh=mesh.describe(), shards=n_shards, waves=args.waves,
        identical_waves=identical_waves, swap_wave=swap_wave,
        refreshed=pre_post is not None, wave_ms=wave_ms, side_ms=side_ms,
        side_launches=dict(side.launches), mesh_fits=mesh_fits,
        mesh_fold_batches=mesh_fold_batches,
        block_devices=sorted({str(b.device) for b in blocks}),
        row_shards=landmark_state_meta(ckpt_dir)["row_shards"],
        ckpt=ckpt_dir, recalls=recalls, geometries=counts)


# ----------------------------------------------------- cf engine, sharded
def _log_writes(backend, log) -> None:
    """Record every write the backend takes, in the order it takes them,
    as ``(method name, args)``: the write lane is one FIFO thread and the
    warm-up writes run before it starts, so a one-device shadow fed the
    log sees the mesh's writes in the mesh's order."""
    for name in ("fold_in", "apply_update", "apply_remove"):
        fn = getattr(backend, name, None)
        if fn is None:
            continue

        def call(*a, _fn=fn, _name=name):
            log.append((_name, a))
            return _fn(*a)

        setattr(backend, name, call)


def _router_checks(backend, st, spec, ecfg, args, local_cls):
    """The router's two one-time checks on the published state: no routed
    read builds a row-space tensor (``router.materialization_check``), and
    routed reads at every batch shape are bitwise a one-device backend's
    (``local_cls``: with ``--mutations`` the mutable read path, whose
    tombstone operand the routed reads also take)."""
    from ..lifecycle import buckets
    from ..serving import router

    pub = backend.snapshot()
    sst = backend.sharded_state(pub[0])
    rows = sst.shard_count * sst.capacity
    b_chk = router.check_batch(sst, ecfg.max_batch)
    n_t, bad = router.materialization_check(sst, b_chk, args.topn,
                                            tomb=backend.read_tomb(pub[0]))
    print(f"router materialization check: {n_t} tensors scanned, "
          f"{len(bad)} offenders (batch {b_chk}, S*C={rows} rows)")
    if bad:
        raise AssertionError(f"the router built row-space tensors: "
                             f"{bad[:4]}")
    ref = local_cls(buckets.from_state(st, args.min_bucket, args.growth),
                    spec, min_bucket=args.min_bucket, growth=args.growth)
    rpub = ref.snapshot()
    rng = np.random.default_rng(5)
    same = True
    for b in ecfg.batch_shapes():
        pu = rng.integers(0, args.users, b)
        pi = rng.integers(0, args.items, b)
        same &= np.array_equal(backend.predict_pairs(pub, pu, pi),
                               ref.predict_pairs(rpub, pu, pi))
        got, want = (backend.recommend_topn(pub, pu, args.topn),
                     ref.recommend_topn(rpub, pu, args.topn))
        same &= all(np.array_equal(g, w) for g, w in zip(got, want))
    shapes = "/".join(str(b) for b in ecfg.batch_shapes())
    print(f"routed vs single-device reference ({shapes} queries): "
          f"bit-identical={same}")
    if not same:
        raise AssertionError("routed reads diverged from the single-device "
                             "reference")
    return dict(router_tensors=n_t, router_offenders=len(bad),
                router_batch=b_chk, routed_bitwise=bool(same),
                routed_shapes=list(ecfg.batch_shapes()))


def _mesh_citations(msst):
    """(neighbor entries of live rows that cite a tombstoned or unfilled
    row with a nonzero weight, live rows checked) of a mutable sharded
    state."""
    c = msst.capacity
    tomb = msst.tomb.cpu().numpy()
    fill = msst.fill_mask()
    gone = tomb | ~fill
    cites = rows = 0
    for s, g in enumerate(msst.sstate.graph):
        live = (fill & ~tomb)[s * c:(s + 1) * c]
        gi = g.indices.cpu().numpy().astype(np.int64)
        gw = g.weights.cpu().numpy()
        cites += int((gone[gi] & (gw != 0))[live].sum())
        rows += int(live.sum())
    return cites, rows


def _shadow_replay(st, spec, args, log):
    """A one-device ``MutableLocalBackend`` from the same fitted state, fed
    the mesh backend's logged writes in order."""
    from ..lifecycle import buckets
    from ..serving import MutableLocalBackend

    shadow = MutableLocalBackend(
        buckets.from_state(st, args.min_bucket, args.growth), spec,
        min_bucket=args.min_bucket, growth=args.growth)
    for name, a in log:
        getattr(shadow, name)(*a)
    return shadow


def _shadow_compare(backend, shadow, table, ecfg, args):
    """Pair predictions and top-N of up to 256 live users (seeded draw) on
    the mesh backend and on its one-device shadow, bitwise. ``table`` is
    the shadow's old -> new row-id table after a compacting refresh (the
    mesh keeps its logical ids), None before one."""
    n = backend.n_users
    live = (np.flatnonzero(~backend.tomb()[:n]) if table is None
            else np.flatnonzero(table[:n] >= 0))
    rng = np.random.default_rng(23)
    users = rng.choice(live, size=min(256, len(live)), replace=False)
    ids = users if table is None else table[users]
    pub, spub = backend.snapshot(), shadow.snapshot()
    b = ecfg.max_batch
    same = True
    for lo in range(0, len(users), b):
        m = len(users[lo:lo + b])
        u, su, it = (np.zeros(b, np.int64) for _ in range(3))
        u[:m], su[:m] = users[lo:lo + b], ids[lo:lo + b]
        it[:m] = rng.integers(0, args.items, m)
        same &= np.array_equal(backend.predict_pairs(pub, u, it)[:m],
                               shadow.predict_pairs(spub, su, it)[:m])
        got = backend.recommend_topn(pub, u, args.topn)
        want = shadow.recommend_topn(spub, su, args.topn)
        same &= all(np.array_equal(g[:m], w[:m]) for g, w in zip(got, want))
    return dict(users=int(len(users)), bitwise=bool(same))


@contextlib.contextmanager
def _beside(side):
    """``side()`` with the recorded read geometries kept as they were
    before the block: the one-device shadow's reads are not the mesh
    path's, and the geometry budget holds the mesh path alone."""
    from ..lifecycle import buckets

    saved = {k: set(v) for k, v in buckets.GEOMETRIES.items()}
    with side():
        yield
    buckets.GEOMETRIES.clear()
    buckets.GEOMETRIES.update(saved)


def _print_shadow(mesh_stats):
    before = mesh_stats["shadow_before"]
    after = mesh_stats.get("shadow_after")
    print(f"mesh vs one-device shadow (the same writes in the same order): "
          f"{before['users']} live users' pairs and top-N "
          f"bit-identical={before['bitwise']} before compaction"
          + (f", {after['users']} after compaction "
             f"bit-identical={after['bitwise']}" if after
             else ", no compaction in this run"))
    if not before["bitwise"] or (after and not after["bitwise"]):
        raise AssertionError("the mesh's reads diverged from its one-device "
                             "shadow")


# ------------------------------------------------------------------ cf engine
def _serve_cf_engine(args):
    """Open-loop serving through the request engine: continuous
    micro-batching over the bucketed state, bounded admission with load
    shedding, and an async fold-in lane on a CUDA stream of its own. A load
    generator drives mixed pair/top-N/fold traffic at ``--rate`` requests/s
    (0: twice the closed-loop capacity) for ``--duration`` seconds; the run
    reports sustained QPS, p50/p95/p99 and the shed fraction, re-runs a
    sample of the reads alone (bitwise), and checks that the read
    geometries stay within |batch shapes| x |capacities used|. ``--smoke``
    also holds the SLOs under load: QPS > 0, read p95 within the SLO, at
    least one fold, recall >= 0.95 with ``--retrieval ivf``; with
    ``--mutations`` also at least one update and one removal. With
    ``--mutations`` the run also holds the pre-compaction bar (no live row
    cites a deleted row, no dirty row published).

    ``--mesh pod=P,data=D`` serves the same traffic from a sharded state
    (``ShardedBackend`` / ``MutableShardedBackend``: reads through the query
    router, writes on the owner shards) with a 2000 ms SLO. It proves the
    router builds no row-space tensor, holds the routed reads bitwise to the
    one-device backend's at every batch shape, and, with ``--mutations``,
    replays the window's writes in order into a one-device
    ``MutableLocalBackend`` shadow whose reads of a sample of live users
    must be the mesh's bits before and after the compacting refresh. The
    shadow's and the checks' kernel launches are tallied apart
    (``side_launches``). Returns the engine's stats with the run's
    figures."""
    from ..kernels import ops
    from ..lifecycle import buckets, monitor, policy
    from ..serving import (EngineConfig, LocalBackend, MutableLocalBackend,
                           MutableShardedBackend, RequestEngine,
                           ShardedBackend, histogram_latency)

    device = torch.device(args.device)
    sharded = bool(args.mesh)
    if sharded:
        from .mesh import make_mesh

        names, sizes = _parse_mesh(args.mesh)
        mesh = make_mesh(names, sizes, device)
        print(f"mesh {mesh.describe()}")
    spec = cfg.SMOKE if args.smoke else cfg.MODEL
    spec = dataclasses.replace(spec, selection=args.selection)
    if args.smoke:
        _clamp_lifecycle_smoke(args)
        args.duration = min(args.duration, 4.0)
    rng = np.random.default_rng(0)
    n0 = args.users  # load targets the base population: valid in every gen
    mutations = bool(args.mutations)
    if mutations:
        rspec = cfg.SMOKE_REFRESH if args.smoke else cfg.REFRESH
        if args.smoke:
            # a smoke-length window deletes only a few percent of the base
            # population: drop the compaction gate so the smoke still
            # exercises the policy-fired, tombstone-compacting refresh
            rspec = dataclasses.replace(rspec, max_tombstone_frac=0.01)

    r0 = _synth_ratings(rng, args.users, args.items, device)
    t0 = time.perf_counter()
    st = fit(RatingMatrix(r0, args.users, args.items), spec,
             generator=torch.Generator().manual_seed(0))
    _sync(device)
    print(f"fit U={args.users} P={args.items} n={spec.n_landmarks} "
          f"k={st.graph.k} on {device}: "
          f"{(time.perf_counter() - t0) * 1e3:.0f}ms")

    # a read on the mesh gathers its rows from every shard's blocks on the
    # host's schedule: its SLO is the reference's mesh SLO
    ecfg = EngineConfig(max_batch=args.batch, min_shape=min(32, args.batch),
                        queue_cap=args.batch * 8, max_wait_ms=2.0,
                        slo_ms=2000.0 if sharded else 250.0,
                        fold_bq=args.foldin, topn=args.topn)
    local_cls = MutableLocalBackend if mutations else LocalBackend
    mesh_stats, write_log = {}, []
    if sharded:
        side = _SideTally(mesh)  # the checks' and the shadow's share
        n_shards = mesh.size
        min_shard_bucket = max(8, args.min_bucket // n_shards)
        sst = buckets.from_state_sharded(st, mesh, names, min_shard_bucket,
                                         args.growth)
        u_per = -(-args.users // n_shards)
        backend = (MutableShardedBackend if mutations else ShardedBackend)(
            sst, np.arange(args.users) // u_per, np.arange(args.users) % u_per,
            spec, min_bucket=min_shard_bucket, growth=args.growth,
            warm_shapes=ecfg.batch_shapes(), warm_topn=args.topn)
        _log_writes(backend, write_log)
        with side():
            mesh_stats = _router_checks(backend, st, spec, ecfg, args,
                                        local_cls)
    else:
        backend = local_cls(buckets.from_state(st, args.min_bucket,
                                               args.growth),
                            spec, min_bucket=args.min_bucket,
                            growth=args.growth,
                            warm_shapes=ecfg.batch_shapes(),
                            warm_topn=args.topn)
    buckets.reset_geometries()  # the run's geometries, warm-up included

    # optional IVF sidecar: retrieval health probed while the engine is
    # under load (index maintenance itself rides the lifecycle loop)
    use_ivf = args.retrieval == "ivf"
    recalls, probeds, ee_recalls = [], [], []
    if use_ivf:
        from .. import retrieval as rt

        user_ivf = rt.IVFSpec(n_clusters=args.clusters or None,
                              nprobe=args.nprobe or None)
        if sharded:
            # cells block-partitioned over the shards, probes routed to
            # their owners, (b, k) lists merged on shard 0
            retrieval = rt.resolve_ivf_sharded(user_ivf, n0, n_shards)
        else:
            retrieval = rt.resolve_ivf(user_ivf, n0)
        if args.smoke and not args.nprobe:
            # the lifecycle replays' smoke-scale bump
            retrieval = dataclasses.replace(
                retrieval,
                nprobe=max(retrieval.nprobe, retrieval.n_clusters // 2))
        if sharded:
            index = rt.build_index_sharded(st.representation, retrieval,
                                           mesh, names, spec.d2)
        else:
            index = rt.build_index(st.representation, retrieval, spec.d2)
        kk = st.graph.k
        qids0 = _ids(rng, n0, min(args.batch, n0), device)
        qrep0 = st.representation[qids0.long()]
        if sharded:
            ve, ie, _ = rt.search_sharded(index, qrep0, kk, index.n_clusters,
                                          spec.d2, self_ids=qids0)
        else:
            ve, ie = rt.search(index, qrep0, kk, index.n_clusters, spec.d2,
                               self_ids=qids0)

        def recall_probe():
            """(SLO recall, mean probed/q, early-exit recall or None). The
            SLO is judged on the full-budget search; early exit rides atop
            the escalated budget and is reported, not gated. On the mesh a
            shard scores at most 2·ceil(nprobe/S) of its probed cells."""
            np_ = retrieval.nprobe
            ee, probed = None, float(np_)
            if sharded:
                lb = min(np_, max(1, 2 * (-(-np_ // n_shards))))
                va, ia, pq = rt.search_sharded(
                    index, qrep0, kk, np_, spec.d2, self_ids=qids0,
                    local_budget=lb)
                probed = float(pq.float().mean())
            else:
                va, ia = rt.search(index, qrep0, kk, np_, spec.d2,
                                   self_ids=qids0)
            rec = rt.recall_at_k(ia, ie, va, ve)
            if args.early_exit:
                if sharded:
                    ev, ei, pq = rt.search_early_exit_sharded(
                        index, qrep0, kk, np_, spec.d2, self_ids=qids0,
                        local_budget=lb)
                else:
                    ev, ei, pq = rt.search_early_exit(
                        index, qrep0, kk, np_, spec.d2, self_ids=qids0)
                ee = rt.recall_at_k(ei, ie, ev, ve)
                probed = float(pq.float().mean())
            return rec, probed, ee

        esc_count = 0
        rec0, _pq, _ee = recall_probe()
        while rec0 < IVF_RECALL_SLO and retrieval.nprobe < index.n_clusters:
            esc = min(index.n_clusters, max(retrieval.nprobe + 1,
                                            (retrieval.nprobe * 3) // 2))
            retrieval = dataclasses.replace(retrieval, nprobe=esc)
            esc_count += 1
            rec0, _pq, _ee = recall_probe()
        print(f"retrieval: {'sharded ' if sharded else ''}ivf "
              f"C={index.n_clusters} nprobe={retrieval.nprobe} "
              f"pre-load recall@{kk}={rec0:.3f}")

    o = None
    if args.trace_dir or args.metrics_json or args.torch_profile:
        o = obslib.Observability(sample_rate=args.sample_rate, seed=0)
        obslib.install(o)
    if o is not None and not mutations:
        # lifecycle feed: withhold a holdout slice from each fold batch, so
        # the exported lifecycle series carries a real holdout MAE
        obs_rspec = cfg.SMOKE_REFRESH if args.smoke else cfg.REFRESH
        obs_cov = monitor.batch_coverage(st.representation,
                                         torch.ones(n0, device=device))
        obs_mon = monitor.init_monitor(obs_rspec.reservoir, n0, obs_cov,
                                       device)
        obs_gen = torch.Generator().manual_seed(17)  # reservoir draws
    if mutations:
        # the engine-fed drift monitor: reservoir, fold-in volume and
        # tombstone fraction accumulate from live engine traffic in the
        # load loop; the policy's verdict is taken once the window drains
        # (writes are async: a mid-window refresh would renumber rows under
        # queued folds)
        base_cov = monitor.batch_coverage(st.representation,
                                          torch.ones(n0, device=device))
        mon = monitor.init_monitor(rspec.reservoir, n0, base_cov, device)
        pol = policy.PolicyState(generation=backend.generation)
        mgen = torch.Generator().manual_seed(11)  # reservoir draws
        alive = np.ones(n0, bool)  # host view of not-yet-deleted base users
        removed_ids = []

        def _drift_snapshot():
            if sharded:
                msst, id_shard, id_slot, _ = backend.snapshot()
                return monitor.holdout_snapshot_sharded(
                    mon, msst.sstate, id_shard * msst.capacity + id_slot,
                    tomb=msst.tomb, tombstone_frac=backend.tombstone_frac)
            mst = backend.snapshot()[0]
            return monitor.holdout_snapshot(
                mon, mst.bstate, tomb=mst.tomb,
                tombstone_frac=backend.tombstone_frac)

        def _remap_reservoir(mon, table):
            """Renumber the reservoir's triples across a swap; deleted
            users' withheld ratings leave the holdout with them."""
            filled = mon.res_filled
            ru = mon.res_users[:filled].cpu().numpy()
            nu = table[ru]
            keep = nu >= 0
            pad = mon.reservoir_size - int(keep.sum())

            def kept(src, dt):
                return torch.as_tensor(np.concatenate(
                    [src[keep].astype(dt), np.zeros(pad, dt)]),
                    device=device)

            return dataclasses.replace(
                mon, res_users=kept(nu, np.int32),
                res_items=kept(mon.res_items[:filled].cpu().numpy(),
                               np.int32),
                res_ratings=kept(mon.res_ratings[:filled].cpu().numpy(),
                                 np.float32),
                res_filled=int(keep.sum()))

    eng = RequestEngine(backend, ecfg, clock=time.perf_counter, obs=o)
    # warm every (batch shape, kind) — the geometry budget the run is held
    # to (x capacities used; folds may grow the bucket once)
    pub = backend.snapshot()
    for s in ecfg.batch_shapes():
        z = np.zeros(s, np.int64)
        backend.predict_pairs(pub, z, z)
        backend.recommend_topn(pub, z, args.topn)
    # warm the fold lane outside the timed window: the first fold pays its
    # allocations and the regrown capacity's read warm-up
    backend.fold_in(_synth_ratings(rng, args.foldin, args.items,
                                   "cpu").numpy(), ecfg.fold_bq)
    pub = backend.snapshot()
    if mutations:
        # warm the write lane itself, after the fold warm-up (which crosses
        # the bucket boundary) so it runs at the capacity the window's
        # writes run at: a self-update (rows rewritten with their current
        # values) runs the update, the repair rescan and the publish, and a
        # zero-valid removal the tombstone scatter
        warm_ids = np.arange(8)
        if sharded:
            from ..distributed.sharding import gather_rows

            msst = pub[0]
            warm_rows = gather_rows(msst.sstate.ratings,
                                    backend.sharded_ids(pub, warm_ids),
                                    msst.capacity, msst.home)
        else:
            warm_rows = pub[0].bstate.state.ratings[torch.as_tensor(
                warm_ids, device=device)]
        backend.apply_update(warm_ids, warm_rows.cpu().numpy())
        backend.apply_remove(np.zeros(0, np.int64))
        pub = backend.snapshot()

    # closed-loop synchronous baseline: one padded call per request, each
    # waiting for the previous; its capacity anchors the auto rate
    rq = np.random.default_rng(7)
    svc = []
    for _ in range(24):
        m = int(rq.integers(4, 17))
        u = np.zeros(ecfg.pad_shape(m), np.int64)
        u[:m] = rq.integers(0, n0, m)
        it = np.zeros_like(u)
        it[:m] = rq.integers(0, args.items, m)
        t0 = time.perf_counter()
        backend.predict_pairs(pub, u, it)
        svc.append(time.perf_counter() - t0)
    sync = latency_stats(svc)
    sync_qps = 1.0 / float(np.mean(svc))
    rate = args.rate if args.rate > 0 else 2.0 * sync_qps
    print(f"sync baseline: {sync_qps:.0f} req/s closed-loop "
          f"({sync.brief()}) -> open-loop target {rate:.0f} req/s")

    fold_batches = [_synth_ratings(rq, args.foldin, args.items, "cpu").numpy()
                    for _ in range(4)]
    reqs = []
    with obslib.profile_trace(args.torch_profile):
        eng.start()
        try:
            t_start = time.perf_counter()
            t_stop = t_start + args.duration
            next_arr = t_start
            fold_every = args.duration / 3.0
            next_fold = t_start + fold_every * 0.6
            next_probe = t_start + args.duration / 6.0
            next_pub = t_start + 0.5  # registry publish cadence (obs only)
            folds_sent = 0
            next_start = backend.n_users  # logical id of the next folded row
            mut_every = args.duration / 4.0
            next_mut = t_start + mut_every * 0.4
            mut_wave = 0
            while True:
                now = time.perf_counter()
                if now >= t_stop:
                    break
                if mutations and now >= next_mut:
                    # a deterministic event wave (re-rate / un-rate / delete)
                    # against still-live base users, on the write lane
                    # beside the folds; checked before arrivals, which at a
                    # saturating rate never yield otherwise. Waves stay <= 8
                    # events: every batch pads to the one warmed shape
                    ev = synthetic.mutation_events(
                        13, mut_wave, n0, args.items,
                        n_events=min(8, max(2, n0 // 8)), rerate_frac=0.3,
                        unrate_frac=0.2, delete_frac=0.5)
                    mut_wave += 1
                    sel = alive[ev["users"]]
                    upd = sel & (ev["kinds"] != 2)
                    rem = sel & (ev["kinds"] == 2)
                    if upd.any():
                        r = eng.submit("update", users=ev["users"][upd],
                                       rows=ev["rows"][upd])
                        if r is not None:
                            reqs.append(r)
                    if rem.any():
                        r = eng.submit("remove", users=ev["users"][rem])
                        if r is not None:
                            reqs.append(r)
                            alive[ev["users"][rem]] = False
                            removed_ids.extend(int(u)
                                               for u in ev["users"][rem])
                    next_mut += mut_every
                    continue
                if now >= next_arr:
                    m = int(rq.integers(4, 17))
                    uu = rq.integers(0, n0, m)
                    if rq.random() < 0.15:
                        r = eng.submit("topn", users=uu)
                    else:
                        r = eng.submit("pair", users=uu,
                                       items=rq.integers(0, args.items, m))
                    if r is not None:
                        reqs.append(r)
                    next_arr += rq.exponential(1.0 / rate)
                    continue
                if now >= next_fold and folds_sent < len(fold_batches):
                    if mutations:
                        # withhold a holdout slice for the drift reservoir;
                        # logical ids follow append order (the write lane
                        # is FIFO)
                        train, hrows, hcols, hvals = _withhold(
                            rq, fold_batches[folds_sent],
                            rspec.holdout_frac)
                        eng.submit("fold", rows=train)
                        mon = _offer_holdout(mon, rng, mgen, next_start,
                                             hrows, hcols, hvals,
                                             rspec.reservoir)
                        mon = monitor.observe_fold_in(
                            mon, ops.masked_similarity(
                                torch.as_tensor(train, device=device),
                                backend.snapshot()[0].landmarks, spec.d1),
                            len(train))
                        next_start += len(train)
                    elif o is not None:
                        train, hrows, hcols, hvals = _withhold(
                            rq, fold_batches[folds_sent],
                            obs_rspec.holdout_frac)
                        eng.submit("fold", rows=train)
                        obs_mon = _offer_holdout(
                            obs_mon, rng, obs_gen, next_start, hrows, hcols,
                            hvals, obs_rspec.reservoir)
                        next_start += len(train)
                    else:
                        eng.submit("fold", rows=fold_batches[folds_sent])
                    folds_sent += 1
                    next_fold += fold_every
                    continue
                if use_ivf and now >= next_probe:
                    # retrieval health under load, launched under the
                    # engine's exec_lock like a read batch
                    with eng.exec_lock:
                        rec, pq, ee = recall_probe()
                    recalls.append(rec)
                    probeds.append(pq)
                    if ee is not None:
                        ee_recalls.append(ee)
                    next_probe += args.duration / 6.0
                    continue
                if o is not None and now >= next_pub:
                    # periodic publish: mid-window snapshots see live queue
                    # depth and latency series, not just the final state
                    eng.publish_metrics()
                    next_pub += 0.5
                    continue
                time.sleep(min(0.0005, max(0.0, next_arr - now)))
            for r in reqs:  # drain: every admitted request must complete
                if not r.done.wait(timeout=60.0):
                    raise RuntimeError("admitted request never completed")
        finally:
            eng.stop()
    t_last = max([r.t_done for r in reqs] or [t_start])
    if args.torch_profile:
        print(f"obs: torch.profiler trace of the load window -> "
              f"{os.path.join(args.torch_profile, obslib.profile.TRACE_NAME)}")

    # post-run bitwise audit against the final generation, solo replay
    for _ in range(8):
        m = int(rq.integers(1, 17))
        uu = rq.integers(0, backend.n_users, m)
        eng.submit("pair", users=uu, items=rq.integers(0, args.items, m))
        eng.submit("topn", users=uu)
    eng.pump_reads()
    checked, bad = eng.verify_sample(limit=16)

    stats = eng.stats()
    elapsed = max(t_last - t_start, 1e-9)
    sustained_qps = stats["reads_completed"] / elapsed
    rl = stats["read_latency"]
    print(f"engine: sustained {sustained_qps:.0f} QPS over {elapsed:.1f}s "
          f"({stats['reads_completed']} reads in {stats['batches']} batches, "
          f"mean {stats['mean_batch_rows']:.1f} rows, "
          f"pad {stats['pad_frac']:.0%})")
    print(f"latency under load: {rl.brief()} | admission: "
          f"shed_frac={stats['shed_frac']:.3f} "
          f"(queue_cap={ecfg.queue_cap} rows)")
    print(f"fold lane: {stats['completed']['fold']} batches "
          f"(+{stats['folded_rows']} users -> gen {stats['generation']}, "
          f"U={backend.n_users}) fold {stats['fold_latency'].brief()} — "
          f"reads never waited on a write")
    if sharded:
        mesh_stats["fold_batches"] = sum(
            -(-len(a[0]) // a[1]) for name, a in write_log
            if name == "fold_in")
        mesh_stats["updates"] = sum(name == "apply_update"
                                    for name, _ in write_log)
    mut = {}
    if mutations:
        print(f"write lane: {mut_wave} event waves -> "
              f"updates={stats['completed']['update']} "
              f"removes={stats['completed']['remove']} "
              f"(mutated_rows={stats['mutated_rows']}, "
              f"repaired_rows={stats['repaired_rows']}, "
              f"tombstone_frac={stats['tombstone_frac']:.3f})")
        # the pre-compaction bar: no live row cites a deleted row, and no
        # generation was published with an unrepaired row
        mst = backend.snapshot()[0]
        if sharded:
            cites_dead, n_live_rows = _mesh_citations(mst)
        else:
            g = mst.bstate.state.graph
            tombv = mst.tomb.cpu().numpy()
            gi, gw = g.indices.cpu().numpy(), g.weights.cpu().numpy()
            live = (np.arange(len(tombv)) < mst.n_valid) & ~tombv
            cites_dead = int((tombv[gi] & (gw != 0))[live].sum())
            n_live_rows = int(live.sum())
        dirty = mst.dirty_count()
        if cites_dead or dirty:
            raise AssertionError(f"pre-compaction bar: {cites_dead} "
                                 f"citations of tombstoned rows, {dirty} "
                                 f"unrepaired rows published")
        snap = _drift_snapshot()
        if o is not None:
            monitor.publish_snapshot(o.registry, snap)
        if (math.isnan(pol.base_mae)
                and snap.holdout_count >= rspec.min_holdout):
            pol.base_mae = snap.mae
        fire, reasons = policy.decide(pol, rspec, snap)
        compact = policy.should_compact_tombstones(rspec, snap.tombstone_frac)
        print(f"drift monitor: mae={snap.mae:.3f} "
              f"holdout={snap.holdout_count} "
              f"foldin_frac={snap.foldin_frac:.2f} "
              f"tombstone_frac={snap.tombstone_frac:.3f} -> fire={fire} "
              f"({','.join(reasons) if reasons else 'healthy'}) "
              f"compact={compact}")
        if sharded:
            with _beside(side):
                shadow = _shadow_replay(st, spec, args, write_log)
                mesh_stats["shadow_before"] = _shadow_compare(
                    backend, shadow, None, ecfg, args)
        mut = dict(waves=mut_wave, removed=len(removed_ids),
                   live_rows_checked=n_live_rows, cites_dead=cites_dead,
                   dirty_published=dirty, fire=fire, compact=compact,
                   write_latency={k: histogram_latency(eng.latencies[k])
                                  for k in ("update", "remove", "fold")})
        if fire or compact:
            if fire:
                policy.on_fire(pol)
            n_pre = backend.n_users
            with eng.exec_lock:
                gen_new, table = backend.refresh()
            mon = _remap_reservoir(mon, table)
            post = _drift_snapshot()
            if o is not None:
                monitor.publish_snapshot(o.registry, post)
            policy.on_swap(pol, gen_new, post.mae, rspec)
            compacted = int(np.sum(table[:n_pre] < 0))
            print(f"refresh swap: gen {gen_new}, compacted {compacted} "
                  f"tombstones, post-swap mae={post.mae:.3f} "
                  f"tombstone_frac={post.tombstone_frac:.3f}")
            if backend.tombstone_frac != 0.0:
                raise AssertionError("compaction left tombstones")
            mut.update(swap_gen=gen_new, compacted=compacted,
                       post_tombstone_frac=post.tombstone_frac)
            if sharded:
                cites, _ = _mesh_citations(backend.snapshot()[0])
                if cites:
                    raise AssertionError(f"after compaction {cites} live "
                                         f"rows cite a removed row")
                with _beside(side):
                    _, shadow_table = shadow.refresh()
                    mesh_stats["shadow_after"] = _shadow_compare(
                        backend, shadow, shadow_table, ecfg, args)
        if sharded:
            _print_shadow(mesh_stats)
    print(f"bitwise vs solo replay: {checked} requests re-run, "
          f"{bad} mismatches | non-finite predictions: {stats['nonfinite']}")
    caps = sorted(backend.caps_used)
    geo = buckets.geometry_counts()
    counts = {k: geo.get(k, 0) for k in ("pair", "topn")}
    budget = len(ecfg.batch_shapes()) * len(caps)
    print(f"geometries per request-path family: {counts} "
          f"(budget {budget}: {len(ecfg.batch_shapes())} batch shapes x "
          f"buckets {caps})")
    if max(counts.values()) > budget:
        raise AssertionError(f"geometry count {counts} exceeds the shapes x "
                             f"buckets budget {budget}")
    if use_ivf:
        ee_note = (f" early-exit recall {np.mean(ee_recalls):.3f}"
                   if ee_recalls else "")
        print(f"ivf under load: {len(recalls)} probes, recall@{kk} "
              f"{[f'{r:.3f}' for r in recalls]} "
              f"probed/q={np.mean(probeds):.1f}/{retrieval.nprobe}{ee_note}"
              if recalls else "ivf under load: window too short for probes")
    if o is not None:
        # final registry state: engine counters/histograms, per-family
        # geometry growth, the retrieval series (exact-mode when no index
        # is up), and the lifecycle holdout snapshot — one export carries
        # all three groups
        from ..retrieval import publish_retrieval

        eng.publish_metrics()
        obslib.publish_compile_counts(o.registry)
        if use_ivf:
            publish_retrieval(
                o.registry, nprobe=retrieval.nprobe,
                clusters=index.n_clusters,
                probed_per_q=(float(np.mean(probeds)) if probeds
                              else float(retrieval.nprobe)),
                recall=(float(np.mean(recalls)) if recalls else rec0),
                early_exit=bool(args.early_exit),
                escalations=esc_count, probes=len(recalls))
        else:
            publish_retrieval(o.registry)
        if not mutations:
            if sharded:
                osst, oshard, oslot, _ = backend.snapshot()
                snap = monitor.holdout_snapshot_sharded(
                    obs_mon, osst, oshard * osst.capacity + oslot)
            else:
                snap = monitor.holdout_snapshot(obs_mon,
                                                backend.snapshot()[0])
            monitor.publish_snapshot(o.registry, snap)
        _export_obs(o, args)
    if bad:
        raise AssertionError("micro-batched results diverged from solo "
                             "execution")
    if stats["nonfinite"]:
        raise AssertionError("non-finite predictions under load")
    if args.smoke:
        if not sustained_qps > 0:
            raise AssertionError("engine completed no reads under load")
        if not (rl.count > 0 and rl.p95_ms <= ecfg.slo_ms):
            raise AssertionError(f"read p95 {rl.p95_ms:.1f}ms breached the "
                                 f"{ecfg.slo_ms:.0f}ms SLO under load")
        if stats["completed"]["fold"] < 1:
            raise AssertionError("smoke run must exercise the fold lane")
        if mutations and not (stats["completed"]["update"] >= 1
                              and stats["completed"]["remove"] >= 1):
            raise AssertionError("smoke run drained no update or no removal")
        if mutations and not (removed_ids and stats["tombstone_frac"] > 0):
            raise AssertionError("mutation stream produced no tombstones")
        if use_ivf and not (recalls
                            and np.mean(recalls) >= IVF_RECALL_SLO):
            raise AssertionError(
                f"ivf recall under load "
                f"{np.mean(recalls) if recalls else float('nan'):.3f} "
                f"< {IVF_RECALL_SLO}")
    if sharded:
        sst_final = backend.sharded_state(backend.snapshot()[0])
        mesh_stats.update(
            mesh=mesh.describe(), shards=n_shards,
            block_devices=sorted({str(b.device) for b in
                                  sst_final.ratings + sst_final.representation
                                  + [g.indices for g in sst_final.graph]}),
            capacity=sst_final.capacity,
            side_launches=dict(side.launches), side_ms=side.ms)
    print("cf engine: done")
    return dict(stats, qps=sustained_qps, elapsed_s=elapsed,
                checked=checked, mismatches=bad, geometries=counts,
                geometry_budget=budget, lane_ids=dict(eng.lane_ids),
                recalls=recalls, mutations=mut, mesh=mesh_stats)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve loops. lm: prefill + decode with the exact KV "
        "cache or landmark summaries. cf: load (or fit and checkpoint) an "
        "artifact, then waves of pair predictions and top-N "
        "recommendations with fold-ins between them; --lifecycle adds drift "
        "monitoring and background refresh, --retrieval ivf an IVF index; "
        "--engine serves open-loop traffic through the request engine.")
    ap.add_argument("--workload", choices=("lm", "cf"), default="lm")
    ap.add_argument("--smoke", action="store_true",
                    help="lm: the arch's smoke model; cf: smoke spec and "
                    "sizes (U<=512, P<=128, 2 waves; lifecycle: U<=256, "
                    "P<=96)")
    ap.add_argument("--batch", type=int, default=None,
                    help="lm: decode batch (default 4); cf: pairs/users per "
                    "request (default 256)")
    # lm flags
    ap.add_argument("--arch", default="smollm-360m",
                    choices=sorted(registry.ARCHS))
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--landmark", action="store_true",
                    help="lm: decode through O(n) landmark summaries")
    # cf flags
    ap.add_argument("--users", type=int, default=8192)
    ap.add_argument("--items", type=int, default=512)
    ap.add_argument("--waves", type=int, default=None,
                    help="request waves (default 3; lifecycle default 8)")
    ap.add_argument("--requests", type=int, default=32,
                    help="timed predict calls per wave")
    ap.add_argument("--foldin", type=int, default=64,
                    help="new users folded in between waves; in --lifecycle "
                    "mode, the fold-in batch bucket size")
    ap.add_argument("--topn", type=int, default=10)
    ap.add_argument("--ckpt", default=None,
                    help="artifact directory (fit and save there when it "
                    "holds none; default: a fresh temporary directory)")
    ap.add_argument("--graph-backend", default="auto",
                    choices=("auto", "dense", "streaming", "kernel", "ivf"))
    ap.add_argument("--lifecycle", action="store_true",
                    help="replay a drifting stream through the bucketed "
                    "fit->serve->monitor->refresh loop")
    ap.add_argument("--arrivals", type=int, default=64,
                    help="lifecycle: new users arriving per wave")
    ap.add_argument("--min-bucket", type=int, default=256,
                    help="lifecycle: smallest capacity on the bucket schedule")
    ap.add_argument("--growth", type=float, default=2.0,
                    help="lifecycle: geometric bucket growth factor")
    ap.add_argument("--drift", type=float, default=1.0,
                    help="lifecycle: preference drift strength of the stream")
    ap.add_argument("--selection", default="coresets",
                    choices=("random", "dist_ratings", "coresets",
                             "coresets_random", "popularity"),
                    help="lifecycle: landmark selection for fit AND refresh")
    ap.add_argument("--compact", action="store_true",
                    help="cf: store the artifact as uint16 ids + bf16 weights")
    ap.add_argument("--compact-serving", action="store_true",
                    help="lifecycle: after each refresh swap, serve (and "
                    "checkpoint) the compact uint16/bf16 graph while the "
                    "capacity fits uint16; widened back on growth "
                    "(lifecycle.policy.should_compact)")
    ap.add_argument("--retrieval", default="exact", choices=("exact", "ivf"),
                    help="lifecycle: neighbor retrieval of the serve path; "
                    "'ivf' keeps an IVF index over the landmark embedding "
                    "and reports recall@k against the exact search")
    ap.add_argument("--nprobe", type=int, default=0,
                    help="retrieval=ivf: probed cells per query "
                    "(0 = n_clusters/4; == n_clusters is exact)")
    ap.add_argument("--clusters", type=int, default=0,
                    help="retrieval=ivf: k-means cells (0 = ~sqrt(U))")
    ap.add_argument("--early-exit", action="store_true",
                    help="retrieval=ivf: per-query adaptive probing; wave "
                    "stats report probed cells per query")
    ap.add_argument("--engine", action="store_true",
                    help="cf: serve through the continuous micro-batching "
                    "request engine (open-loop load generator, admission "
                    "control, async fold-in lane on its own CUDA stream)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="engine: target arrival rate in requests/s (0 = "
                    "2x the measured closed-loop capacity)")
    ap.add_argument("--duration", type=float, default=8.0,
                    help="engine: load window in seconds (smoke clamps to 4)")
    ap.add_argument("--mutations", action="store_true",
                    help="engine: open the write path — re-rate, un-rate and "
                    "delete events ride the write lane beside the fold-ins, "
                    "an engine-fed drift monitor accumulates holdout, volume "
                    "and tombstone stats from live traffic, and the "
                    "lifecycle policy's verdict can fire a "
                    "tombstone-compacting refresh")
    ap.add_argument("--mesh", default=None,
                    help="lifecycle / engine: serve sharded over this mesh, "
                    "e.g. pod=2,data=4 (rows block-partitioned over all "
                    "listed axes; the shards placed round-robin over the "
                    "visible cards, or all on the CPU with --device cpu)")
    ap.add_argument("--trace-dir", default=None,
                    help="obs: write a Chrome trace-event JSON of the run "
                    "(engine batch/request spans, fold lane, lifecycle "
                    "refresh spans) into this directory")
    ap.add_argument("--metrics-json", default=None,
                    help="obs: write the unified metrics snapshot (engine, "
                    "retrieval and lifecycle series) to this JSON file")
    ap.add_argument("--sample-rate", type=float, default=1.0,
                    help="obs: per-request span sampling rate in [0, 1] "
                    "(seeded; per-batch and background spans are always "
                    "recorded while tracing)")
    ap.add_argument("--torch-profile", default=None,
                    help="obs: capture a torch.profiler trace (CPU and CUDA "
                    "activity) of the engine's load window into this "
                    "directory")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; the CPU "
                    "only when asked for)")
    args = ap.parse_args(argv)
    if args.batch is None:
        args.batch = 4 if args.workload == "lm" else 256
    if args.mutations and not args.engine:
        raise SystemExit("--mutations rides the request engine's write "
                         "lane; add --engine (--workload cf)")
    if args.mesh and not (args.lifecycle or args.engine):
        raise SystemExit("--mesh runs the multi-GPU paths, the lifecycle "
                         "replay or the request engine: add --lifecycle or "
                         "--engine (--workload cf)")
    if args.retrieval == "ivf" and not (args.lifecycle or args.engine):
        raise SystemExit("--retrieval ivf runs on the lifecycle replay or "
                         "the request engine (--workload cf --lifecycle / "
                         "--engine)")
    if args.waves is None:
        args.waves = 8 if args.lifecycle else 3
    args.requests = max(1, args.requests)  # the wave loops time at least one
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmul and cuDNN (full f32, as the reference's "
          "Precision.HIGHEST)")
    if args.workload == "lm":
        with torch.inference_mode():
            _serve_lm(args)
    elif args.engine:
        with _engine_cpu_threads(args.device):
            return _serve_cf_engine(args)
    elif args.lifecycle and args.mesh:
        return _serve_cf_lifecycle_sharded(args)
    elif args.lifecycle:
        _serve_cf_lifecycle(args)
    else:
        _serve_cf(args)


if __name__ == "__main__":
    main()
