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
  (``core.fold_in``: no refit). ``--workload cf [--smoke]``
- ``cf --lifecycle``: the continual-serving loop — a drifting arrival stream
  (``data.synthetic.drifting_ratings``) through bucket-padded state
  (``lifecycle.buckets``), drift monitoring (holdout-MAE reservoir, fold-in
  volume, landmark coverage) and a policy-triggered background refresh
  with a generation-stamped artifact swap.
- ``cf --lifecycle --retrieval ivf``: the same loop with an IVF index over the
  landmark embedding: fold-in appends arrivals under the frozen quantizer,
  the refresh rebuilds it inside the swap, a list-skew gate repacks it,
  and every wave reports recall@k of the serving-nprobe search against the
  exact (full-probe) search, escalating nprobe to hold a 0.95 SLO;
  ``--early-exit`` adds per-query adaptive probing.

Everything runs on the card unless ``--device cpu`` is given; asking for
``cuda`` on a machine without one raises. TF32 is switched off for matmuls
and cuDNN at start: the reference scores in full f32
(``Precision.HIGHEST``). CF latency is reported per wave as p50/p95/p99 of
the timed requests, each timed to the end of its device work; LM prefill
and decode times end in a device synchronize.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import tempfile
import time

import numpy as np
import torch

from ..configs import landmark_cf as cfg
from ..configs import registry
from ..core import RatingMatrix, fit, fold_in, knn
from ..data import synthetic
from ..models import transformer as lm_mod
from ..serving.stats import latency_stats
from ..train.checkpoint import (latest_step, load_landmark_state,
                                save_landmark_state)

IVF_RECALL_SLO = 0.95  # serving recall target; nprobe escalates to hold it


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
        save_landmark_state(ckpt_dir, st)
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
    if args.smoke:
        _clamp_lifecycle_smoke(args)
    stream = dict(n_waves=args.waves, drift=args.drift)
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="cf_lifecycle_")
    rng = np.random.default_rng(0)
    bq = args.foldin  # fold-in batch bucket: b is padded to this, always
    buckets.reset_geometries()

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
    manager = RefreshManager(ckpt_dir, spec, ivf=user_ivf, device=device)
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
            new_cov = monitor.batch_coverage(
                st_new.representation, torch.ones(snap_u, device=device))
            mon = monitor.rebase(mon, bst.n_valid, new_cov)
            snap, reasons = monitor.holdout_snapshot(mon, bst), []
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
    print("cf lifecycle: done")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve loops. lm: prefill + decode with the exact KV "
        "cache or landmark summaries. cf: load (or fit and checkpoint) an "
        "artifact, then waves of pair predictions and top-N "
        "recommendations with fold-ins between them; --lifecycle adds drift "
        "monitoring and background refresh, --retrieval ivf an IVF index.")
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
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; the CPU "
                    "only when asked for)")
    args = ap.parse_args(argv)
    if args.batch is None:
        args.batch = 4 if args.workload == "lm" else 256
    if args.retrieval == "ivf" and not args.lifecycle:
        raise SystemExit("--retrieval ivf runs on the lifecycle replay "
                         "(--workload cf --lifecycle)")
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
    elif args.lifecycle:
        _serve_cf_lifecycle(args)
    else:
        _serve_cf(args)


if __name__ == "__main__":
    main()
