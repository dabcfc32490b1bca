#!/usr/bin/env python3
"""The paper's tables and figures on the PyTorch/CUDA port.

The port's counterpart of the five paper-table functions of
``benchmarks/paper_tables.py``, with the same statistics-matched synthetic
datasets, folds, landmark specs, epochs and sample counts; each returns
rows of dicts and ``main`` prints them as JSON, one row a line:

  fig2_mae_vs_landmarks     — Fig. 2/3: MAE per #landmarks × strategy (+ baseline)
  tab2_sim_combos           — Tables 2-5: MAE per (d1, d2) measure combo
  tab6_runtime_vs_landmarks — Tables 6-9: fit runtime per #landmarks × strategy
  tab10_baseline_runtime    — Table 10: full-matrix kNN runtime
  tab15_comparative         — Table 15: how many × slower each algorithm is

  python3 tools/paper_tables_torch.py [--table tab15] [--dataset movielens1m]
                                      [--device cuda]

Everything runs on the card unless ``--device cpu`` is given. Every timed
span is warmed once first, so the kernels are built and loaded before the
clock starts (MF warms with one epoch and BPMF with one Gibbs sweep at the
timed run's shapes), and every span ends in ``torch.cuda.synchronize()``.
The random landmark strategies draw from a ``torch.Generator`` seeded with
the fold, so their picks are not the reference's.

The reference's MF and BPMF rows include XLA compile time: its clock starts
before ``fit_mf`` and ``fit_predict_bpmf`` jit their loops
(``benchmarks/paper_tables.py:148-163``). Rows of the two packages are
therefore not compared as times; their MAEs are comparable.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.baselines import (BPMFConfig, fit_mf,  # noqa: E402
                                   fit_predict_bpmf, irsvd_config, pmf_config,
                                   predict_mf, rsvd_config, svdpp_config)
from repro_torch.core import (LandmarkSpec, fit, fit_baseline,  # noqa: E402
                              predict)
from repro_torch.data.ratings import (RatingData, kfold_split,  # noqa: E402
                                      mae, synthesize)

STRATEGIES = ("random", "dist_ratings", "coresets", "coresets_random",
              "popularity")
MF_CONFIGS = (("RSVD", rsvd_config), ("IRSVD", irsvd_config),
              ("PMF", pmf_config), ("SVD++", svdpp_config))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, device):
    """(result, seconds) of ``fn()``, ended by a device synchronize."""
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _test_pairs(data, te, device):
    return (torch.as_tensor(data.users[te], device=device),
            torch.as_tensor(data.items[te], device=device))


def _fit_predict(fit_fn, data, te, spec, device):
    """(MAE, fit s, predict s) of ``fit_fn()`` then Eq. (1) on the test
    pairs, after one untimed run of both (which builds and loads the
    kernels and the library's first-use state)."""
    run_predict = lambda st: predict(st, *_test_pairs(data, te, device), spec)
    _timed(lambda: run_predict(fit_fn()), device)  # warm
    st, t_fit = _timed(fit_fn, device)
    preds, t_pred = _timed(lambda: run_predict(st), device)
    return mae(preds.cpu().numpy(), data.ratings[te]), t_fit, t_pred


def _eval_landmark(data, tr, te, spec: LandmarkSpec, key=0, device="cuda"):
    m = data.to_matrix(tr, device=device)
    return _fit_predict(
        lambda: fit(m, spec, generator=torch.Generator().manual_seed(key)),
        data, te, spec, device)


def _eval_baseline(data, tr, te, measure, mode="user", device="cuda"):
    m = data.to_matrix(tr, device=device)
    return _fit_predict(lambda: fit_baseline(m, measure, mode), data, te,
                        LandmarkSpec(mode=mode), device)


def fig2_mae_vs_landmarks(dataset="movielens100k", landmarks=(10, 40, 70, 100),
                          folds=2, mode="user", device="cuda") -> List[Dict]:
    data = synthesize(dataset, seed=0)
    rows = []
    for strategy in STRATEGIES:
        for n in landmarks:
            errs = []
            for f in range(folds):
                tr, te = kfold_split(data, f)
                spec = LandmarkSpec(n_landmarks=n, selection=strategy,
                                    d1="euclidean", d2="cosine", mode=mode)
                e, *_ = _eval_landmark(data, tr, te, spec, key=f,
                                       device=device)
                errs.append(e)
            rows.append({"dataset": dataset, "strategy": strategy, "n": n,
                         "mae": float(np.mean(errs))})
    # baseline CF cosine (the horizontal line in Fig. 2)
    errs = []
    for f in range(folds):
        tr, te = kfold_split(data, f)
        e, *_ = _eval_baseline(data, tr, te, "cosine", mode, device=device)
        errs.append(e)
    rows.append({"dataset": dataset, "strategy": "BASELINE_CF", "n": 0,
                 "mae": float(np.mean(errs))})
    return rows


def tab2_sim_combos(dataset="movielens100k", n=20, strategy="popularity",
                    device="cuda") -> List[Dict]:
    data = synthesize(dataset, seed=0)
    tr, te = kfold_split(data, 0)
    rows = []
    for d1 in ("euclidean", "cosine", "pearson"):
        for d2 in ("euclidean", "cosine", "pearson"):
            spec = LandmarkSpec(n_landmarks=n, selection=strategy, d1=d1,
                                d2=d2)
            e, t_fit, t_pred = _eval_landmark(data, tr, te, spec,
                                              device=device)
            rows.append({"dataset": dataset, "d1": d1, "d2": d2, "mae": e,
                         "fit_s": t_fit, "pred_s": t_pred})
    return rows


def tab6_runtime_vs_landmarks(dataset="movielens100k",
                              landmarks=(10, 40, 70, 100),
                              device="cuda") -> List[Dict]:
    data = synthesize(dataset, seed=0)
    tr, te = kfold_split(data, 0)
    rows = []
    for strategy in STRATEGIES:
        for n in landmarks:
            spec = LandmarkSpec(n_landmarks=n, selection=strategy)
            _, t_fit, t_pred = _eval_landmark(data, tr, te, spec,
                                              device=device)
            rows.append({"dataset": dataset, "strategy": strategy, "n": n,
                         "fit_s": t_fit, "pred_s": t_pred,
                         "total_s": t_fit + t_pred})
    return rows


def tab10_baseline_runtime(dataset="movielens100k",
                           device="cuda") -> List[Dict]:
    data = synthesize(dataset, seed=0)
    tr, te = kfold_split(data, 0)
    rows = []
    for mode in ("user", "item"):
        e, t_fit, t_pred = _eval_baseline(data, tr, te, "cosine", mode,
                                          device=device)
        rows.append({"dataset": dataset, "mode": mode, "mae": e,
                     "total_s": t_fit + t_pred})
    return rows


def tab15_comparative(dataset="movielens100k", epochs=15, *,
                      data: Optional[RatingData] = None,
                      device="cuda") -> List[Dict]:
    """Relative runtime vs Landmarks kNN (paper's bold row == 1.0).
    ``data`` replaces ``synthesize(dataset, seed=0)`` (a caller that holds
    it already, or a smaller matrix)."""
    data = synthesize(dataset, seed=0) if data is None else data
    tr, te = kfold_split(data, 0)
    rows = []

    spec = LandmarkSpec(n_landmarks=20, selection="popularity")
    lm_mae, t_fit, t_pred = _eval_landmark(data, tr, te, spec, device=device)
    t_lm = t_fit + t_pred
    rows.append({"algo": "Landmarks kNN", "mae": lm_mae, "time_s": t_lm,
                 "rel": 1.0})

    for meas in ("euclidean", "cosine", "pearson"):
        e, tf, tp = _eval_baseline(data, tr, te, meas, device=device)
        rows.append({"algo": f"{meas} kNN", "mae": e, "time_s": tf + tp,
                     "rel": (tf + tp) / t_lm})

    def mf_row(cfg):
        params, aux = fit_mf(data.users[tr], data.items[tr],
                             data.ratings[tr], cfg, device=device)
        return np.clip(predict_mf(params, cfg, data.users[te], data.items[te],
                                  aux).cpu().numpy(), 1, 5)

    for name, cfgf in MF_CONFIGS:
        cfg = cfgf(data.n_users, data.n_items, epochs=epochs)
        _timed(lambda: mf_row(dataclasses.replace(cfg, epochs=1)), device)
        preds, dt = _timed(lambda: mf_row(cfg), device)
        rows.append({"algo": name, "mae": mae(preds, data.ratings[te]),
                     "time_s": dt, "rel": dt / t_lm})

    def bpmf_preds(bcfg):
        return fit_predict_bpmf(data.users[tr], data.items[tr],
                                data.ratings[tr], data.users[te],
                                data.items[te], bcfg, device=device)

    bcfg = BPMFConfig(data.n_users, data.n_items, n_samples=10, burnin=4)
    _timed(lambda: bpmf_preds(dataclasses.replace(bcfg, n_samples=1,
                                                  burnin=0)), device)
    preds, dt = _timed(lambda: bpmf_preds(bcfg).cpu().numpy(), device)
    rows.append({"algo": "BPMF", "mae": mae(preds, data.ratings[te]),
                 "time_s": dt, "rel": dt / t_lm})
    return rows


TABLES = {"fig2": fig2_mae_vs_landmarks, "tab2": tab2_sim_combos,
          "tab6": tab6_runtime_vs_landmarks,
          "tab10": tab10_baseline_runtime, "tab15": tab15_comparative}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--table", choices=sorted(TABLES) + ["all"],
                    default="tab15")
    ap.add_argument("--dataset", default="movielens100k")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; the CPU only when "
                    "asked for)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    names = sorted(TABLES) if args.table == "all" else [args.table]
    for name in names:
        t0 = time.perf_counter()
        for row in TABLES[name](args.dataset, device=device):
            print(json.dumps({"table": name, "device": where, **row}))
        print(f"# {name} [{args.dataset}] on {where}: "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
