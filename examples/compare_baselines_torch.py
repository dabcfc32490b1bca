"""Reproduce the paper's comparative analysis (§4.4) on one CV fold, on the
PyTorch/CUDA port: Landmarks kNN vs 3 memory-based + 5 model-based
algorithms.

  PYTHONPATH=src python examples/compare_baselines_torch.py \
      [--dataset movielens100k] [--epochs 20] [--device cpu]

Runs on the card unless ``--device cpu`` is given. Each time includes the
first use of its code path (kernel loads, library handles), as the
reference's example includes its compiles; ``tools/paper_tables_torch.py``
warms every span first.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.baselines import (
    BPMFConfig, fit_mf, fit_predict_bpmf, irsvd_config, pmf_config,
    predict_mf, rsvd_config, svdpp_config,
)
from repro_torch.core import LandmarkSpec, fit, fit_baseline, predict
from repro_torch.data.ratings import kfold_split, mae, synthesize


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="movielens100k")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32, as the reference

    def done(out):
        if device.type == "cuda":
            torch.cuda.synchronize()
        return out.cpu().numpy() if isinstance(out, torch.Tensor) else out

    data = synthesize(args.dataset, seed=0)
    tr, te = kfold_split(data, 0)
    m = data.to_matrix(tr, device=device)
    pu = torch.as_tensor(data.users[te], device=device)
    pi = torch.as_tensor(data.items[te], device=device)
    results = []

    spec = LandmarkSpec(n_landmarks=20, selection="popularity")
    t0 = time.perf_counter()
    st = fit(m, spec)
    preds = done(predict(st, pu, pi, spec))
    results.append(("Landmarks kNN", mae(preds, data.ratings[te]),
                    time.perf_counter() - t0))

    for meas in ("euclidean", "cosine", "pearson"):
        t0 = time.perf_counter()
        stb = fit_baseline(m, meas)
        preds = done(predict(stb, pu, pi, spec))
        results.append((f"{meas} kNN", mae(preds, data.ratings[te]),
                        time.perf_counter() - t0))

    for name, cfgf in (("RSVD", rsvd_config), ("IRSVD", irsvd_config),
                       ("PMF", pmf_config), ("SVD++", svdpp_config)):
        cfg = cfgf(data.n_users, data.n_items, epochs=args.epochs)
        t0 = time.perf_counter()
        params, aux = fit_mf(data.users[tr], data.items[tr],
                             data.ratings[tr], cfg, device=device)
        preds = np.clip(done(predict_mf(params, cfg, data.users[te],
                                        data.items[te], aux)), 1, 5)
        results.append((name, mae(preds, data.ratings[te]),
                        time.perf_counter() - t0))

    t0 = time.perf_counter()
    bcfg = BPMFConfig(data.n_users, data.n_items, n_samples=12, burnin=4)
    preds = done(fit_predict_bpmf(data.users[tr], data.items[tr],
                                  data.ratings[tr], data.users[te],
                                  data.items[te], bcfg, device=device))
    results.append(("BPMF", mae(preds, data.ratings[te]),
                    time.perf_counter() - t0))

    t_lm = results[0][2]
    print(f"\n{args.dataset} on {device}: MAE / runtime / "
          f"x-slower-than-landmarks (paper Tab. 15)")
    for name, err, dt in results:
        print(f"  {name:14s} MAE {err:.4f}  {dt:7.2f}s  {dt/t_lm:6.1f}x")


if __name__ == "__main__":
    main()
