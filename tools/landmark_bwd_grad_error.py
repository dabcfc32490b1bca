#!/usr/bin/env python3
"""Where the f32 landmark training step's gradient error comes from, on
the card: kernel 7 (``f32_split``) and its backward in SmolLM-360M at full
width, cut to ``--layers`` layers, f32 weights (seed 0), batch 0 of
``lm_batch`` at B = ``--batch``, S = ``--seq`` (``chip_smoke.py`` phase
16d's model and step).

    python3 tools/landmark_bwd_grad_error.py [--layers 2] [--batch 8]
        [--seq 4096] [--device cuda]

It prints JSON lines:

- ``grads``: step 1's gradients ‖Δg‖/‖g‖ over the whole model and over
  each of wq, wk, wv against the plain pair (the plain forward
  ``ref.landmark_summary_ref`` with the plain backward
  ``ref.landmark_summary_bwd_ref``), for the plain pair over reversed keys
  (the floor of phase 16d's rule), the plain forward with the backward
  kernel, the plain forward with the kernel's arithmetic in plain torch
  (``ref.landmark_summary_bwd_f32_split_ref``), the forward kernel with
  the plain backward, and the whole kernel path;
- ``call``, one per layer, on the inputs the backward received there:
  the forward kernel's and the plain f32 forward's error against an f64
  forward, the common mode of q, k, v (the median over problems of
  |mean over rows| / rms of the rows about it), and the dq, dk, dv of the
  backward kernel, its plain-torch arithmetic and the plain f32 backward
  against an f64 backward, each ‖Δ‖/‖·‖ with the f64 forward's output;
- the card's name and power limit.

Needs a CUDA card and ``nvcc``; TF32 off. ``--device cpu`` rehearses the
script at a small size: there every kernel is its plain version.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import _grad_rel, _train_arch, _with_backward  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import landmark_attention as lsum  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402


def rel_norm(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def common_mode(x):
    mean = x.mean(-2, keepdim=True)
    spread = (x - mean).square().sum(-1).mean(-1, keepdim=True).sqrt()
    return float((mean.norm(dim=-1) / spread).median())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        print("landmark_bwd_grad_error: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _train_arch("landmark", dtype=torch.float32,
                      n_layers=args.layers).model
    model = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0),
                       dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             synthetic.lm_batch(0, 0, args.batch, args.seq,
                                cfg.vocab).items()}
    seen = []

    def plain_bwd(q, k, v, out, dout, scale):
        seen.append((q.detach(), k.detach(), v.detach(), dout, scale))
        return ref.landmark_summary_bwd_ref(q, k, v, out, dout, scale)

    def grads(fn):
        patch = (mock.patch.object(ops, "landmark_summary", fn) if fn
                 else contextlib.nullcontext())
        with patch:
            return steps.value_and_grad(model, batch)[1]

    plain = _with_backward(ref.landmark_summary_ref,
                           ref.landmark_summary_bwd_ref)
    gp = grads(_with_backward(ref.landmark_summary_ref, plain_bwd))
    paths = {
        "plain pair over reversed keys (floor)":
            lambda q, k, v, s: plain(q, k.flip(-2), v.flip(-2), s),
        "plain forward, backward kernel": _with_backward(
            ref.landmark_summary_ref, lsum.landmark_summary_bwd),
        "plain forward, backward kernel's arithmetic in plain torch":
            _with_backward(ref.landmark_summary_ref,
                           ref.landmark_summary_bwd_f32_split_ref),
        "forward kernel, plain backward": _with_backward(
            lsum._summary, ref.landmark_summary_bwd_ref),
        "whole kernel path": None,
    }
    for name, fn in paths.items():
        print(json.dumps({"grads": name, "rel_norm_vs_plain_pair":
                          _grad_rel(grads(fn), gp)}), flush=True)
    for layer, (q, k, v, dout, scale) in enumerate(seen):
        q64, k64, v64, d64 = (t.double() for t in (q, k, v, dout))
        p64 = torch.softmax((q64 @ k64.transpose(-1, -2)) * scale, -1)
        o64 = p64 @ v64
        ds = p64 * (d64 @ v64.transpose(-1, -2)
                    - (d64 * o64).sum(-1, keepdim=True))
        truth = ((ds @ k64) * scale, (ds.transpose(-1, -2) @ q64) * scale,
                 p64.transpose(-1, -2) @ d64)
        out = o64.float()
        line = {"call": layer, "shape": list(q.shape) + [k.shape[1]],
                "forward_rel_norm": {
                    "kernel": rel_norm(lsum._summary(q, k, v, scale), o64),
                    "plain f32": rel_norm(ref.landmark_summary_ref(
                        q, k, v, scale), o64)},
                "common_mode": {"q": common_mode(q), "k": common_mode(k),
                                "v": common_mode(v)}}
        for name, bwd in (("kernel", lsum.landmark_summary_bwd),
                          ("kernel's arithmetic",
                           ref.landmark_summary_bwd_f32_split_ref),
                          ("plain f32", ref.landmark_summary_bwd_ref)):
            got = bwd(q, k, v, out, dout, scale)
            line[f"{name} (dq, dk, dv)"] = [rel_norm(a, b)
                                            for a, b in zip(got, truth)]
        print(json.dumps(line), flush=True)
        del q64, k64, v64, d64, p64, o64, ds, truth
    if dev == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
        print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
