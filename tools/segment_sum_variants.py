#!/usr/bin/env python3
"""Time variants of the segment-sum kernel (``csrc/segment_sum.cu``) in one
process on the card, at the recsys CSRs of ``chip_smoke.py`` phase 18a:
FM's by field id at train_batch (H = 1 and 10) and BERT4Rec's by item id
at 16,384 histories (H = 64, the Zipf head of 1,850,927 ids), f32.

    python3 tools/segment_sum_variants.py [NAME ...] [--huge N ...]

Each variant is the checked-in source with a few lines replaced
(``VARIANTS`` below); every one is built by its own ``nvcc`` (all started
together) into ``build/variants/`` and loaded beside the others, so they
compare within one call on one card. Per variant, CSR and width it prints
one JSON line: whether the output is bitwise the plain version (null for
the variants that drop work and so cannot be), and CUDA-event ms of the
launch as built, with every heavy slot unused (the light walk alone) and
with no chunk (the heavy units alone). ``--huge`` rebuilds the CSRs with
``segment_sum.HUGE`` set to each value (a value past every segment's size
gives every heavy segment 16-byte slices). Needs a CUDA card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

# name -> [(text in the source, its replacement)]
VARIANTS = {
    "as_built": [],
    # a deeper or shallower ring of stages
    "ring3": [("constexpr int kRing = 4;", "constexpr int kRing = 3;")],
    "ring6": [("constexpr int kRing = 4;", "constexpr int kRing = 6;")],
    # stages of twice the bytes (a third of the warps fit an SM)
    "stage2k": [("constexpr int kStageBytes = 1024;",
                 "constexpr int kStageBytes = 2048;")],
    # no row slice copied: the chain and each stage's bookkeeping alone
    "no_row_copies": [
        ("          cp_async4(xd + r * SLOT, xs + ps[r] * pitch);",
         "          (void)xd;"),
        ("          copy_slice(xd + r * SLOT, xs + ps[r] * pitch, bytes, g);",
         "          (void)xd;")],
    # the narrow walk's runs with edges not walked: bounds, tiles, stores
    "no_narrow_walk": [
        ("        walk_narrow<T>(x, perm, tile, h, lane, ends, j, b, stop, pf,\n"
         "                       j == first);", "        (void)pf;")],
    # every narrow window's bounds zeroed, not loaded: the stores alone
    "stores_only": [
        ("    for (int i = lane; i <= we - ws; i += 32)\n"
         "      cp_async4(sb + i, indptr + ws + i);",
         "    for (int i = lane; i <= we - ws; i += 32)\n      sb[i] = 0;")],
}
EXACT = ("as_built", "ring3", "ring6", "stage2k")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
    ap.add_argument("--huge", type=int, nargs="*", default=[])
    args = ap.parse_args()

    import torch

    from repro_torch.kernels import build, ops, ref  # noqa: F401
    from repro_torch.kernels import segment_sum as segsum
    from repro_torch.distributed import embedding
    from time_segment_sum import event_ms, recsys_inputs, split

    src = (build.CSRC / "segment_sum.cu").read_text()
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in args.names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer holds "
                                 f"{old.splitlines()[0]!r}")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), build.ARCH, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-I", str(build.CSRC),
             "-o", str(out_dir / f"{name}.so"),
             str(out_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        lib.segment_sum_f32.argtypes = build.SIGNATURES["segment_sum_f32"]
        libs[name] = lib

    def launch(lib, x, csr, out):
        err = lib.segment_sum_f32(
            x.data_ptr(), csr.perm.data_ptr(), csr.indptr.data_ptr(),
            csr.chunk_rows.data_ptr(), csr.heavy_rows.data_ptr(),
            csr.n_huge.data_ptr(), out.data_ptr(), csr.n, csr.perm.numel(),
            x.shape[1], csr.chunk_rows.numel() - 1, csr.heavy_rows.numel(),
            segsum.HEAVY, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"segment_sum_f32: CUDA error {err}")

    inputs = recsys_inputs("cuda")
    gen = torch.Generator(device="cuda").manual_seed(36)
    for huge in args.huge or [segsum.HUGE]:
        segsum.HUGE = huge
        for tag, ids, rows, widths in inputs:
            csr = embedding.lookup_csr(ids, rows)
            light, heavy = split(csr)
            iters = 5 if tag.startswith("bert4rec") else 20
            for h in widths:
                x = torch.randn((csr.n_edges, h), generator=gen,
                                device="cuda")
                want = ref.segment_sum_ref(x, csr.perm, csr.indptr)
                out = torch.empty((csr.n, h), device="cuda")
                for name, lib in libs.items():
                    launch(lib, x, csr, out)
                    torch.cuda.synchronize()
                    print(json.dumps({
                        "variant": name, "csr": tag, "H": h, "huge": huge,
                        "huge_segments": int(csr.n_huge),
                        "bitwise_plain": (bool(torch.equal(out, want))
                                          if name in EXACT else None),
                        "ms": event_ms(lambda: launch(lib, x, csr, out),
                                       iters),
                        "light_alone_ms": event_ms(
                            lambda: launch(lib, x, light, out), iters),
                        "heavy_alone_ms": event_ms(
                            lambda: launch(lib, x, heavy, out), iters)}),
                        flush=True)
                del x, want, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
