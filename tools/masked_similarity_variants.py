#!/usr/bin/env python3
"""Time schedules of d1's 22..128-landmark moments (``csrc/masked_similarity.cu``)
side by side in one process on the card, at the two shapes that take the
cluster kernel: web_fit's (A = U users, B = 128 popularity landmarks,
P = 65,536 items; ratings and U from ``tools/profile_web_fit.py``) and
the ML-1M fit at 128 landmarks (A = 5976, P = 3952; phase 14a's wide
path).

    python3 tools/masked_similarity_variants.py [NAME ...] [--reps 2]

Each variant is the checked-in source with a few lines replaced
(``VARIANTS`` below): ``as_built``, and ``grouped``, the plain reordering
of the one-tile kernel that the cluster kernel was measured against —
``moments_wgmma_kernel``'s loop with N tiles of 32 landmarks, block b
taking N tile b % NT of group b / NT's (row tile, stage) units, so a
group's co-resident blocks walk the same stages and L2 serves the
re-reads of each A stage, with no cluster, multicast or mbarrier. Every
variant is built by its own ``nvcc`` (all started together) into
``build/variants/`` and called through its own C entry point. Variants
run in turns, ``--reps`` rounds, first to last then last to first. Per
(variant, shape) it prints one JSON line: CUDA-event ms per call (3 calls
at web_fit, 50 at the fit), the device ms per call by kernel from a
``torch.profiler`` trace, the card's kept and replaced results, and
whether the cosine output is bitwise the first variant's. Needs a CUDA
card and ``nvcc``.
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

GROUPED = r'''
// the plain reordering (tools/masked_similarity_variants.py)
__device__ __forceinline__ void stage_grouped(
    const float* __restrict__ ra, const uint4* __restrict__ planes,
    uint32_t dst, long long u, int n, int k_stages, int A, int P) {
  const int m = static_cast<int>(u / k_stages);
  const int ks = static_cast<int>(u - static_cast<long long>(m) * k_stages);
  const int row0 = m * kRows, item0 = ks * kItems;
  const int tid = threadIdx.x;
  const uint4* src = planes + (static_cast<size_t>(n) * k_stages + ks) *
                                  (kCPlaneBytes / 16);
#pragma unroll
  for (int i = 0; i < kCPlaneBytes / 16 / kTcThreads; ++i) {
    const int q = tid + i * kTcThreads;
    cp_async16(dst + q * 16, src + q, 16);
  }
  const uint32_t a_dst = dst + kCPlaneBytes;
#pragma unroll
  for (int i = 0; i < kRows * 16 / kTcThreads; ++i) {
    const int q = tid + i * kTcThreads;
    const int r = q >> 4, c = q & 15;
    const int gr = row0 + r, gi = item0 + 4 * c;
    const bool live = gr < A && gi < P;
    cp_async16(a_dst + r * 256 + ((c ^ ((r & 1) << 2)) << 4),
               live ? ra + static_cast<size_t>(gr) * P + gi : ra,
               live ? 16 : 0);
  }
}

template <bool HALF>
__global__ void __launch_bounds__(kTcThreads, 1)
moments_grouped_kernel(const float* __restrict__ ra,
                       const uint4* __restrict__ planes,
                       float* __restrict__ ws, int* __restrict__ flag,
                       int A, int B, int P, int k_stages, int n_tiles,
                       long long units) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint8_t* const ring_p = smem_raw + (ring - raw);
  const int n = static_cast<int>(blockIdx.x % n_tiles);
  const long long groups = gridDim.x / n_tiles, g = blockIdx.x / n_tiles;
  const long long u0 = units * g / groups;
  const long long u1 = units * (g + 1) / groups;
  if (u0 >= u1) return;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int w_row = (warp >> 2) * 64 + (warp & 3) * 16;
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (u0 + s < u1) {
      stage_grouped(ra, planes, ring + s * kCStageBytes, u0 + s, n,
                    k_stages, A, P);
    }
    cp_async_commit();
  }
  float acc_q[16], acc_a[32], acc_m[48];
  zero(acc_q);
  zero(acc_a);
  zero(acc_m);
  bool ok = true;
  long long cur = u0 / k_stages;
  for (long long u = u0; u < u1; ++u) {
    const int it = static_cast<int>(u - u0);
    const uint32_t slot = ring + (it % kStages) * kCStageBytes;
    cp_async_wait<kAhead - 1>();
    fence_async_shared();
    __syncthreads();
    if (u + kAhead < u1) {
      stage_grouped(ra, planes,
                    ring + ((it + kAhead) % kStages) * kCStageBytes,
                    u + kAhead, n, k_stages, A, P);
    }
    cp_async_commit();
    const long long tile = u / k_stages;
    if (tile != cur) {
      wgmma_wait<0>();
      pin(acc_q);
      pin(acc_a);
      pin(acc_m);
      flush<kCLm, 4, 8, 12>(ws, acc_q, acc_a, acc_m,
                            static_cast<int>(cur) * kRows + w_row,
                            n * kCLm, A, B);
      zero(acc_q);
      zero(acc_a);
      zero(acc_m);
      cur = tile;
    }
    const float* at = reinterpret_cast<const float*>(
                          ring_p + (slot - ring) + kCPlaneBytes) +
                      (w_row + gid) * kItems;
#pragma unroll
    for (int s = 0; s < kItems / 16; ++s) {
      const int chunk = (4 * s + tig) ^ ((gid & 1) << 2);
      const float4 x = *reinterpret_cast<const float4*>(at + chunk * 4);
      const float4 y =
          *reinterpret_cast<const float4*>(at + 8 * kItems + chunk * 4);
      ok &= exact4<HALF>(x) & exact4<HALF>(y);
      const uint32_t fa[4] = {pack_bf16(x.x, x.y), pack_bf16(y.x, y.y),
                              pack_bf16(x.z, x.w), pack_bf16(y.z, y.w)};
      const uint32_t fm[4] = {pack_mask(x.x, x.y), pack_mask(y.x, y.y),
                              pack_mask(x.z, x.w), pack_mask(y.z, y.w)};
      const uint32_t fq[4] = {
          pack_bf16(__fmul_rn(x.x, x.x), __fmul_rn(x.y, x.y)),
          pack_bf16(__fmul_rn(y.x, y.x), __fmul_rn(y.y, y.y)),
          pack_bf16(__fmul_rn(x.z, x.z), __fmul_rn(x.w, x.w)),
          pack_bf16(__fmul_rn(y.z, y.z), __fmul_rn(y.w, y.w))};
      const uint64_t db =
          sm90_desc(slot + s * 16 * 128, kItems * 128, 8 * 128, 1);
      repro::wgmma_fence();
      repro::wgmma_rs<32>(acc_q, fq, db);
      repro::wgmma_rs<64>(acc_a, fa, db);
      repro::wgmma_rs<96>(acc_m, fm, db);
    }
    repro::wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  pin(acc_q);
  pin(acc_a);
  pin(acc_m);
  flush<kCLm, 4, 8, 12>(ws, acc_q, acc_a, acc_m,
                        static_cast<int>(cur) * kRows + w_row, n * kCLm, A,
                        B);
  if (!ok) *flag = 1;
}

template <bool HALF>
cudaError_t launch_grouped(const float* ra, const uint4* planes, float* ws,
                           int* flag, int A, int B, int P, int k_stages,
                           int n_tiles, long long units, cudaStream_t st) {
  static size_t sized[repro::kMaxDevices] = {};
  cudaError_t err =
      repro::allow_smem(moments_grouped_kernel<HALF>, kCSmem, sized);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  long long groups = sms / n_tiles;
  if (groups > units) groups = units;
  moments_grouped_kernel<HALF>
      <<<static_cast<int>(groups * n_tiles), kTcThreads, kCSmem, st>>>(
          ra, planes, ws, flag, A, B, P, k_stages, n_tiles, units);
  return cudaGetLastError();
}

}  // namespace
'''

# name -> [(text in the source, its replacement)]
VARIANTS = {
    "as_built": [],
    "grouped": [
        ("}  // namespace\n", GROUPED),
        ("        ? (half ? launch_cluster<true> : launch_cluster<false>)",
         "        ? (half ? launch_grouped<true> : launch_grouped<false>)")],
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", default=list(VARIANTS))
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import landmark_cf as cfg
    from repro_torch.core.selection import popularity_landmarks
    from repro_torch.data import ratings as data
    from repro_torch.kernels import build, cost
    from repro_torch.kernels import masked_similarity as ms
    from profile_web_fit import main_users, web_ratings

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    src = (build.CSRC / "masked_similarity.cu").read_text()
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in args.names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the source does not hold "
                                 f"{old.splitlines()[0]!r} once")
            text = text.replace(old, new)
        (out_dir / f"d1_{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc(), build.ARCH, "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", "-I", str(build.CSRC),
             "-o", str(out_dir / f"d1_{name}.so"),
             str(out_dir / f"d1_{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"d1_{name}.so"))
        fn = lib.masked_similarity_tc
        fn.argtypes = build.SIGNATURES["masked_similarity_tc"]
        fn.restype = ctypes.c_int
        libs[name] = fn

    def call(fn, r_a, r_b, out, ws, results):
        a, p = r_a.shape
        b = r_b.shape[0]
        err = fn(r_a.data_ptr(), r_b.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), results.data_ptr(), a, b, p,
                 build.MEASURE_CODES["cosine"], cost.d1_n_tile(b, p, True),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"masked_similarity_tc: CUDA error {err}")

    def event_ms(run, iters):
        run()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def device_ms(run, iters):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                run()
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                key = e.name.replace("(anonymous namespace)::", "")
                key = key.removeprefix("void ").split("(")[0]
                key = key.split("<")[0].split("::")[-1].strip()
                by[key] = by.get(key, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3 / iters
        return by

    d = data.synthesize("movielens1m", seed=0)
    train = d.to_matrix(data.kfold_split(d, 0)[0], device="cuda").ratings
    fit_r = train[:train.shape[0] - 64]
    users = main_users()
    shapes = {
        "fit n=128": lambda: (fit_r, fit_r[popularity_landmarks(
            fit_r, cfg.WEB_FIT["n_landmarks"])]),
        "web_fit": lambda: (lambda r: (r, r[popularity_landmarks(
            r, cfg.WEB_FIT["n_landmarks"])]))(
                web_ratings(users, cfg.WEB_FIT["n_items"]))}
    order = []
    for r in range(args.reps):
        order += args.names if r % 2 == 0 else args.names[::-1]
    for shape, make in shapes.items():
        r_a, r_b = make()
        a, p = r_a.shape
        b = r_b.shape[0]
        ws = torch.empty(ms._workspace_bytes(a, b, p, cost.d1_n_tile(
            b, p, True)), dtype=torch.uint8, device="cuda")
        out = torch.empty((a, b), device="cuda")
        results = torch.zeros(2, dtype=torch.int32, device="cuda")
        first = None
        big = shape == "web_fit"
        for name in order:
            def run(fn=libs[name]):
                call(fn, r_a, r_b, out, ws, results)
            results.zero_()
            run()
            torch.cuda.synchronize()
            if first is None:
                first = out.clone()
            row = {"variant": name, "shape": shape, "A": a, "B": b, "P": p,
                   "card": card,
                   "bitwise_first": bool(torch.equal(out, first)),
                   "results_kept_replaced": results.tolist(),
                   "events_ms": event_ms(run, 3 if big else 50),
                   "device_ms_by_kernel": device_ms(run, 2 if big else 20)}
            print(json.dumps(row), flush=True)
        del r_a, r_b, ws, out, first
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
