"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` (all
started together), linked into ``build/kernels/librepro_torch_kernels.so``
at the root of the checkout, and loaded with ``ctypes``. The library
exposes a plain C interface: pointers and the stream are ``void*``, sizes
``int``, scales ``float``, and every entry point returns ``cudaGetLastError()`` after its
launch. A SHA-256 of the sources and flags decides whether a build on disk
is current; the first kernel launch of a process builds when it is not.

Nothing here runs at import time: this module imports on machines without
``nvcc`` or a card, where the CPU tests take the plain versions.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "librepro_torch_kernels.so"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# no --use_fast_math: sqrtf and '/' must stay IEEE (the d1 kernel matches
# its plain version bitwise on integer ratings)
NVCC_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MEASURE_CODES = {"cosine": 0, "pearson": 1, "euclidean": 2}

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
SIGNATURES = {
    # (a, b, out, A, B, P, measure, stream)
    "masked_similarity_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
    # (a, b, out, ws, results, A, B, P, measure, stream): bf16 wgmma
    # moments, then the finalize launch (the f32 route when the guard fails)
    "masked_similarity_tc": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # (q, cand, prep, part_vals, part_ids, vals, ids, rows, C, n, k, n_valid,
    #  self_offset, measure, variant, qt, ct, splits, tiles_per_split,
    #  stream): prep, scan and (splits > 1) merge
    "topk_scan_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                      _I, _I, _I, _I, _I, _P),
    # (rep, init, cent, assign, prep, pval, cscratch, U, C, n, iters,
    #  n_valid, measure, normalize, stream): a whole k-means in one launch
    "kmeans_lloyd_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _P),
    # (q, cand, out, B, M, n, measure, stream)
    "score_candidates_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # (q, probe, probe_ok, order, lists, rows, scale, fill, self_ids, vals,
    #  ids, B, nprobe, C, cap, n, k, measure, payload, group, stream)
    "ivf_probe_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                      _I, _I, _I, _I, _I, _I, _P),
    # (x, planes, n, terms, stream): f32 → bf16 terms, the f32 route's split
    "split_bf16_terms": (_P, _P, _L, _I, _P),
    # (q, k, v, out, P, N, S, D, scale, stream): TMA + wgmma on the tensor
    # cores, q k v as f32 inputs' bf16 planes (3, 3, 2 terms) or bf16 inputs
    "landmark_summary_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "landmark_summary_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # (q, k, v, out, dout, dout_planes, dq, dk, dv, lse, delta, P, N, NP,
    #  S, D, scale, stream): kernel 7's backward on the tensor cores, bf16
    #  inputs or f32 inputs' bf16 planes (3, 3, 2 terms), two launches (dq
    #  pass, then dk/dv)
    "landmark_summary_bwd_tc": (_P,) * 11 + (_I, _I, _I, _I, _I, _F, _P),
    "landmark_summary_bwd_tc_f32": (_P,) * 11 + (_I, _I, _I, _I, _I, _F, _P),
    # (q, k, v, out, dout, dq, dk, dv, lse, delta, P, N, S, D, scale,
    #  stream): its FMA route (D = 256, f32 or bf16 inputs), two launches
    "landmark_summary_bwd_f32": (_P,) * 10 + (_I, _I, _I, _I, _F, _P),
    "landmark_summary_bwd_bf16": (_P,) * 10 + (_I, _I, _I, _I, _F, _P),
    # (x, perm, indptr, chunk_rows, heavy_rows, n_huge, out, N, E_live, H,
    #  n_chunks, n_heavy, heavy, stream): the fixed-order CSR segment sum
    "segment_sum_f32": (_P,) * 7 + (_L, _I, _I, _I, _I, _I, _P),
    "segment_sum_bf16": (_P,) * 7 + (_L, _I, _I, _I, _I, _I, _P),
    # (variant, n, measure) -> resident scan blocks an SM holds (no stream)
    "topk_scan_blocks_per_sm": (_I, _I, _I),
}


def nvcc() -> str:
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join((ARCH,) + NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> Tuple[Path, str, float]:
    """Compile and link the library unless the one on disk is current.

    Returns ``(path, compiler_output, seconds)``; the output holds the
    ``-Xptxas -v`` register, shared-memory and spill lines of a fresh build
    and is empty when nothing was rebuilt. Raises if ``nvcc`` fails.
    """
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest(sources + headers)
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib, "", 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    objs = [BUILD_DIR / f"{s.stem}.o" for s in sources]
    procs = [subprocess.Popen([nvcc(), ARCH, *NVCC_FLAGS, "-c", str(s),
                               "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    for src, proc, log in zip(sources, procs, logs):
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc(), ARCH, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib, "\n".join(logs), time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def on_meta(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the ``meta`` device: the wrapper then
    returns outputs of the right shapes on ``meta`` and charges its cost
    (``kernels/cost.py``), with neither a launch nor its plain version.
    False when none does; raises when only some do, so a CUDA tensor never
    takes the meta route."""
    metas = [t.device.type == "meta" for t in tensors
             if isinstance(t, torch.Tensor)]
    if any(metas) and not all(metas):
        raise ValueError(f"{name}: meta and real tensors mixed: "
                         f"{[str(t.device) for t in tensors if isinstance(t, torch.Tensor)]}")
    return bool(metas) and all(metas)


def check_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous 2-D float32 tensor on one
    CUDA device — the only input the kernels take (or, on the meta route,
    on ``meta``)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type not in ("cuda", "meta") or t.device != dev:
            raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                             f"got {[str(x.device) for x in tensors]}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: inputs must be float32, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous 2-D tensors")


def check_cuda(name: str, t: torch.Tensor, ndim: int, dtypes,
               device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``ndim``-D tensor of one of
    ``dtypes`` on the CUDA ``device`` (the per-argument check of the kernels
    that take integer tables or quantized payloads beside float rows)."""
    if t.device != device:
        raise ValueError(f"{name}: all inputs must be on {device}, got "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: expected {dtypes}, got {t.dtype}")
    if t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: inputs must be contiguous {ndim}-D "
                         f"tensors, got shape {tuple(t.shape)}")


_TALLIES = threading.local()  # the launch tallies open on each thread


def count_launch(wrapper, n: int = 1) -> None:
    """Add ``n`` launches to ``wrapper.launches`` and to every tally that
    the calling thread has open (:func:`tally`). A wrapper calls this where
    it launches its kernel, and nowhere else."""
    wrapper.launches += n
    for t in getattr(_TALLIES, "open", ()):
        t[wrapper.__name__] = t.get(wrapper.__name__, 0) + n


@contextlib.contextmanager
def tally():
    """Count the launches made on this thread inside the block, by wrapper
    name, into the dict it yields: a caller separates the launches of one
    path from those of another thread (a background refit) or of a check
    running beside it."""
    counts: dict = {}
    stack = _TALLIES.__dict__.setdefault("open", [])
    stack.append(counts)
    try:
        yield counts
    finally:
        stack.remove(counts)


def launch(name: str, *args) -> None:
    """Call C entry point ``name`` with ``args`` plus the current stream of
    the first tensor's device; raise on a non-zero ``cudaGetLastError()``."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    stream = torch.cuda.current_stream(dev).cuda_stream
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    # None passes a null pointer (an optional operand the kernel skips)
    with torch.cuda.device(dev):
        err = getattr(library(), name)(*c_args, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
