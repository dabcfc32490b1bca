"""What each kernel's call costs: one formula per kernel, and the tallies
that add it up.

A formula gives the least work the kernel's function needs on its inputs
(:class:`Cost`): the operations it must do, at the rate of the units that
do them, and the bytes it must move, each input read once and each output
written once. ``chip_smoke.py``'s bound column and the dry run's count of a
kernel (``launch/dryrun.py``) read the same formula, so the two are the
same number. :meth:`Cost.bound` turns one into the least time on an H100
SXM (the published peaks below).

A wrapper calls :func:`charge` where it launches its kernel and, on the
``meta`` device, where it would have: every open tally (:func:`tally`)
adds the kernel's cost. With no tally open a call costs one check, and
the formula is not evaluated. The port's explicit
collectives (``distributed/sharding.py``) add their bytes the same way
(:func:`collective`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores, dense bf16 FLOP/s on the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TC_FLOPS = 989e12
# exp2 results/s of the special-function units: 132 SMs x 16 a clock
# (compute capability 9.0) x 1.83 GHz, the clock behind the 989 TFLOP/s
SFU_PER_S = 132 * 16 * 1.83e9
RATES = {"f32": F32_FLOPS, "bf16_tc": BF16_TC_FLOPS}

# d1's tensor-core route: one N tile holds 21 landmarks, and a tile's
# products per (row, item) are 2 · (24 + 48 + 64) (the moments' planes)
D1_N_TILE, D1_TILE_PRODUCTS = 21, 136


@dataclasses.dataclass(frozen=True)
class Cost:
    """The least work of one call: ``ops`` operations at ``rate``'s peak
    (``RATES``), ``exps`` exponentials on the special-function units
    beside them, ``bytes`` moved."""

    ops: float
    bytes: float
    rate: str = "f32"
    exps: float = 0.0

    def bound(self):
        """(least ms, what sets it: "bytes" or "operations")."""
        t_bytes = self.bytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(self.ops / RATES[self.rate] * 1e3,
                    self.exps / SFU_PER_S * 1e3)
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")


def masked_similarity(a: int, b: int, p: int, tensor_core: bool) -> Cost:
    """d1 on (a, p) against (b, p): r_a and r_b read once, the (a, b)
    output written once; the tensor-core route's bf16 products,
    2·a·p·136 per N tile of 21 landmarks, at the tensor cores' rate, or
    the f32 route's 12·a·b·p FMA work at the f32 rate."""
    nbytes = 4 * (a * p + b * p + a * b)
    if not tensor_core:
        return Cost(12 * a * b * p, nbytes)
    return Cost(2 * a * p * D1_TILE_PRODUCTS * -(-b // D1_N_TILE), nbytes,
                "bf16_tc")


def topk(rows: int, c: int, n: int, k: int) -> Cost:
    """Kernels 2 and 3, each of ``rows`` queries against ``c`` candidates
    of width n: both read once, the (rows, k) values and ids written once;
    a dot product (2n) a (query, candidate) pair."""
    return Cost(2 * rows * c * n, 4 * (rows * n + c * n + 2 * rows * k))


def kmeans(u: int, c: int, n: int, iters: int) -> Cost:
    """Kernel 4, a whole k-means of ``iters`` steps (0: the assignment
    alone): the rows and centroids read once, the centroids and the
    assignment written once; iters + 1 assignments of 2·u·c·n."""
    return Cost((iters + 1) * 2 * u * c * n, 4 * (u * n + 2 * c * n + u))


def fused_probe(b: int, nprobe: int, c: int, cap: int, n: int, k: int,
                live: int, stored: int, row_bytes: int = 4) -> Cost:
    """Kernel 5: the queries, probes, lists, rows (``row_bytes`` an
    element), fill and self ids read once, the (b, k) lists written once;
    a dot product and a 3-op epilogue for each of the ``live`` (query,
    live slot) pairs, and a squared norm once a distinct row (``stored``
    live rows and the b queries)."""
    return Cost(live * (2 * n + 3) + 2 * n * (stored + b),
                4 * (b * n + b * nprobe + c * cap + c + b)
                + row_bytes * c * cap * n + 8 * b * k)


def score_candidates(b: int, m: int, n: int, shared: bool) -> Cost:
    """Kernel 6: ``b`` queries against their own ``m`` gathered candidates
    (each one's norm too), or against one shared block of ``m`` rows
    (each norm once); the inputs read once, the (b, m) scores written
    once."""
    if shared:
        return Cost(b * m * (2 * n + 3) + 2 * n * (b + m),
                    4 * (b * n + m * n + b * m))
    return Cost(b * m * (4 * n + 3) + 2 * n * b,
                4 * (b * n + b * m * n + b * m))


def landmark_summary(p: int, n: int, s: int, d: int, bf16: bool) -> Cost:
    """Kernel 7, p problems of softmax(q̃Kᵀ·scale)V with f32 results, on
    the route of the inputs' dtype: the bytes moved, and the bf16
    products on the tensor cores (exact products, f32 sums) beside one
    exp per score on the special-function units.

    bf16 inputs: q, k, v read once, the f32 output written once; q̃Kᵀ, and
    PV with the f32 probabilities split into two bf16 terms: 3 products of
    2·n·S·D. f32 inputs: q, k, v (f32) read once, their bf16 planes (three
    terms of q and k, two of v) written once and read once, the output
    written once; six products for q̃Kᵀ and three for PV: 9 of 2·n·S·D."""
    q_el, kv_el = p * n * d, p * s * d
    if bf16:
        moved, products = 2 * (q_el + 2 * kv_el), 3
    else:
        planes = 3 * q_el + 3 * kv_el + 2 * kv_el
        moved, products = 4 * (q_el + 2 * kv_el) + 2 * 2 * planes, 9
    return Cost(p * products * 2 * n * s * d, moved + 4 * q_el, "bf16_tc",
                p * n * s)


def landmark_summary_bwd(p: int, n: int, s: int, d: int, bf16: bool
                         ) -> Cost:
    """Kernel 7's backward for p problems: q, k, v (the inputs' dtype),
    out and dout (f32) read once, dq, dk, dv (f32) written once; five
    products of 2·n·S·D (q kᵀ, dO Vᵀ, Pᵀ dO, dS K, dSᵀ q) at the bf16
    tensor-core rate beside one exp per score."""
    el = 2 if bf16 else 4
    q_el, kv_el = p * n * d, p * s * d
    moved = el * (q_el + 2 * kv_el) + 4 * 2 * q_el + 4 * (q_el + 2 * kv_el)
    return Cost(p * 5 * 2 * n * s * d, moved, "bf16_tc", p * n * s)


def segment_sum(h: int, live: int, n: int, elem: int) -> Cost:
    """Row 8, one segment sum: every live edge's row of x read once, the
    (n, h) output written once, perm and indptr read once; one add per
    element read, at the f32 rate."""
    return Cost(live * h, elem * h * (live + n) + 4 * live + 4 * (n + 1))


# the tallies open in this process: a process's, not a thread's, since
# autograd runs a CUDA backward's kernels on a thread of its own
_OPEN: list = []
_LOCK = threading.Lock()


@contextlib.contextmanager
def tally():
    """Add up, inside the block, every kernel's cost by wrapper name
    (``{"kernels": {name: [calls, ops, bytes]}}``) and every collective's
    count and bytes by kind (``{"collectives": {kind: [count, bytes]}}``)
    into the dict it yields. Calls on every thread count: open a tally
    where nothing else runs."""
    report: Dict[str, dict] = {"kernels": {}, "collectives": {}}
    with _LOCK:
        _OPEN.append(report)
    try:
        yield report
    finally:
        with _LOCK:
            _OPEN.remove(report)


def charge(name: str, formula: Callable[[], Cost]) -> None:
    """Add the cost ``formula()`` of one call of kernel ``name`` to every
    open tally (none open: one check, and no evaluation)."""
    if not _OPEN:
        return
    c = formula()
    with _LOCK:
        for report in _OPEN:
            row = report["kernels"].setdefault(name, [0, 0.0, 0.0])
            row[0] += 1
            row[1] += c.ops
            row[2] += c.bytes


def collective(kind: str, nbytes: int) -> None:
    """Add one collective of ``kind`` that moved ``nbytes`` to every open
    tally."""
    if not _OPEN:
        return
    with _LOCK:
        for report in _OPEN:
            row = report["collectives"].setdefault(kind, [0, 0])
            row[0] += 1
            row[1] += int(nbytes)
