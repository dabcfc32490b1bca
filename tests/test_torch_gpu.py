"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``gpu`` marker and takes the ``cuda`` fixture,
which decides whether a card is present and skips without one. On the
H100: ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py`` from the root of
the checkout (the first test builds the kernels into ``build/kernels/``).

Tolerances:
- d1 cosine on integer ratings: bitwise equal (exact moments, the same
  IEEE epilogue); pearson and euclidean: rtol=1e-5, atol=1e-6; d1's
  tensor-core route against its f32 route: bitwise, every measure (exact
  moments on values its guard admits; the f32 route's own result where a
  value fails the guard);
- the top-k kernels: bitwise equal values and ids — the plain version
  repeats the kernel's summation order and epilogue op for op;
- the Lloyd kernel (a whole k-means, or the assignment alone), the
  gathered-candidate scorer and the fused IVF probe (f32, bf16 and int8
  payloads): bitwise equal to their plain versions, for the same reason;
  two Lloyd launches on the same inputs bitwise equal to each other;
- the landmark summary (both routes on the tensor cores: bf16 inputs as
  they are, f32 inputs split into bf16 terms): rtol=1e-4, atol=1e-5, the
  reference's own kernel-vs-oracle tolerance — a streamed softmax with
  running max and denominator against a dense f32 one (P is split into two
  bf16 terms, f32 q and k into three, to stay inside it);
- the f32 route's split pass: bitwise equal to the same rounding in torch;
- kernel 7's backward: within 1e-4 of each gradient's largest |value| of
  its plain version (f32 FMAs summed in another order), two calls
  bitwise equal; through the autograd Function, within 1e-3 of autograd
  of the plain f32 forward (the forward kernel's error enters Δ), plus
  2^-8 for bf16 inputs (their gradients are rounded to bf16);
- the MF baselines on the card against the CPU from the same initial
  parameters and permutations, and one BPMF Gibbs sweep on the same draws:
  within atol=1e-4 (f32 sums in other orders; the card's gathers
  accumulate their backward in an order of their own);
- compact (uint16/bf16) graph reads against the widened graph's:
  rtol=atol=2e-2, the reference's bf16 bound; the uint16 gather's ids
  equal;
- the segment sum (the GNN's message passing), f32 and bf16: bitwise its
  plain version (the same adds in the same order) and two launches
  bitwise, at the four index kinds and the schedule's cases (each width
  class of H, a 5,000-member segment, degrees at the heavy threshold,
  every edge masked, no edge); a GatedGCN train step's loss and gradients
  twice bitwise; a recsys lookup's backward (the segment sum over a CSR of
  its ids) bitwise its plain version and itself at a small FM and BERT4Rec
  CSR, and a recsys train step twice bitwise;
- a landmark-attention forward through the kernel against the same
  forward with the plain summary, bf16: within 5% of the largest logit
  (the kernel's f32 sums in another order, rounded to bf16 on the way
  out, then two layers of bf16 products).
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import similarity as sim
from repro_torch.core.graph import kernel_rows
from repro_torch.kernels import (assign_clusters, ivf_probe, knn_topk, ops,
                                 ref, score_candidates)
from repro_torch.kernels import landmark_attention as lsum
from repro_torch.kernels import masked_similarity as ms
from repro_torch.kernels import segment_sum as segsum

pytestmark = pytest.mark.gpu
RTOL, ATOL = 1e-5, 1e-6
_spec = importlib.util.spec_from_file_location(
    "time_segment_sum",
    Path(__file__).resolve().parents[1] / "tools" / "time_segment_sum.py")
segsum_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(segsum_tool)
MEASURES = sim.MEASURES


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ratings(u, p, device, density=0.3, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    return torch.as_tensor(r * (rng.random((u, p)) < density), device=device)


def _rep(u, n, device, seed=0):
    r = _ratings(u, 200, device, seed=seed)
    return sim.masked_similarity(r, r[:n])


def _rows(u, n, device, seed=0):
    """u representation rows of width n (any u)."""
    return _rep(max(u, n), n, device, seed=seed)[:u].contiguous()


@pytest.mark.parametrize("route", ["auto", "f32"])
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("shape", [(1000, 130, 777), (64, 20, 3952),
                                   (5, 3, 1), (33, 1, 70)])
def test_masked_similarity_kernel_matches_plain(cuda, measure, shape, route):
    a, b, p = shape
    r = _ratings(a + b, p, cuda, seed=1)
    got = ops.masked_similarity(r[:a], r[a:], measure, route=route)
    want = ref.masked_similarity_ref(r[:a], r[a:], measure)
    torch.cuda.synchronize()
    if measure == "cosine":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def _d1_routes(r_a, r_b, measure):
    """(tensor-core route's output, f32 route's output), the launch and
    result counts checked: the first call launched the tensor-core route
    and kept its result."""
    ops.reset_launches()
    got = ops.masked_similarity(r_a, r_b, measure)
    want = ops.masked_similarity(r_a, r_b, measure, route="f32")
    assert ms.masked_similarity.route_launches == {"tensor_core": 1,
                                                   "f32": 1}
    assert ms.route_results() == {"tensor_core": 1, "f32_fallback": 0}
    return got, want


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("shape", [(5976, 20, 3952), (64, 20, 3952),
                                   (1000, 130, 777), (300, 20, 777),
                                   (200, 7, 1), (65, 20, 3952),
                                   (5976, 128, 3952), (64, 128, 3952),
                                   (333, 33, 3952), (333, 80, 3952)])
def test_masked_similarity_tc_route_is_bitwise_the_f32_route(cuda, measure,
                                                             shape):
    """On ratings the tensor-core route's moments are exact: every measure
    bitwise the f32 route's, and cosine bitwise the plain version — at the
    ML-1M fit and fold-in shapes, B over seven N tiles, P % 16 != 0,
    P = 1, A = 65 (a second row tile of one row), and the cluster kernel's
    (22..128 landmarks on 16-byte rows): 128 landmarks at the fit and
    fold-in shapes, 33 (a second, ragged N tile of 32), 80 (a cluster of
    3: its ranks multicast 3, 3 and 2 of a stage's 8 boxes and guard
    uneven shares of its chunks)."""
    a, b, p = shape
    r = _ratings(a + b, p, cuda, density=0.08 if a > 1000 else 0.3, seed=8)
    got, want = _d1_routes(r[:a], r[a:], measure)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if measure == "cosine":
        assert torch.equal(got, ref.masked_similarity_ref(r[:a], r[a:],
                                                          measure))


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("p", [ref.D1_HALF_ITEMS - 3, ref.D1_HALF_ITEMS])
def test_masked_similarity_tc_route_is_exact_at_the_guards_limits(cuda,
                                                                  measure, p):
    """Values ±8, ±7.5 and ½ at the largest P the route takes half stars
    at (16-byte and 4-byte loads): x and y reach 64·P, just under 2^22,
    and the tensor cores' f32 sums must stay exact — bitwise the f32
    route."""
    rng = np.random.default_rng(9)
    vals = rng.choice([-8.0, -7.5, 0.5, 7.5, 8.0], (130 + 25, p))
    vals *= rng.random(vals.shape) < 0.7
    vals[:3] = 8.0  # no zero: sums at their largest
    vals[130:133] = -8.0
    r = torch.as_tensor(vals.astype(np.float32), device=cuda)
    assert ref.d1_guard_ref(r)
    got, want = _d1_routes(r[:130], r[130:], measure)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_masked_similarity_off_the_guard_takes_the_f32_result(cuda):
    """Values the route cannot hold (0.1 steps in r_a; one 0.3 or NaN in
    the landmarks): the f32 route's output replaces the tensor-core
    route's, with no host sync, and the card counts the replacement. At
    D1_HALF_ITEMS + 1 items whole stars stay on the tensor-core route and
    keep its result; past D1_MAX_ITEMS the host sends the call to the f32
    route."""
    r = _ratings(300, 777, cuda, seed=10)
    tenths = r[:280] * 1.1  # 1.1, 2.2, ...: off the guard
    lm = r[280:].clone()
    lm_bad = lm.clone()
    lm_bad[3, 5] = 0.3
    lm_nan = lm.clone()
    lm_nan[7, 11] = float("nan")
    ops.reset_launches()
    for i, (ra, rb) in enumerate(((tenths, lm), (r[:280], lm_bad),
                                  (r[:280], lm_nan))):
        for measure in MEASURES:
            got = ops.masked_similarity(ra, rb, measure)
            want = ops.masked_similarity(ra, rb, measure, route="f32")
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       equal_nan=True)
    assert ms.masked_similarity.route_launches == {"tensor_core": 9,
                                                   "f32": 9}
    assert ms.route_results() == {"tensor_core": 0, "f32_fallback": 9}
    ints = _ratings(3, ref.D1_HALF_ITEMS + 1, cuda, seed=11)
    ops.reset_launches()
    got = ops.masked_similarity(ints[:2], ints[2:])
    assert ms.masked_similarity.route_launches == {"tensor_core": 1,
                                                   "f32": 0}
    assert ms.route_results() == {"tensor_core": 1, "f32_fallback": 0}
    assert torch.equal(got, ref.masked_similarity_ref(ints[:2], ints[2:]))
    wide = _ratings(3, ref.D1_MAX_ITEMS + 1, cuda, seed=11)
    ops.reset_launches()
    got = ops.masked_similarity(wide[:2], wide[2:])
    assert ms.masked_similarity.route_launches == {"tensor_core": 0,
                                                   "f32": 1}
    assert ms.route_results() == {"tensor_core": 0, "f32_fallback": 0}
    assert torch.equal(got, ref.masked_similarity_ref(wide[:2], wide[2:]))


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("b", [128, 20])
@pytest.mark.parametrize("p", [ref.D1_HALF_ITEMS + 1, ref.D1_MAX_ITEMS - 3,
                               ref.D1_MAX_ITEMS])
def test_masked_similarity_tc_route_is_exact_past_the_half_star_limit(
        cuda, measure, b, p):
    """Integers ±8, -3 and 5 with 30% missing past 65,535 items, and
    three rows of each operand with no zero (x, y and |z| reach 64·P,
    just under 2^24 at P = 262,143): bitwise the f32 route, the result
    kept. P = 65,536 and 262,140 take 16-byte loads (B = 128: the cluster
    kernel, 4 N tiles of 32 landmarks), 262,143 4-byte loads (7 N tiles of
    21); B = 20 one N tile of 21."""
    rng = np.random.default_rng(14)
    vals = rng.choice([-8.0, -3.0, 5.0, 8.0], (130 + b, p))
    vals *= rng.random(vals.shape) < 0.7
    vals[:3] = 8.0
    vals[130:133] = -8.0
    r = torch.as_tensor(vals.astype(np.float32), device=cuda)
    assert ref.d1_guard_ref(r)
    got, want = _d1_routes(r[:130], r[130:], measure)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("b", [128, 20])
def test_masked_similarity_half_stars_past_65535_items_take_the_f32_result(
        cuda, b):
    """Half stars at P = 65,536 fail the guard on the card: the finalize
    launch computes the f32 route, bitwise, and the card counts the
    replacement."""
    rng = np.random.default_rng(15)
    vals = rng.integers(1, 11, (300 + b, ref.D1_HALF_ITEMS + 1)) / 2
    vals *= rng.random(vals.shape) < 0.05
    r = torch.as_tensor(vals.astype(np.float32), device=cuda)
    ops.reset_launches()
    for measure in MEASURES:
        got = ops.masked_similarity(r[:300], r[300:], measure)
        want = ops.masked_similarity(r[:300], r[300:], measure, route="f32")
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert ms.masked_similarity.route_launches == {"tensor_core": 3,
                                                   "f32": 3}
    assert ms.route_results() == {"tensor_core": 0, "f32_fallback": 3}


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("u,n,k", [(1001, 20, 13), (300, 64, 32), (50, 1, 1),
                                   (40, 33, 17), (500, 100, 13),
                                   (130, 104, 32)])
def test_topk_sim_kernel_matches_plain(cuda, measure, u, n, k):
    rep = kernel_rows(_rep(u, n, cuda, seed=2), measure)
    got = knn_topk.topk_sim(rep, rep, k, exclude_self=True, n_valid=u - 7,
                            measure=measure)
    want = ref.topk_sim_ref(rep, rep, k, exclude_self=True, n_valid=u - 7,
                            measure=measure)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("b,c", [(37, 1001), (64, 6104), (3, 5)])
def test_foldin_topk_kernel_matches_plain(cuda, measure, b, c):
    rep = kernel_rows(_rep(c, 20, cuda, seed=3), measure)
    q = rep[c - b:].contiguous()
    got = knn_topk.foldin_topk(q, rep, 13, self_offset=c - b, measure=measure)
    want = ref.foldin_topk_ref(q, rep, 13, self_offset=c - b, measure=measure)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _scan_plan(rows, c, n, k, device):
    """(variant, (QT, CT), splits, tiles a split) the wrapper takes."""
    variant = (knn_topk.LARGE_VARIANT if rows > knn_topk.SMALL_ROWS
               else knn_topk.SMALL_VARIANT)
    sms, per_sm = knn_topk._occupancy(device.index or 0, variant, n,
                                      "cosine")
    return (variant, knn_topk.SCAN_VARIANTS[variant],
            *knn_topk.plan_scan(rows, c, variant, sms, per_sm,
                                knn_topk.MIN_TILES, knn_topk.MAX_SPLITS))


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("u", [65, 300, 17, 257])
def test_topk_sim_rows_not_a_multiple_of_the_query_tile(cuda, measure, u):
    """Query blocks with rows past U (both variants: U <= 256 and above)."""
    _, (qt, _), _, _ = _scan_plan(u, u, 20, 13, cuda)
    assert u % qt
    rep = kernel_rows(_rep(u, 20, cuda, seed=6), measure)
    got = knn_topk.topk_sim(rep, rep, 13, exclude_self=True, measure=measure)
    want = ref.topk_sim_ref(rep, rep, 13, exclude_self=True, measure=measure)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("u,c", [(300, 40), (20, 7)])
def test_topk_fewer_candidates_than_one_tile(cuda, measure, u, c):
    """C below one candidate tile (and, at C = 7, below k): one ragged
    tile, empty slots (-inf, 0)."""
    rep = kernel_rows(_rep(u, 20, cuda, seed=7), measure)
    cand = rep[:c].contiguous()
    _, (_, ct), splits, _ = _scan_plan(u, c, 20, 13, cuda)
    assert c < ct and splits == 1
    got = knn_topk.topk_sim(rep, cand, 13, measure=measure)
    want = ref.topk_sim_ref(rep, cand, 13, measure=measure)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("measure", MEASURES)
def test_topk_split_boundary_at_n_valid(cuda, measure):
    """n_valid on the first split boundary: the splits past it hold only
    masked candidates and must return empty lists to the merge."""
    u = 1001
    _, (_, ct), splits, tps = _scan_plan(u, u, 20, 13, cuda)
    assert splits > 1
    n_valid = tps * ct
    rep = kernel_rows(_rep(u, 20, cuda, seed=8), measure)
    got = knn_topk.topk_sim(rep, rep, 13, exclude_self=True, n_valid=n_valid,
                            measure=measure)
    want = ref.topk_sim_ref(rep, rep, 13, exclude_self=True, n_valid=n_valid,
                            measure=measure)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("measure", MEASURES)
def test_topk_sim_fit_shape_bitwise(cuda, measure):
    """The graph build's shape: U = C = 5976, n = 20, k = 13, self
    excluded."""
    rep = kernel_rows(_rep(5976, 20, cuda, seed=9), measure)
    got = knn_topk.topk_sim(rep, rep, 13, exclude_self=True, measure=measure)
    want = ref.topk_sim_ref(rep, rep, 13, exclude_self=True, measure=measure)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("measure", MEASURES)
def test_topk_duplicated_rows_tie_to_lowest_id(cuda, measure):
    """Triples of identical rows: equal scores must break to the lowest id,
    exactly as the plain version's stable sort breaks them."""
    base = _rep(200, 20, cuda, seed=4)
    rep = kernel_rows(base.repeat_interleave(3, dim=0), measure)
    got = knn_topk.topk_sim(rep, rep, 13, exclude_self=True, measure=measure)
    want = ref.topk_sim_ref(rep, rep, 13, exclude_self=True, measure=measure)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_fit_on_the_card_matches_plain_versions(cuda):
    """A small fit and fold-in through the kernels equals the same run with
    the plain d1 and the streaming graph, under the tie rule; the kernels
    launched, and the plain run launched none."""
    from repro_torch.core.topk import list_mismatches

    r = _ratings(700, 300, cuda, seed=5)
    spec = T.LandmarkSpec(n_landmarks=20, k_neighbors=13)
    ops.reset_launches()
    a = T.fold_in(T.fit(T.RatingMatrix(r[:650], 650, 300), spec), r[650:],
                  spec)
    counts = ops.launch_counts()
    graph_path = ("masked_similarity", "topk_sim", "foldin_topk")
    assert all(counts[name] > 0 for name in graph_path), counts
    ops.reset_launches()
    b = T.fold_in(T.fit(T.RatingMatrix(r[:650], 650, 300), spec,
                        sim_fn=sim.masked_similarity, backend="streaming"),
                  r[650:], spec, sim_fn=sim.masked_similarity,
                  backend="streaming")
    assert all(v == 0 for v in ops.launch_counts().values())
    assert torch.equal(a.landmark_idx, b.landmark_idx)
    assert torch.equal(a.representation, b.representation)
    assert list_mismatches(b.graph.weights, b.graph.indices, a.graph.weights,
                           a.graph.indices).size == 0


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    r = _ratings(10, 8, cuda)
    with pytest.raises(ValueError, match="float32"):
        ops.masked_similarity(r.double(), r.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.masked_similarity(r.T, r.T)
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.masked_similarity(r, r.cpu())
    with pytest.raises(ValueError, match="route"):
        ops.masked_similarity(r, r, route="tensor_core")
    rep = _rows(80, knn_topk.NARROW_WIDTH + 1, cuda)  # the wide route
    assert knn_topk.topk_sim(rep, rep, 5)[1].shape == (80, 5)
    empty = torch.empty((80, 0), device=cuda)
    with pytest.raises(ValueError, match="width 0"):
        knn_topk.topk_sim(empty, empty, 5)
    with pytest.raises(ValueError, match="k=33"):
        knn_topk.topk_sim(rep[:, :20].contiguous(), rep[:, :20].contiguous(),
                          33)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("u,c,n", [(5976, 77, 20), (1001, 13, 64),
                                   (37, 300, 33), (9, 1, 1)])
def test_assign_clusters_kernel_matches_plain(cuda, measure, u, c, n):
    rep = _rows(u, n, cuda, seed=6)
    cent = kernel_rows(rep[torch.randperm(u, device=cuda)[:c]]
                       if c <= u else rep[:1].repeat(c, 1), measure)
    rep = kernel_rows(rep, measure)
    got = assign_clusters.assign_clusters(rep, cent, measure)
    want = ref.assign_clusters_ref(rep, cent, measure)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)


def _bits(x):
    """A tensor compared bit for bit (f32 as its int32 pattern: -0.0 is
    not +0.0)."""
    return x.contiguous().view(torch.int32) if x.is_floating_point() else x


def _lloyd_case(cuda, measure, iters, rep, init, n_valid=None):
    got = assign_clusters.kmeans_lloyd(rep, init, iters, n_valid, measure)
    again = assign_clusters.kmeans_lloyd(rep, init, iters, n_valid, measure)
    want = ref.kmeans_lloyd_ref(rep, init, iters, n_valid, measure)
    torch.cuda.synchronize()
    assert got[1].dtype == torch.int32 and got[0].shape == init.shape
    for g, w, a in zip(got, want, again):
        assert torch.equal(_bits(g), _bits(w))
        assert torch.equal(_bits(g), _bits(a))
    return got


@pytest.mark.parametrize("iters", [0, 1, 8])
@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("u,c,n,n_valid", [
    (5976, 77, 20, None), (1001, 13, 64, None), (37, 300, 33, None),
    (9, 1, 1, None), (300, 7, 25, None),  # every register width
    # the lifecycle's capacity buckets: full width and smoke size
    (8192, 78, 20, 6040), (256, 12, 20, 128)])
def test_kmeans_lloyd_kernel_matches_plain(cuda, iters, measure, u, c, n,
                                           n_valid):
    rep = _rows(u, n, cuda, seed=6)
    nv = u if n_valid is None else n_valid
    rep[nv:] = 0.0  # a bucket's padding rows
    init = (rep[torch.randperm(nv, device=cuda)[:c]] if c <= nv
            else rep[:1].repeat(c, 1)).contiguous()
    _lloyd_case(cuda, measure, iters, rep, init, n_valid)


@pytest.mark.parametrize("u,c,n_valid,iters,measures", [
    # windows of assignments (n_valid > 8192) and staging rounds (a cell of
    # more than 612 members at n = 20)
    (20000, 3, None, 2, MEASURES),
    # more rows a block than one pass and one prepare chunk hold
    (80000, 4, 79000, 1, ("cosine",))])
def test_kmeans_lloyd_large_shapes(cuda, u, c, n_valid, iters, measures):
    rep = torch.as_tensor(np.random.default_rng(9).normal(
        size=(u, 20)).astype(np.float32), device=cuda)
    init = rep[:c].contiguous()
    for measure in measures:
        _lloyd_case(cuda, measure, iters, rep, init, n_valid)


def test_kmeans_lloyd_empty_cells_and_no_valid_rows(cuda):
    rep = _rows(500, 20, cuda, seed=7)
    far = torch.full((1, 20), 50.0, device=cuda)
    init = torch.cat([rep[:5], far]).contiguous()
    cent, assign = _lloyd_case(cuda, "euclidean", 8, rep, init)
    assert not (assign == 5).any() and torch.equal(cent[5], far[0])
    for measure in MEASURES:
        cent, _ = _lloyd_case(cuda, measure, 8, rep, init, n_valid=0)
        assert torch.equal(_bits(cent), _bits(init))


def test_kmeans_on_the_card_is_one_launch_and_reproducible(cuda):
    """``kmeans(backend="auto")`` runs the whole Lloyd loop in one launch,
    and two index builds from one seed are bitwise equal."""
    import repro_torch.retrieval as R

    rep = _rows(3000, 20, cuda, seed=8)
    init = rep[:40].contiguous()
    ops.reset_launches()
    cent, assign = R.kmeans(rep, 40, "cosine", init=init)
    assert assign_clusters.assign_clusters.launches == 1
    want = assign_clusters.kmeans_lloyd(rep, init, 8)
    assert torch.equal(_bits(cent), _bits(want[0]))
    assert torch.equal(assign, want[1])
    spec = R.resolve_ivf(None, 3000)
    a, b = (R.build_index(rep, spec, "cosine", n_valid=2900)
            for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(_bits(a.centroids), _bits(b.centroids))
    for x, y in ((a.lists, b.lists), (a.fill, b.fill)):
        assert torch.equal(x, y)
    assert torch.equal(_bits(a.rows), _bits(b.rows))


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("b,m,n", [(256, 1976, 20), (5, 130, 64), (1, 1, 3)])
def test_score_candidates_kernel_matches_plain(cuda, measure, b, m, n):
    q = _rows(b, n, cuda, seed=7)
    cand = _rows(b * m, n, cuda, seed=8).reshape(b, m, n)
    got = score_candidates.score_candidates(q, cand, measure)
    want = ref.score_candidates_ref(q, cand, measure)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("c,m,n", [(8192, 64, 20), (2048, 64, 20),
                                   (300, 64, 100), (129, 7, 104), (1, 1, 3)])
def test_score_candidates_shared_form_matches_plain(cuda, measure, c, m, n):
    """The shared form (one (m, n) block for every query), the back-patch
    of the fold-ins: bitwise ``gathered_sims``, and counted once a call."""
    q, cand = _rows(c, n, cuda, seed=9), _rows(m, n, cuda, seed=10)
    n0 = score_candidates.score_candidates.launches
    got = score_candidates.score_candidates(q, cand, measure)
    torch.cuda.synchronize()
    assert score_candidates.score_candidates.launches == n0 + 1
    assert torch.equal(got, ref.gathered_sims(q, cand, measure))


def _ivf_layout(device, c, cap, n, seed, payload="f32", empty=(0,)):
    """A posting-list layout: ragged fills (``empty`` cells hold nothing),
    ids a permutation, payload rows from d1 representations."""
    rng = np.random.default_rng(seed)
    fill = rng.integers(1, cap + 1, c)
    fill[list(empty)] = 0
    u = int(fill.sum())
    lists = np.zeros((c, cap), np.int32)
    ids = rng.permutation(u)
    o = 0
    for j in range(c):
        lists[j, :fill[j]] = ids[o:o + fill[j]]
        o += fill[j]
    rep = _rows(max(u, 1), n, device, seed=seed)
    rows = torch.zeros((c, cap, n), device=device)
    for j in range(c):
        rows[j, :fill[j]] = rep[torch.as_tensor(lists[j, :fill[j]].astype(
            np.int64), device=device)]
    scale = None
    if payload == "bf16":
        rows = rows.to(torch.bfloat16)
    elif payload == "int8":
        amax = rows.abs().amax(-1)
        scale = amax / torch.full_like(amax, 127.0)
        rows = torch.round(rows / scale.clamp(min=1e-8)[..., None]).to(
            torch.int8)
    return (torch.as_tensor(lists, device=device), rows, scale,
            torch.as_tensor(fill.astype(np.int32), device=device), rep)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("payload", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,c,cap,n,nprobe,k,variant", [
    (5976, 77, 104, 20, 19, 13, "random"), (300, 13, 40, 64, 13, 32, "random"),
    (40, 6, 70, 20, 2, 13, "random"), (17, 5, 3, 7, 2, 13, "random"),
    # batch sizes at the group edges (G = 1, 2, 4, 8; partial last groups)
    (1, 77, 104, 20, 19, 13, "random"), (63, 77, 104, 20, 19, 13, "random"),
    (64, 77, 104, 20, 19, 13, "random"), (257, 77, 104, 20, 19, 13, "random"),
    (601, 77, 104, 20, 19, 13, "random"),
    (1055, 77, 104, 20, 19, 13, "random"),
    (2105, 77, 104, 20, 19, 13, "random"),
    # every query with one home cell; a home cell that is empty
    (5976, 77, 104, 20, 19, 13, "one_home"),
    (257, 77, 104, 20, 19, 13, "one_home"),
    (2105, 77, 104, 20, 19, 13, "empty_home"),
    # nprobe = C
    (5976, 77, 104, 20, 77, 13, "random"), (64, 77, 104, 20, 77, 13, "random"),
    # cap regrown past 128, and past one round of 256 rows
    (3000, 20, 200, 20, 7, 13, "random"), (64, 20, 200, 20, 7, 13, "random"),
    (2105, 9, 300, 20, 3, 13, "random"),
    # n = 64 with k = 32 in groups of 8
    (3000, 13, 40, 64, 5, 32, "random"),
    # probe columns past one block's 1024 sorted entries (two segments)
    (3000, 200, 8, 20, 150, 13, "random"),
    # equal scores in different groups and cells; one cell masked for all
    (2105, 11, 50, 20, 4, 13, "ties"), (2105, 11, 50, 20, 6, 13, "drop_cell"),
])
def test_fused_probe_kernel_matches_plain(cuda, measure, payload, b, c, cap,
                                          n, nprobe, k, variant):
    """Empty cells, k above the live candidates (the fourth case holds at
    most 6 per query), self ids, a probe_ok mask, C not a multiple of 8,
    every payload type, and what the grouped design makes risky — group
    edges and the split-query route, shared or empty home cells, full
    probes, regrown caps, two segments of probe columns, ties across
    groups and cells, a masked union cell: values and ids bitwise equal."""
    lists, rows, scale, fill, rep = _ivf_layout(cuda, c, cap, n, seed=9,
                                                payload=payload)
    g = torch.Generator(device="cpu").manual_seed(10)
    q = _rows(b, n, cuda, seed=11)
    probe = torch.stack([torch.randperm(c, generator=g)[:nprobe]
                         for _ in range(b)])
    if variant in ("one_home", "empty_home"):  # cell 0 is empty
        home = 0 if variant == "empty_home" else 1
        rest = torch.stack([torch.randperm(c - 1, generator=g)[:nprobe - 1]
                            for _ in range(b)])
        probe = torch.cat([torch.full((b, 1), home),
                           rest + (rest >= home).long()], 1)
    if variant == "ties":  # cells 1 and 2 share rows
        m = int(min(fill[1], fill[2]))
        rows[2, :m] = rows[1, :m]
        if scale is not None:
            scale[2, :m] = scale[1, :m]
    probe = probe.to(torch.int32).to(cuda)
    self_ids = torch.randint(-1, int(fill.sum()), (b,), generator=g
                             ).to(torch.int32).to(cuda)
    probe_ok = (torch.rand((b, nprobe), generator=g) > 0.2).to(
        torch.int32).to(cuda)
    if variant == "ties":  # query 0 again, in other groups
        for t in (q, probe, self_ids, probe_ok):
            t[b // 2::7] = t[0]
    if variant == "drop_cell":
        probe_ok[probe == 3] = 0
    args = (q, probe, lists, rows, scale, fill)
    kw = dict(k=k, measure=measure, self_ids=self_ids, probe_ok=probe_ok)
    got = ivf_probe.fused_probe_topk(*args, **kw)
    want = ref.fused_probe_topk_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if nprobe * cap < k:  # fewer candidates than slots: the tail is empty
        assert torch.isinf(got[0][:, -1]).all()
    if variant == "ties":  # the repeated queries' lists are equal
        assert torch.equal(got[0][b // 2::7], got[0][:1].expand(
            len(range(b // 2, b, 7)), k))


def test_new_wrappers_reject_what_the_kernels_do_not_take(cuda):
    rep = _rows(50, 20, cuda)
    with pytest.raises(ValueError, match="width 0"):
        assign_clusters.assign_clusters(torch.empty((9, 0), device=cuda),
                                        torch.empty((3, 0), device=cuda))
    with pytest.raises(ValueError, match="3-D"):
        score_candidates.score_candidates(rep, rep[0])
    with pytest.raises(ValueError, match="shapes differ"):
        score_candidates.score_candidates(rep, _rows(50, 21, cuda))
    lists, rows, scale, fill, _ = _ivf_layout(cuda, 4, 8, 20, seed=1,
                                              payload="int8")
    probe = torch.zeros((50, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="scales"):
        ivf_probe.fused_probe_topk(rep, probe, lists, rows, None, fill, k=5)
    with pytest.raises(ValueError, match="k=33"):
        ivf_probe.fused_probe_topk(rep, probe, lists, rows, scale, fill, k=33)
    with pytest.raises(ValueError, match="int32"):
        ivf_probe.fused_probe_topk(rep, probe.long(), lists, rows, scale,
                                   fill, k=5)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("n", [100, 104, 105, 128, 256])
def test_ivf_kernels_at_wide_rows_match_plain(cuda, measure, n):
    """Kernels 4-6 past n = 64, on the narrow routes up to 104 and on the
    wide routes past it: the Lloyd kernel at 0 and 8 steps, the fused probe
    on every payload with masked probes and self ids, the scorer — bitwise
    their plain versions."""
    rep = _rows(900, n, cuda, seed=12)
    init = rep[torch.randperm(900, device=cuda)[:30]].contiguous()
    for iters in (0, 8):
        _lloyd_case(cuda, measure, iters, rep, init)
    for payload in ("f32", "bf16", "int8"):
        lists, rows, scale, fill, _ = _ivf_layout(cuda, 13, 40, n, seed=13,
                                                  payload=payload)
        g = torch.Generator(device="cpu").manual_seed(14)
        q = _rows(300, n, cuda, seed=15)
        probe = torch.stack([torch.randperm(13, generator=g)[:5]
                             for _ in range(300)]).to(torch.int32).to(cuda)
        ok = (torch.rand((300, 5), generator=g) > 0.3).to(torch.int32).to(
            cuda)
        sid = lists[probe[:, 0].long(), 0].contiguous()
        args = (q, probe, lists, rows, scale, fill)
        kw = dict(k=13, measure=measure, self_ids=sid, probe_ok=ok)
        got = ivf_probe.fused_probe_topk(*args, **kw)
        want = ref.fused_probe_topk_ref(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    q, cand = _rows(64, n, cuda, seed=16), _rows(64 * 300, n, cuda,
                                                  seed=17).reshape(64, 300, n)
    got = score_candidates.score_candidates(q, cand, measure)
    assert torch.equal(got, ref.score_candidates_ref(q, cand, measure))


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("n", [105, 128, 256])
def test_scan_wide_route_matches_plain(cuda, measure, n):
    """Kernels 2-3 past 104 landmarks (the wide route: queries and
    candidate tiles streamed in slices of the landmark axis): the graph
    build with a ragged ``n_valid`` and self excluded, over the large
    variant with split candidate tiles, and a fold-in batch on the small
    one — values and ids bitwise the plain version's."""
    rep = kernel_rows(_rows(700, n, cuda, seed=n), measure)
    got = knn_topk.topk_sim(rep, rep, 13, exclude_self=True, n_valid=690,
                            measure=measure)
    want = ref.foldin_topk_ref(rep, rep, 13, 0, 690, measure)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    q = rep[650:].contiguous()
    got = knn_topk.foldin_topk(q, rep, 7, self_offset=650, measure=measure)
    want = ref.foldin_topk_ref(q, rep, 7, 650, None, measure)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("n", [1, 20, 100, 104, 105, 128, 256])
def test_score_candidates_both_forms_any_width(cuda, measure, n):
    """Kernel 6's two forms at any width, with ragged edges: per-query
    blocks of m = 1, 129 and 300 candidates; shared blocks of bq = 1, 64
    and 129 against C = 1, 65 and 1000 rows (not multiples of the 64-row
    tile) — bitwise ``gathered_sims``, one launch a call."""
    cases = [(_rows(3, n, cuda, seed=1), _rows(3, n, cuda, seed=2)
              .reshape(3, 1, n)),
             (_rows(5, n, cuda, seed=3), _rows(5 * 129, n, cuda, seed=4)
              .reshape(5, 129, n)),
             (_rows(2, n, cuda, seed=5), _rows(600, n, cuda, seed=6)
              .reshape(2, 300, n))]
    cases += [(_rows(c, n, cuda, seed=c), _rows(bq, n, cuda, seed=bq + 1))
              for c, bq in ((1, 1), (1000, 1), (65, 64), (1000, 129),
                            (1, 129))]
    for q, cand in cases:
        n0 = score_candidates.score_candidates.launches
        got = score_candidates.score_candidates(q, cand, measure)
        torch.cuda.synchronize()
        assert score_candidates.score_candidates.launches == n0 + 1
        assert torch.equal(got, ref.gathered_sims(q, cand, measure)), (
            tuple(q.shape), tuple(cand.shape))


def test_sharded_fit_and_fold_in_on_the_card_bitwise_one_device(cuda):
    """A 4-shard mesh on the card: fit_distributed is ``fit`` bit for bit,
    and after three fold-in waves (a capacity regrow among them) pair
    predictions and top-N equal the single-device bucketed state's."""
    from repro_torch.core.landmark_cf import fit_distributed
    from repro_torch.data.synthetic import drifting_ratings
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.lifecycle import buckets

    mesh = make_mesh(("pod", "data"), (2, 2))
    axes = ("pod", "data")
    spec = T.LandmarkSpec(n_landmarks=20, selection="coresets")
    r0 = torch.as_tensor(drifting_ratings(0, 0, 1501, 400, n_waves=4),
                         device=cuda)
    st = fit_distributed(r0, spec, mesh, axes,
                         generator=torch.Generator().manual_seed(0))
    one = T.fit(T.RatingMatrix(r0, 1501, 400), spec,
                generator=torch.Generator().manual_seed(0))
    assert torch.equal(st.representation, one.representation)
    assert torch.equal(st.graph.indices, one.graph.indices)
    assert torch.equal(st.graph.weights, one.graph.weights)
    ops.reset_launches()
    sst = buckets.from_state_sharded(st, mesh, axes, 64)
    bst = buckets.from_state(one, 256)
    u_per = -(-1501 // 4)
    shards, slots = np.arange(1501) // u_per, np.arange(1501) % u_per
    rng = np.random.default_rng(3)
    for w in range(1, 4):
        arr = drifting_ratings(0, w, 200, 400, n_waves=4)
        sst, fsh, fsl = buckets.fold_in_rows_sharded(sst, arr, 64, spec, 64)
        bst = buckets.fold_in_rows(bst, arr, 64, spec, 256)
        shards, slots = (np.concatenate([shards, fsh]),
                         np.concatenate([slots, fsl]))
        pu = rng.integers(0, len(shards), 256)
        sid = torch.as_tensor(shards[pu] * sst.capacity + slots[pu],
                              device=cuda)
        items = torch.as_tensor(rng.integers(0, 400, 256), device=cuda)
        assert torch.equal(buckets.predict_pairs_sharded(sst, sid, items),
                           buckets.predict_pairs(
                               bst, torch.as_tensor(pu, device=cuda), items))
        ta, sa = buckets.recommend_topn_sharded(sst, sid, 10)
        tb, sb = buckets.recommend_topn(bst, torch.as_tensor(pu,
                                                             device=cuda), 10)
        assert torch.equal(ta, tb) and torch.equal(sa, sb)
    counts = ops.launch_counts()
    assert counts["foldin_topk"] >= 4 * 12 and counts["masked_similarity"]
    assert all(b.is_cuda for b in sst.ratings + sst.representation)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("p,n,s,d", [(1, 64, 1024, 64), (1, 128, 2048, 128),
                                     (1, 32, 512, 256), (1, 16, 777, 32),
                                     (3, 100, 70, 64), (10, 1536, 4096, 64),
                                     (3, 70, 777, 32), (2, 130, 300, 128),
                                     (2, 200, 777, 256), (1, 100, 60, 256),
                                     (2, 50, 20, 128), (3, 65, 1000, 256)])
def test_landmark_summary_kernel_matches_plain(cuda, dtype, p, n, s, d):
    """The reference tests' shapes, ragged S and n at every head dim with
    P > 1, S below one key tile (of either route), and the SmolLM-360M
    landmark shape (10 problems of G·n = 1536 landmark queries against
    S = 4096)."""
    g = torch.Generator(device=cuda).manual_seed(n + s)
    q, k, v = (torch.randn((p, rows, d), generator=g, device=cuda).to(dtype)
               for rows in (n, s, s))
    before = lsum.landmark_summary.launches
    route = lsum.ROUTES[dtype][0]
    routed = lsum.landmark_summary.route_launches[route]
    got = ops.landmark_summary(q, k, v)
    want = ref.landmark_summary_ref(q, k, v, 1.0 / np.sqrt(d))
    torch.cuda.synchronize()
    assert lsum.landmark_summary.launches == before + 1
    assert lsum.landmark_summary.route_launches[route] == routed + 1
    assert got.dtype == torch.float32 and got.shape == (p, n, d)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    if p == 1:  # the single-problem form is the same launch
        one = ops.landmark_summary(q[0], k[0], v[0])
        assert torch.equal(one, got[0])


def test_landmark_summary_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.landmark_summary(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="bfloat16"):
        ops.landmark_summary(x, x.bfloat16(), x)
    with pytest.raises(ValueError, match="on cuda"):
        ops.landmark_summary(x, x.cpu(), x)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.landmark_summary(x.cpu(), x, x)
    # an input that requires grad takes the differentiable path
    assert ops.landmark_summary(x.clone().requires_grad_(), x,
                                x).grad_fn is not None
    with pytest.raises(ValueError, match="head dim"):
        y = torch.zeros((2, 8, 48), device=cuda)
        ops.landmark_summary(y, y, y)
    with pytest.raises(ValueError, match="contiguous"):
        ops.landmark_summary(x.transpose(1, 2), x, x)
    b = x.bfloat16()
    with pytest.raises(ValueError, match="contiguous"):
        ops.landmark_summary(b.transpose(1, 2), b, b)
    # a contiguous bf16 view 2 bytes past a 16-byte boundary: no TMA base
    off = torch.zeros(b.numel() + 8, dtype=torch.bfloat16,
                      device=cuda)[1:1 + b.numel()].view(b.shape)
    assert off.is_contiguous() and off.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        ops.landmark_summary(off, b, b)
    with pytest.raises(ValueError, match="16-byte"):
        ops.landmark_summary(b, b, off)
    # the same for f32, 4 bytes past: no float4 loads in the split pass
    off = torch.zeros(x.numel() + 4, device=cuda)[1:1 + x.numel()].view(
        x.shape)
    assert off.is_contiguous() and off.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        ops.landmark_summary(off, x, x)
    with pytest.raises(ValueError, match="16-byte"):
        ops.landmark_summary(x, off, x)
    with pytest.raises(ValueError, match="16-byte"):
        lsum.bf16_terms(off, 3)


def test_landmark_summary_dtype_chooses_the_route(cuda):
    """bf16 inputs go to the tensor-core route as they are, f32 inputs to
    the f32_split route (three split passes, then the loop); the total
    counts both; the two agree within the bound on the same
    (bf16-representable) values."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((2, rows, 64), generator=g, device=cuda
                           ).bfloat16() for rows in (96, 500, 500))
    ops.reset_launches()
    splits = lsum.bf16_terms.launches
    a = ops.landmark_summary(q, k, v)
    assert lsum.landmark_summary.route_launches == {"tensor_core": 1,
                                                    "f32_split": 0}
    assert lsum.bf16_terms.launches == splits
    b = ops.landmark_summary(q.float(), k.float(), v.float())
    assert lsum.landmark_summary.route_launches == {"tensor_core": 1,
                                                    "f32_split": 1}
    assert lsum.bf16_terms.launches == splits + 3
    assert ops.launch_counts()["landmark_summary"] == 2
    torch.cuda.synchronize()
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    ops.reset_launches()
    assert lsum.landmark_summary.route_launches == {"tensor_core": 0,
                                                    "f32_split": 0}


@pytest.mark.parametrize("terms", [1, 2, 3])
@pytest.mark.parametrize("shape", [(10, 1536, 64), (3, 777, 32), (4,)])
def test_bf16_terms_kernel_matches_plain(cuda, terms, shape):
    """The split pass against the same rounding in torch, bitwise, on
    normal values spread over 2^±60 and on zeros, at the SmolLM-360M q
    shape, a ragged one and one float4."""
    g = torch.Generator(device=cuda).manual_seed(terms)
    x = torch.randn(shape, generator=g, device=cuda) * torch.exp2(
        torch.randint(-60, 61, shape, generator=g, device=cuda).float())
    x.view(-1)[::7] = 0.0
    before = lsum.bf16_terms.launches
    got = lsum.bf16_terms(x, terms)
    want = ref.bf16_terms(x, terms)
    torch.cuda.synchronize()
    assert lsum.bf16_terms.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (terms, *shape)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    if terms == 3:  # three terms hold a normal f32 value exactly
        assert torch.equal(got.double().sum(0), x.double())


def test_landmark_forward_on_the_card_launches_once_per_layer(cuda,
                                                             monkeypatch):
    """A smoke LM with the landmark backend: one kernel launch per layer,
    logits close to the same forward with the plain summary, which
    launches nothing."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(registry.get("smollm-360m").smoke_model,
                              attn_backend="landmark")
    model = T.init_lm(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    toks = torch.as_tensor(synthetic.lm_batch(0, 0, 2, 64, cfg.vocab)[
        "tokens"], device=cuda)
    with torch.no_grad():
        ops.reset_launches()
        got, _ = T.lm_forward(model, toks)
        assert ops.launch_counts()["landmark_summary"] == cfg.n_layers
        # a bf16 model: every layer on the tensor-core kernel
        assert lsum.landmark_summary.route_launches == {
            "tensor_core": cfg.n_layers, "f32_split": 0}
        ops.reset_launches()
        monkeypatch.setattr(ops, "landmark_summary", ref.landmark_summary_ref)
        want, _ = T.lm_forward(model, toks)
        assert all(v == 0 for v in ops.launch_counts().values())
    torch.cuda.synchronize()
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel < 0.05, rel


def _bwd_inputs(cuda, dtype, p, n, s, d, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn((p, rows, d), generator=g, device=cuda).to(dtype)
               for rows in (n, s, s))
    scale = 1.0 / np.sqrt(d)
    out = ref.landmark_summary_ref(q, k, v, scale)
    dout = torch.randn(out.shape, generator=g, device=cuda)
    return q, k, v, out, dout, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("p,n,s,d", [(1, 64, 1024, 64), (3, 100, 777, 32),
                                     (2, 130, 300, 128), (2, 33, 500, 256),
                                     (1, 1, 2, 64), (10, 1536, 4096, 64)])
def test_landmark_summary_bwd_kernel_matches_plain(cuda, dtype, p, n, s, d):
    """Kernel 7's backward against its plain version, within 1e-4 of each
    gradient's largest |value| (the tensor-core route's split terms, or the
    FMA route's f32 FMAs, summed in another order), at ragged n and S,
    every head dim and the SmolLM-360M landmark shape; two launches of one
    call on the route of the dtype and head dim, after its split passes
    (dO on ``tensor_core``; dO, q, k, v on ``f32_split``; none on ``fma``),
    and two calls bitwise equal; the single-problem form the same launch."""
    args = _bwd_inputs(cuda, dtype, p, n, s, d, seed=n + s)
    route = lsum.bwd_route(dtype, d)
    before = lsum.landmark_summary_bwd.launches
    on_route = lsum.landmark_summary_bwd.route_launches[route]
    splits = lsum.bf16_terms.launches
    got = lsum.landmark_summary_bwd(*args)
    again = lsum.landmark_summary_bwd(*args)
    want = ref.landmark_summary_bwd_ref(*args)
    torch.cuda.synchronize()
    assert lsum.landmark_summary_bwd.launches == before + 2 * lsum.BWD_LAUNCHES
    assert (lsum.landmark_summary_bwd.route_launches[route]
            == on_route + 2 * lsum.BWD_LAUNCHES)
    per_call = {"tensor_core": 1, "f32_split": 4, "fma": 0}[route]
    assert lsum.bf16_terms.launches == splits + 2 * per_call
    for a, b, w in zip(got, again, want):
        assert a.dtype == torch.float32 and a.shape == w.shape
        assert torch.equal(a, b)
        assert float((a - w).abs().max()) <= 1e-4 * float(w.abs().max())
    if p == 1:
        one = lsum.landmark_summary_bwd(*(t[0] for t in args[:5]), args[5])
        assert all(torch.equal(a, b[0]) for a, b in zip(one, got))


def test_landmark_summary_bwd_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v, out, dout, scale = _bwd_inputs(cuda, torch.float32, 2, 8, 16,
                                            64, 1)
    bwd = lsum.landmark_summary_bwd
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bwd(q.half(), k.half(), v.half(), out, dout, scale)
    with pytest.raises(ValueError, match="bfloat16"):
        bwd(q, k.bfloat16(), v, out, dout, scale)
    with pytest.raises(ValueError, match="on cuda"):
        bwd(q, k.cpu(), v, out, dout, scale)
    with pytest.raises(ValueError, match="CUDA device"):
        bwd(q.cpu(), k, v, out, dout, scale)
    with pytest.raises(ValueError, match="head dim"):
        y = torch.zeros((2, 8, 48), device=cuda)
        bwd(y, y, y, y, y, scale)
    with pytest.raises(ValueError, match="contiguous"):
        bwd(q.transpose(1, 2), k, v, out, dout, scale)
    with pytest.raises(ValueError, match="contiguous"):
        bwd(q, k, v, out, dout.transpose(1, 2).contiguous().transpose(1, 2),
            scale)
    with pytest.raises(ValueError, match="float32"):
        bwd(q, k, v, out.bfloat16(), dout, scale)
    with pytest.raises(ValueError, match="out and dout"):
        bwd(q, k, v, out[:, :4].contiguous(), dout, scale)
    with pytest.raises(ValueError, match="shapes differ"):
        bwd(q, k, v[:, :8].contiguous(), out, dout, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_landmark_summary_function_on_the_card(cuda, dtype):
    """``ops.landmark_summary`` with inputs that require grad: one forward
    launch, one backward call (two launches), gradients in the inputs'
    dtype within 1e-3 of autograd through the plain f32 forward (the
    forward kernel's own error enters Δ), plus a bf16 rounding for bf16
    inputs."""
    q, k, v, _, dout, scale = _bwd_inputs(cuda, torch.float32, 2, 200, 700,
                                          64, 5)
    a = [t.to(dtype).requires_grad_() for t in (q, k, v)]
    b = [t.to(dtype).float().requires_grad_() for t in (q, k, v)]
    ops.reset_launches()
    ops.landmark_summary(*a).backward(dout)
    assert ops.launch_counts()["landmark_summary"] == 1
    assert ops.launch_counts()["landmark_summary_bwd"] == lsum.BWD_LAUNCHES
    ref.landmark_summary_ref(*b, scale).backward(dout)
    torch.cuda.synchronize()
    limit = 1e-3 if dtype == torch.float32 else 1e-3 + 2 ** -8
    for x, y in zip(a, b):
        assert x.grad.dtype == dtype
        rel = float((x.grad.float() - y.grad).abs().max()
                    / y.grad.abs().max())
        assert rel <= limit, rel


# ------------------------------------------------------------ request engine
def _engine_state(cuda, u=6040, p=3952, min_bucket=256):
    """A fit at MovieLens-1M width (the paper's spec), bucketed."""
    from repro_torch.lifecycle import buckets

    r = _ratings(u, p, cuda, density=0.042, seed=9)
    spec = T.LandmarkSpec(n_landmarks=20, k_neighbors=13)
    st = T.fit(T.RatingMatrix(r, u, p), spec)
    return buckets.from_state(st, min_bucket), spec


def test_engine_reads_bitwise_at_every_padded_shape_on_the_card(cuda):
    """At ML-1M width, a request's pair predictions and top-N lists are the
    same bits at every padded batch shape 8..128 and at any offset as when
    it runs alone at its own shape: the engine's bitwise-against-solo
    contract on the card, where a library reduction's plan could depend on
    the batch."""
    from repro_torch.serving import EngineConfig, LocalBackend

    bst, spec = _engine_state(cuda)
    backend = LocalBackend(bst, spec)
    pub = backend.snapshot()
    cfg = EngineConfig(max_batch=128, min_shape=8, topn=10)
    rng = np.random.default_rng(0)
    u, p = bst.n_valid, bst.state.ratings.shape[1]
    for m in (1, 5, 16, 37, 128):
        uu, it = rng.integers(0, u, m), rng.integers(0, p, m)
        solo_u = np.zeros(cfg.pad_shape(m), np.int64)
        solo_u[:m] = uu
        solo_i = np.zeros_like(solo_u)
        solo_i[:m] = it
        want_p = backend.predict_pairs(pub, solo_u, solo_i)[:m]
        want_i, want_s = backend.recommend_topn(pub, solo_u, cfg.topn)
        assert np.isfinite(want_p).all()
        for shape in cfg.batch_shapes():
            if shape < m:
                continue
            for off in sorted({0, (shape - m) // 2, shape - m}):
                bu, bi = rng.integers(0, u, shape), rng.integers(0, p, shape)
                bu[off:off + m], bi[off:off + m] = uu, it
                got_p = backend.predict_pairs(pub, bu, bi)[off:off + m]
                got_i, got_s = backend.recommend_topn(pub, bu, cfg.topn)
                assert np.array_equal(got_p, want_p), (m, shape, off)
                assert np.array_equal(got_i[off:off + m], want_i[:m])
                assert np.array_equal(got_s[off:off + m], want_s[:m])


def test_engine_fold_lane_runs_on_its_own_stream(cuda):
    """The backend's two lanes are two streams, neither the default one; a
    fold on the fold stream publishes bitwise the state a plain
    ``fold_in_rows`` on the default stream gives, launches d1 and the
    fold-in scan, and leaves the generation it cloned untouched."""
    from repro_torch.lifecycle import buckets
    from repro_torch.serving import LocalBackend
    from repro_torch.serving.engine import _clone, _tensors

    bst, spec = _engine_state(cuda, u=2000, p=800)
    backend = LocalBackend(bst, spec, warm_shapes=(8, 16), warm_topn=10)
    default = torch.cuda.default_stream(cuda)
    streams = {backend.read_stream, backend.fold_stream, default}
    assert len(streams) == 3
    pub = backend.snapshot()
    before = [t.clone() for t in _tensors(pub[0])]
    rows = _ratings(64, 800, cuda, seed=11).cpu().numpy()
    want = buckets.fold_in_rows(_clone(pub[0]), rows, 64, spec)
    ops.reset_launches()
    assert backend.fold_in(rows, 64) == 1
    counts = ops.launch_counts()
    assert counts["masked_similarity"] == 1 and counts["foldin_topk"] == 1
    got = backend.snapshot()[0]
    assert got.n_valid == want.n_valid == bst.n_valid + 64
    for a, b in zip(_tensors(got), _tensors(want)):
        assert torch.equal(a, b)
    for a, b in zip(before, _tensors(pub[0])):
        assert torch.equal(a, b)


def test_threaded_engine_on_the_card(cuda):
    """Reads from four client threads while folds run on the fold lane:
    every request completes, predictions are finite, and the live
    generation's sample re-runs bitwise."""
    import threading

    from repro_torch.serving import EngineConfig, LocalBackend, RequestEngine

    bst, spec = _engine_state(cuda, u=3000, p=1000)
    cfg = EngineConfig(max_batch=64, min_shape=8, queue_cap=4096,
                       slo_ms=500.0, fold_bq=32, topn=10)
    backend = LocalBackend(bst, spec, warm_shapes=cfg.batch_shapes())
    eng = RequestEngine(backend, cfg)
    eng.start()
    done, lock = [], threading.Lock()

    def client(seed):
        rng = np.random.default_rng(seed)
        mine = []
        for _ in range(40):
            m = int(rng.integers(1, 17))
            uu = rng.integers(0, 3000, m)
            r = (eng.submit("topn", users=uu) if rng.random() < 0.2 else
                 eng.submit("pair", users=uu, items=rng.integers(0, 1000, m)))
            assert r is not None and r.done.wait(30.0)
            mine.append(r)
        with lock:
            done.extend(mine)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        folds = [eng.submit("fold", rows=_ratings(
            32, 1000, cuda, seed=20 + i).cpu().numpy()) for i in range(3)]
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive()
        assert all(f.done.wait(60.0) for f in folds)
    finally:
        eng.stop()
    assert len(done) == 160 and backend.generation == 3
    assert all(np.isfinite(r.result).all() for r in done if r.kind == "pair")
    assert eng.stats()["nonfinite"] == 0
    eng.submit("pair", users=np.arange(3000, 3064), items=np.zeros(64, int))
    eng.submit("topn", users=np.arange(8))
    eng.pump_reads()
    checked, bad = eng.verify_sample()
    assert checked >= 2 and bad == 0


# ------------------------------------------------ write path, engine mesh
@pytest.mark.parametrize("b", [8, 16, 64])
def test_update_backpatch_block_is_gathered_sims_on_the_card(cuda, b,
                                                            monkeypatch):
    """``update_ratings`` scores its (C, b) back-patch block with kernel 6's
    shared form, one launch: at C = 8192 the block is ``ref.gathered_sims``
    bit for bit, so a score does not depend on the block's row count (a
    shard's block on a mesh scores the same)."""
    from repro_torch import mutation
    from repro_torch.mutation import mutate

    bst, spec = _engine_state(cuda, min_bucket=8192)
    assert bst.capacity == 8192
    mst = mutation.from_bucketed(bst)
    blocks, real = [], mutate.backpatch_sims

    def spy(rep, new_rep, measure):
        out = real(rep, new_rep, measure)
        blocks.append((rep, new_rep, measure, out))
        return out

    monkeypatch.setattr(mutate, "backpatch_sims", spy)
    rng = np.random.default_rng(b)
    ids = rng.choice(bst.n_valid, b, replace=False)
    rows = _ratings(b, bst.state.ratings.shape[1], cuda, density=0.042,
                    seed=b).cpu().numpy()
    ops.reset_launches()
    mutation.update_ratings(mst, ids, rows, b, spec)
    assert ops.launch_counts()["score_candidates"] == 1
    (rep, new_rep, measure, got), = blocks
    assert tuple(got.shape) == (8192, b) and got.is_cuda
    assert torch.equal(got, ref.gathered_sims(rep, new_rep, measure))
    assert torch.equal(got[:2048], ref.gathered_sims(rep[:2048], new_rep,
                                                     measure))


def test_mesh_routed_reads_and_writes_on_the_card_bitwise_one_device(cuda):
    """A 4-shard mesh on the card (``MutableShardedBackend``): routed reads
    at every batch shape, then after an update, a removal and a fold on
    the write streams, are the one-device ``MutableLocalBackend``'s bits;
    every block stays on the card, and the writes launch kernels 1, 3 and
    6 on the shards."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.lifecycle import buckets
    from repro_torch.serving import (EngineConfig, MutableLocalBackend,
                                     MutableShardedBackend)

    spec = T.LandmarkSpec(n_landmarks=20, k_neighbors=13)
    st = T.fit(T.RatingMatrix(_ratings(3000, 1000, cuda, density=0.042,
                                       seed=9), 3000, 1000), spec)
    cfg = EngineConfig(max_batch=128, min_shape=32)
    mesh = make_mesh(("pod", "data"), (2, 2))
    sst = buckets.from_state_sharded(st, mesh, ("pod", "data"), 64)
    u_per = -(-3000 // 4)
    shard = MutableShardedBackend(sst, np.arange(3000) // u_per,
                                  np.arange(3000) % u_per, spec,
                                  min_bucket=64)
    local = MutableLocalBackend(buckets.from_state(st, 256), spec)
    rng = np.random.default_rng(12)

    def same(n_users):
        for b in cfg.batch_shapes():
            u, it = rng.integers(0, n_users, b), rng.integers(0, 1000, b)
            pa, pb = shard.snapshot(), local.snapshot()
            assert np.array_equal(shard.predict_pairs(pa, u, it),
                                  local.predict_pairs(pb, u, it)), b
            got = shard.recommend_topn(pa, u, 10)
            want = local.recommend_topn(pb, u, 10)
            assert all(np.array_equal(g, w) for g, w in zip(got, want)), b

    same(3000)
    ops.reset_launches()
    for be in (shard, local):
        be.apply_update(np.array([4, 900, 1700, 2999]),
                        _ratings(4, 1000, cuda, seed=13).cpu().numpy())
        be.apply_remove(np.array([5, 901, 2500]))
        be.fold_in(_ratings(64, 1000, cuda, seed=14).cpu().numpy(), 64)
    counts = ops.launch_counts()
    assert counts["score_candidates"] >= 4 + 4 + 2
    assert counts["foldin_topk"] >= 4 and counts["masked_similarity"] >= 4
    same(3064)
    blocks = shard.snapshot()[0].sstate
    assert all(b.is_cuda for b in blocks.ratings + blocks.representation)


# ------------------------------------------------------ baselines, compact
MF_CARD_ATOL = 1e-4  # MF on the card vs the CPU: parameters, predictions
BPMF_CARD_ATOL = 1e-4  # one Gibbs sweep on the card vs the CPU, same draws
COMPACT_TOL = 2e-2  # compact reads vs widened reads (bf16 weights)


def _ml100k():
    from repro_torch.data import ratings as R

    d = R.synthesize("movielens100k", seed=0)
    return d, *R.kfold_split(d, 0)


@pytest.mark.parametrize("name", ["rsvd", "irsvd", "pmf", "svdpp"])
def test_mf_on_the_card_matches_the_cpu(cuda, name):
    """Two epochs (11 steps each) from the same initial parameters and
    permutations: the gathers' backward accumulates in the card's own
    order, within MF_CARD_ATOL of the CPU's."""
    from repro_torch.baselines import mf

    d, tr, te = _ml100k()
    cfg = getattr(mf, f"{name}_config")(d.n_users, d.n_items, epochs=2)
    init = mf._init(cfg, float(d.ratings[tr].mean()), "cpu")
    g = torch.Generator().manual_seed(1)
    perms = [torch.randperm(len(tr), generator=g) for _ in range(2)]
    out = {}
    for dev in (cuda, "cpu"):
        params, aux = mf.fit_mf(d.users[tr], d.items[tr], d.ratings[tr], cfg,
                                device=dev, init=init, perms=perms)
        out[str(dev)] = (params, mf.predict_mf(params, cfg, d.users[te],
                                               d.items[te], aux))
    (pc, yc), (pp, yp) = out["cuda"], out["cpu"]
    assert pc.p.is_cuda and yc.is_cuda
    for field, c, p in zip(mf.MFParams._fields, pc, pp):
        torch.testing.assert_close(c.cpu(), p, rtol=0, atol=MF_CARD_ATOL,
                                   msg=field)
    torch.testing.assert_close(yc.cpu(), yp, rtol=0, atol=MF_CARD_ATOL)


def test_bpmf_sweep_on_the_card_matches_the_cpu(cuda):
    from repro_torch.baselines import bpmf

    d, tr, te = _ml100k()
    cfg = bpmf.BPMFConfig(d.n_users, d.n_items, burnin=1, n_samples=2)
    out = {}
    for dev in (cuda, "cpu"):
        draws = bpmf.TorchDraws(0, dev)
        rc, m, _ = bpmf.centered_block(d.users[tr], d.items[tr],
                                       d.ratings[tr], cfg, dev)
        p0 = draws.normal((cfg.n_users, cfg.dim)) * 0.1
        q0 = draws.normal((cfg.n_items, cfg.dim)) * 0.1
        out[str(dev)] = bpmf.gibbs_step(draws, p0, q0, rc, m, cfg)
    for c, p in zip(out["cuda"], out["cpu"]):
        assert c.is_cuda
        torch.testing.assert_close(c.cpu(), p, rtol=0, atol=BPMF_CARD_ATOL)
    preds = bpmf.fit_predict_bpmf(d.users[tr], d.items[tr], d.ratings[tr],
                                  d.users[te], d.items[te], cfg, device=cuda)
    assert preds.is_cuda and preds.shape == (len(te),)
    assert torch.isfinite(preds).all() and (preds >= 1).all() \
        and (preds <= 5).all()


def test_compact_graph_reads_on_the_card(cuda, tmp_path):
    """uint16/bf16 graphs on CUDA tensors: the widening gather, compact
    reads within the bf16 bound, widening on growth and fold-in, and the
    compact checkpoint round trip."""
    from repro_torch.core import knn
    from repro_torch.lifecycle import buckets
    from repro_torch.train.checkpoint import (load_landmark_state,
                                              save_landmark_state)

    spec = T.LandmarkSpec(n_landmarks=16, selection="popularity")
    r = _ratings(1000, 300, cuda, seed=3)
    st = T.fit(T.RatingMatrix(r, 1000, 300), spec)
    bst = buckets.from_state(st, min_bucket=1024)
    cst = buckets.compact_state(bst)
    gc = cst.state.graph
    assert gc.indices.dtype == torch.uint16 and gc.indices.is_cuda
    assert buckets.compact_state(cst) is cst
    users = torch.randint(0, 1000, (256,), device=cuda,
                          generator=torch.Generator(cuda).manual_seed(0))
    items = torch.randint(0, 300, (256,), device=cuda,
                          generator=torch.Generator(cuda).manual_seed(1))
    ids, w = knn._gathered(gc, users, torch.float32)
    want_ids, want_w = knn._gathered(bst.state.graph, users, torch.float32)
    assert torch.equal(ids, want_ids)
    torch.testing.assert_close(w, want_w, rtol=COMPACT_TOL, atol=COMPACT_TOL)
    torch.testing.assert_close(buckets.predict_pairs(cst, users, items),
                               buckets.predict_pairs(bst, users, items),
                               rtol=COMPACT_TOL, atol=COMPACT_TOL)
    top, _ = buckets.recommend_topn(cst, users[:32])
    assert top.shape == (32, 10) and (top >= 0).all()
    grown, grew = buckets.ensure_capacity(cst, 64, min_bucket=1024)
    assert grew and not grown.state.graph.is_compact
    folded = buckets.fold_in_rows(buckets.compact_state(bst),
                                  _ratings(8, 300, cuda, seed=4), 8, spec,
                                  min_bucket=1024)
    assert not folded.state.graph.is_compact and folded.n_valid == 1008
    save_landmark_state(str(tmp_path), st, compact=True)
    raw = load_landmark_state(str(tmp_path), widen=False, device=cuda)
    assert raw.graph.indices.dtype == torch.uint16 and raw.graph.is_compact
    assert torch.equal(raw.graph.to_full().indices, st.graph.indices)


def _segment_index(kind, e, n, device, seed=0):
    """(index, mask) on ``device``: uniform, power-law (the GNN's source
    degrees), padded (half the edges at node 0 with mask 0) or with every
    other segment empty."""
    rng = np.random.default_rng(seed)
    mask = np.ones(e, np.float32)
    if kind == "power_law":
        w = 1.0 / np.arange(1, n + 1) ** 0.7
        idx = rng.choice(n, size=e, p=w / w.sum())
    else:
        idx = rng.integers(0, n, e)
    if kind == "padded":
        idx[e // 2:] = 0
        mask[e // 2:] = 0
    if kind == "empty":
        idx = 2 * (idx // 2)
    return (torch.as_tensor(idx.astype(np.int32), device=device),
            torch.as_tensor(mask, device=device))


def _segment_case(case, device):
    """(index, mask, N, H) of one of the schedule's cases
    (``tests/test_torch_segment_sum_sched.py``): the four index kinds at
    E = 20,000, N = 3000, H = 70; power-law degrees at each width class
    H = 1, 31, 32, 33, 70, 128; one segment of 5,000 members (past HUGE:
    4-byte channel slices), at H = 70 and at H = 33 ("one_5000_h33": a
    bf16 row at odd H is 2-byte aligned, so its slices are copied through
    registers); segments of HEAVY - 1, HEAVY and HEAVY + 1 members among
    light ones; a large CSR (N = 140,000: chunks of CHUNK, every other
    case CHUNK_MIN); every edge masked; no edge. And the recsys-like CSRs
    of ``tools/time_segment_sum.py::rec_like_case``
    (``tests/test_torch_segment_sum_heavy.py`` at card size):
    "fm_like_h1" and "fm_like_h10", 3000 heavy segments among 4,000,000
    mostly empty rows (chunks past CHUNK); "zipf_head", a head of 565,000
    members at H = 64."""
    heavy = segsum.HEAVY
    if case.startswith(("fm_like", "zipf_head")):
        idx, n, h = segsum_tool.rec_like_case(case, device)
        return idx, torch.ones(idx.shape[0], device=device), n, h
    if case in ("random", "power_law", "padded", "empty"):
        return (*_segment_index(case, 20000, 3000, device), 3000, 70)
    if case.startswith("h"):
        return (*_segment_index("power_law", 20000, 3000, device), 3000,
                int(case[1:]))
    rng = np.random.default_rng(3)
    n, h = 3000, 70
    if case.startswith("one_5000"):
        idx = np.concatenate([np.full(5000, 7), rng.integers(0, n, 3000)])
        h = 33 if case == "one_5000_h33" else h
    elif case == "large":  # a dense head, then empty rows: chunks of 32
        n = 140000
        idx = rng.integers(0, 9000, 20000)
    elif case.startswith("deg"):
        d = heavy + int(case[3:])
        idx = rng.integers(0, n, 20000)
        idx = idx[(idx != 1) & (idx != 40) & (idx != 41)]
        idx = np.concatenate([idx, np.repeat([1, 40, 41], d)])
    else:  # "all_empty", "no_edges"
        idx = rng.integers(0, n, 0 if case == "no_edges" else 20000)
    mask = np.full(idx.shape[0], 0.0 if case == "all_empty" else 1.0,
                   np.float32)
    return (torch.as_tensor(idx.astype(np.int32), device=device),
            torch.as_tensor(mask, device=device), n, h)


SEGMENT_CASES = ("random", "power_law", "padded", "empty", "h1", "h31",
                 "h32", "h33", "h70", "h128", "one_5000", "one_5000_h33",
                 "deg-1", "deg+0", "deg+1", "large", "all_empty",
                 "no_edges")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", SEGMENT_CASES)
def test_segment_sum_kernel_matches_plain(cuda, kind, dtype):
    idx, mask, n, h = _segment_case(kind, cuda)
    csr = segsum.build_csr(idx, n, mask)
    x = torch.randn((idx.shape[0], h), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1)).to(dtype)
    ops.reset_launches()
    got = segsum.segment_sum(x, csr)
    again = segsum.segment_sum(x, csr)
    want = ref.segment_sum_ref(x, csr.perm, csr.indptr)
    torch.cuda.synchronize()
    assert ops.launch_counts()["segment_sum"] == 2
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(again, got)
    counts = csr.indptr[1:] - csr.indptr[:-1]
    assert not got[counts == 0].any()


@pytest.mark.parametrize("kind", ["fm_like_h1", "fm_like_h10", "zipf_head"])
def test_segment_sum_kernel_at_recsys_like_csrs(cuda, kind):
    """Thousands of heavy segments among millions of empty rows, and a
    Zipf head of 565,000 members, f32 (the recsys tables'): bitwise the
    plain version and across two launches; every heavy unit and the
    light walk's big chunks run."""
    idx, mask, n, h = _segment_case(kind, cuda)
    csr = segsum.build_csr(idx, n, mask)
    counts = csr.indptr[1:] - csr.indptr[:-1]
    if kind == "zipf_head":
        assert int(counts.max()) >= 500_000
    else:
        assert int((counts > segsum.HEAVY).sum()) > 2000
        assert segsum.chunk_size(n, csr.perm.numel()) > segsum.CHUNK
    x = torch.randn((idx.shape[0], h), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(2))
    ops.reset_launches()
    got = segsum.segment_sum(x, csr)
    again = segsum.segment_sum(x, csr)
    want = ref.segment_sum_ref(x, csr.perm, csr.indptr)
    torch.cuda.synchronize()
    assert ops.launch_counts()["segment_sum"] == 2
    assert torch.equal(got, want) and torch.equal(again, got)
    assert not got[counts == 0].any()


@pytest.mark.parametrize("kind", ["one_5000", "h33", "fm_like_h10"])
def test_segment_sum_kernel_on_every_card(cuda, kind):
    """The kernel takes more than 48 KB of shared memory, an opt-in that
    each card needs its own of: a launch on every visible card (as a mesh
    placed round robin over them makes), after one on cuda:0, is bitwise
    the plain version there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    idx, mask, n, h = _segment_case(kind, cuda)
    x = torch.randn((idx.shape[0], h), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(3))
    for d in range(torch.cuda.device_count()):
        dev = torch.device("cuda", d)
        csr = segsum.build_csr(idx.to(dev), n, mask.to(dev))
        xd = x.to(dev)
        got = segsum.segment_sum(xd, csr)
        want = ref.segment_sum_ref(xd, csr.perm, csr.indptr)
        torch.cuda.synchronize(dev)
        assert got.device == dev and torch.equal(got, want), d


def test_segment_sum_rejects_what_the_kernel_does_not_take(cuda):
    idx, mask = _segment_index("random", 100, 10, cuda)
    csr = segsum.build_csr(idx, 10, mask)
    x = torch.randn((100, 8), device=cuda)
    with pytest.raises(ValueError):
        segsum.segment_sum(x.half(), csr)
    with pytest.raises(ValueError):
        segsum.segment_sum(torch.randn((8, 100), device=cuda).T, csr)
    with pytest.raises(ValueError):
        segsum.segment_sum(x[:99], csr)
    with pytest.raises(ValueError):
        segsum.segment_sum(x, segsum.build_csr(idx.cpu(), 10, mask.cpu()))


def test_gnn_train_step_on_the_card_is_bitwise_reproducible(cuda):
    """A GatedGCN loss and its gradients twice, the segment sums all on the
    kernel: 8 launches a layer (forward, recompute, backward)."""
    from repro_torch.data import synthetic
    from repro_torch.launch import steps
    from repro_torch.models import gnn

    cfg = gnn.GNNConfig("g", n_layers=3, d_hidden=70, d_feat=64,
                        n_classes=7)
    model = gnn.init_gnn(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in
             synthetic.random_graph(0, 2000, 9000, 64, 7,
                                    pad_edges_to=10000).items()}
    runs = []
    for _ in range(2):
        ops.reset_launches()
        loss, grads = steps.value_and_grad(model, batch, gnn.gnn_loss)
        torch.cuda.synchronize()
        assert ops.launch_counts()["segment_sum"] == 8 * cfg.n_layers
        runs.append((loss, grads))
    (l1, g1), (l2, g2) = runs
    assert torch.equal(l1, l2) and bool(torch.isfinite(l1))
    assert all(torch.equal(g1[k], g2[k]) for k in g1)


def _lookup_grad(table, ids, cot):
    """The table's gradient of sum(lookup(table, ids) * cot), with the
    segment-sum launches it took."""
    from repro_torch.distributed import embedding

    t = table.clone().requires_grad_()
    ops.reset_launches()
    (embedding.embedding_lookup(t, ids) * cot).sum().backward()
    torch.cuda.synchronize()
    return t.grad, ops.launch_counts()["segment_sum"]


@pytest.mark.parametrize("arch", ["fm", "bert4rec"])
def test_recsys_lookup_backward_is_bitwise_plain_and_itself(cuda, arch):
    """FM's CSR by field id (uniform ids per field, ~655-member segments
    in the 100-row fields) and BERT4Rec's by item id (the Zipf head, over
    half the ids in one segment) at small tables: the lookup's gradient
    twice bitwise and bitwise the plain version's sum on the card."""
    from repro_torch.configs import registry
    from repro_torch.data import synthetic
    from repro_torch.distributed import embedding

    gen = torch.Generator(cuda).manual_seed(2)
    if arch == "fm":
        vocabs = (100,) * 9 + (1000, 5000)
        ids = synthetic.fm_train_batch(0, 0, 4096, vocabs)["field_ids"]
        rows, dim = sum(vocabs), 10
    else:
        cfg = registry.get("bert4rec").model
        ids = synthetic.seq_rec_batch(0, 0, 256, cfg.seq_len, 20000)[
            "item_ids"]
        ids[:4, :7] = -1
        rows, dim = 20480, cfg.embed_dim
    ids = torch.as_tensor(ids, device=cuda)
    table = torch.randn((rows, dim), generator=gen, device=cuda)
    cot = torch.randn(tuple(ids.shape) + (dim,), generator=gen, device=cuda)
    g1, n1 = _lookup_grad(table, ids, cot)
    g2, _ = _lookup_grad(table, ids, cot)
    csr = embedding.lookup_csr(ids, rows)
    want = ref.segment_sum_ref(cot.reshape(-1, dim), csr.perm, csr.indptr)
    assert n1 == 1
    assert torch.equal(g1, g2) and torch.equal(g1, want)


@pytest.mark.parametrize("arch", ["fm", "bert4rec", "mind", "dien"])
def test_recsys_train_step_on_the_card_is_bitwise_reproducible(cuda, arch):
    """A recsys smoke model's train step (loss, gradients, AdamW) twice from
    the same weights: every lookup's backward on the segment-sum kernel,
    the losses, gradients and updated parameters bit for bit."""
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.launch import train
    from repro_torch.models import recsys
    from repro_torch.train import optimizer as topt

    spec = registry.get(arch)
    cfg = spec.smoke_model
    raw = next(train._rec_batches(cfg))
    batch = {k: torch.as_tensor(v, device=cuda) for k, v in raw.items()}
    runs = []
    for _ in range(2):
        model = recsys.init_recsys(cfg, torch.Generator(cuda).manual_seed(0),
                                   cuda)
        state = topt.opt_init(model, spec.opt)
        ops.reset_launches()
        loss, grads = steps.value_and_grad(model, batch,
                                           recsys.family(cfg).loss)
        topt.opt_update(model, grads, state, spec.opt)
        torch.cuda.synchronize()
        assert ops.launch_counts()["segment_sum"] >= 2
        runs.append((loss, grads, dict(model.named_parameters())))
    (l1, g1, p1), (l2, g2, p2) = runs
    assert torch.equal(l1, l2) and bool(torch.isfinite(l1))
    assert all(torch.equal(g1[k], g2[k]) for k in g1)
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
