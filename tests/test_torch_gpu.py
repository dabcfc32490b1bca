"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``gpu`` marker and takes the ``cuda`` fixture,
which decides whether a card is present and skips without one. On the
H100: ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py`` from the root of
the checkout (the first test builds the kernels into ``build/kernels/``).

Tolerances:
- d1 cosine on integer ratings: bitwise equal (exact moments, the same
  IEEE epilogue); pearson and euclidean: rtol=1e-5, atol=1e-6;
- the top-k kernels: bitwise equal values and ids — the plain version
  repeats the kernel's summation order and epilogue op for op.
"""
import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import similarity as sim
from repro_torch.core.graph import kernel_rows
from repro_torch.kernels import knn_topk, ops, ref

pytestmark = pytest.mark.gpu
RTOL, ATOL = 1e-5, 1e-6
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


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("shape", [(1000, 130, 777), (64, 20, 3952),
                                   (5, 3, 1), (33, 1, 70)])
def test_masked_similarity_kernel_matches_plain(cuda, measure, shape):
    a, b, p = shape
    r = _ratings(a + b, p, cuda, seed=1)
    got = ops.masked_similarity(r[:a], r[a:], measure)
    want = ref.masked_similarity_ref(r[:a], r[a:], measure)
    torch.cuda.synchronize()
    if measure == "cosine":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("u,n,k", [(1001, 20, 13), (300, 64, 32), (50, 1, 1),
                                   (40, 33, 17)])
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
    assert all(v > 0 for v in counts.values()), counts
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
    rep = _rep(80, 65, cuda)
    with pytest.raises(ValueError, match="width"):
        knn_topk.topk_sim(rep, rep, 5)
    with pytest.raises(ValueError, match="k=33"):
        knn_topk.topk_sim(rep[:, :20].contiguous(), rep[:, :20].contiguous(),
                          33)
