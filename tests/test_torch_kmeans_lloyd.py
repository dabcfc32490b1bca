"""The Lloyd kernel's plain version (``kernels/ref.py::kmeans_lloyd_ref``)
against the JAX reference's k-means, on the CPU.

The kernel (``kernels/assign_clusters.py::kmeans_lloyd``) runs a whole
k-means in one launch and cannot run here; its plain version repeats its
arithmetic op for op, and ``tests/test_torch_gpu.py`` holds the two
bitwise on the card. Here the plain version is held to the reference's
``kmeans(backend="pallas")`` (its assignment kernel in interpret mode),
started from the reference's ``init_centroids``.

Tolerances: none. Assignments equal and centroids bitwise equal: the
update adds each cell's members in ascending row order from +0.0, as
``jax.ops.segment_sum`` and CPU ``index_add_`` do, and divides by the
exact count. Only the cosine normalization differs in order (left to
right here, as the kernel adds), which could move an assignment at a near
tie; the inputs below have none.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.retrieval.kmeans import init_centroids as j_init_centroids
from repro.retrieval.kmeans import kmeans as j_kmeans
import repro_torch.retrieval as R
from repro_torch.core.similarity import MEASURES
from repro_torch.kernels import assign_clusters as kac
from repro_torch.kernels import ref


def _rep(u, n, seed):
    return np.random.default_rng(seed).normal(size=(u, n)).astype(np.float32)


def _bits(x):
    """f32 values as their bit patterns (tells -0.0 from +0.0)."""
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _reference(rep, c, measure, iters, n_valid, seed):
    key = jax.random.PRNGKey(seed)
    nv = jnp.int32(n_valid)
    init = np.array(j_init_centroids(key, jnp.asarray(rep), c, nv))
    jc, ja = j_kmeans(key, jnp.asarray(rep), c, measure, iters=iters,
                      n_valid=nv, backend="pallas")
    return init, np.asarray(jc), np.asarray(ja)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("iters", [0, 1, 8])
@pytest.mark.parametrize("u,n,c,n_valid", [(160, 10, 6, 150),
                                           (1200, 20, 35, 1100)])
def test_lloyd_plain_version_is_the_reference_bitwise(measure, iters, u, n,
                                                      c, n_valid):
    rep = _rep(u, n, seed=u)
    init, jc, ja = _reference(rep, c, measure, iters, n_valid, seed=iters)
    pc, pa = ref.kmeans_lloyd_ref(torch.as_tensor(rep), torch.as_tensor(init),
                                  iters, n_valid, measure)
    assert pc.dtype == torch.float32 and pa.dtype == torch.int32
    np.testing.assert_array_equal(pa.numpy(), ja)
    np.testing.assert_array_equal(_bits(pc), _bits(jc))
    # the wrapper and kmeans(backend="kernel") take it on CPU tensors
    for cent, assign in (
            kac.kmeans_lloyd(torch.as_tensor(rep), torch.as_tensor(init),
                             iters, n_valid, measure),
            R.kmeans(torch.as_tensor(rep), c, measure, iters=iters,
                     n_valid=n_valid, backend="kernel",
                     init=torch.as_tensor(init))):
        np.testing.assert_array_equal(_bits(cent), _bits(pc))
        np.testing.assert_array_equal(assign.numpy(), pa.numpy())


def _spread_rows(u, n, c, seed):
    """Rows whose norms span six decades, cells drawn at random, and cell 0
    led by a row of -0.0 values."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(u, n)) * 10.0 ** rng.uniform(-3, 3, (u, 1))
    seg = rng.integers(0, c, u)
    first = int(np.flatnonzero(seg == 0)[0])
    rows[first] = -0.0
    return rows.astype(np.float32), seg.astype(np.int32)


@pytest.mark.parametrize("u,n,c", [(5976, 20, 77), (300, 7, 40)])
def test_row_order_sums_are_segment_sum_and_index_add(u, n, c):
    rows, seg = _spread_rows(u, n, c, seed=c)
    sums, counts = ref.cell_sums_ref(torch.as_tensor(rows),
                                     torch.as_tensor(seg), c)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(rows),
                                          jnp.asarray(seg), num_segments=c))
    added = torch.zeros((c, n)).index_add_(0, torch.as_tensor(seg).long(),
                                           torch.as_tensor(rows))
    np.testing.assert_array_equal(_bits(sums), _bits(want))
    np.testing.assert_array_equal(_bits(sums), _bits(added))
    np.testing.assert_array_equal(counts.numpy(), np.bincount(seg,
                                                              minlength=c))
    # the -0.0 row starts cell 0 from +0.0, as the reference does
    only = np.zeros(u, np.int32) + 1
    only[np.flatnonzero(seg == 0)[0]] = 0
    s0, _ = ref.cell_sums_ref(torch.as_tensor(rows), torch.as_tensor(only), 2)
    assert (_bits(s0[0]) == 0).all()


def test_empty_cell_keeps_its_centroid():
    rep = _rep(200, 8, seed=1)
    init = np.concatenate([rep[:3], np.full((1, 8), 50.0, np.float32)])
    for measure in ("pearson", "euclidean"):
        cent, assign = ref.kmeans_lloyd_ref(torch.as_tensor(rep),
                                            torch.as_tensor(init), 3,
                                            measure=measure)
        if measure == "euclidean":  # nothing is near the far centroid
            assert not (assign == 3).any()
            np.testing.assert_array_equal(_bits(cent[3]), _bits(init[3]))
        _, jc, _ = _ref_from_init(rep, init, measure, 3)
        np.testing.assert_array_equal(_bits(cent), _bits(jc))


def _ref_from_init(rep, init, measure, iters, n_valid=None):
    """The reference's Lloyd loop (jnp backend, segment_sum update) from
    given centroids: its step, repeated."""
    from repro.retrieval.kmeans import assign_clusters as j_assign

    u, c = rep.shape[0], init.shape[0]
    nv = u if n_valid is None else n_valid
    valid = jnp.arange(u) < nv
    x = jnp.asarray(rep)
    vrep = x * valid[:, None]
    cent = jnp.asarray(init)
    for _ in range(iters):
        a = j_assign(x, cent, measure, "pallas")
        seg = jnp.where(valid, a, c)
        sums = jax.ops.segment_sum(vrep, seg, num_segments=c + 1)[:-1]
        cnt = jax.ops.segment_sum(valid.astype(jnp.float32), seg,
                                  num_segments=c + 1)[:-1]
        cent = jnp.where(cnt[:, None] > 0,
                         sums / jnp.maximum(cnt[:, None], 1.0), cent)
    return init, np.asarray(cent), np.asarray(j_assign(x, cent, measure,
                                                       "pallas"))


@pytest.mark.parametrize("measure", MEASURES)
def test_more_cells_than_rows(measure):
    rep = _rep(5, 6, seed=2)
    init, jc, ja = _reference(rep, 9, measure, 8, 5, seed=3)
    pc, pa = ref.kmeans_lloyd_ref(torch.as_tensor(rep), torch.as_tensor(init),
                                  8, 5, measure)
    np.testing.assert_array_equal(pa.numpy(), ja)
    np.testing.assert_array_equal(_bits(pc), _bits(jc))


@pytest.mark.parametrize("measure", MEASURES)
def test_no_valid_rows_keeps_the_initial_centroids(measure):
    rep = _rep(64, 12, seed=4)
    init = _rep(7, 12, seed=5)
    pc, pa = ref.kmeans_lloyd_ref(torch.as_tensor(rep), torch.as_tensor(init),
                                  8, 0, measure)
    np.testing.assert_array_equal(_bits(pc), _bits(init))
    _, jc, ja = _ref_from_init(rep, init, measure, 8, n_valid=0)
    np.testing.assert_array_equal(_bits(jc), _bits(init))
    np.testing.assert_array_equal(pa.numpy(), ja)  # every row assigned
