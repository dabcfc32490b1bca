"""The port's CF cells (``launch/steps.py::_cf_cell``) against the
reference's (``repro.launch.steps._cf_cell``), on the CPU.

The reference builds its cells on a one-device mesh with Auto axes, as the
port's other cell tests run it; both cells take the same ratings, made
from a seed with numpy, at a small shape (64 users × 40 items, a ragged
61 × 33 padded to 64 rows). ROADMAP's parity rule: landmark ids equal;
the representation, the graph's weights and the predictions ``allclose``
at rtol 1e-5, atol 1e-6; the neighbor ids equal under the tie rule
(``core.topk.list_mismatches``). On the CPU the port's cell runs d1's
and the graph's plain versions (the ``streaming`` backend), with no
kernel launched.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jregistry
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.launch.steps import build_cell as jbuild_cell
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.topk import list_mismatches
from repro_torch.kernels import ops
from repro_torch.launch import steps

RTOL, ATOL = 1e-5, 1e-6
PAIRS = 512


def _archs(kind, name, dims):
    jarch = dataclasses.replace(jregistry.get("landmark_cf"), shapes=(
        JShapeSpec(name, kind, dims),))
    arch = dataclasses.replace(registry.get("landmark_cf"), shapes=(
        ShapeSpec(name, kind, dims),))
    return jarch, arch


def _mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)


def _ratings(u, p, rows, seed=0):
    """(rows, p) f32 stars 1..5 on ~35% of the cells (the first u rows;
    padded rows are empty), each row with a few ratings."""
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, size=(u, p)).astype(np.float32)
    r *= rng.random((u, p)) < 0.35
    r[:, 0] = np.where(r[:, 0] == 0, 3.0, r[:, 0])  # no empty user
    out = np.zeros((rows, p), np.float32)
    out[:u] = r
    return out


@pytest.mark.parametrize("u,p", [(64, 40), (61, 33)])
def test_fit_cell_matches_reference_cell(u, p):
    dims = dict(n_users=u, n_items=p)
    jarch, arch = _archs("cf_fit", "ml1m_fit", dims)
    jcell = jbuild_cell(jarch, "ml1m_fit", _mesh())
    cell = steps.build_cell(arch, "ml1m_fit")
    rows = cell.args[1].shape[0]
    assert rows == jcell.args[1].shape[0] == 64  # users padded to 8
    assert cell.args[0] is None  # popularity draws nothing
    r = _ratings(u, p, rows)
    with _mesh():
        j_idx, j_rep, j_w, j_i = jcell.jit()(jax.random.PRNGKey(0),
                                              jnp.asarray(r))
    before = dict(ops.launch_counts())
    idx, rep, w, i = cell.fn(None, torch.as_tensor(r))
    assert ops.launch_counts() == before  # CPU tensors: no kernel
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(rep.numpy(), np.asarray(j_rep), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(j_w), rtol=RTOL,
                               atol=ATOL)
    assert i.dtype == torch.int32 and w.dtype == torch.float32
    bad = list_mismatches(np.asarray(j_w), np.asarray(j_i), w, i, RTOL,
                          ATOL)
    assert bad.size == 0, f"rows disagree beyond the tie rule: {bad[:10]}"


def test_fused_variant_is_the_same_step():
    dims = dict(n_users=64, n_items=40)
    _, arch = _archs("cf_fit", "ml1m_fit", dims)
    r = torch.as_tensor(_ratings(64, 40, 64, seed=1))
    base = steps.build_cell(arch, "ml1m_fit").fn(None, r)
    fused = steps.build_cell(arch, "ml1m_fit", "fused").fn(None, r)
    for a, b in zip(base, fused):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown CF variant"):
        steps.build_cell(arch, "ml1m_fit", "landmark")


def test_predict_cell_matches_reference_cell():
    u, p = 64, 40
    fit_dims = dict(n_users=u, n_items=p)
    jarch, arch = _archs("cf_fit", "ml1m_fit", fit_dims)
    r = _ratings(u, p, u, seed=2)
    with _mesh():
        _, _, j_w, j_i = jbuild_cell(jarch, "ml1m_fit", _mesh()).jit()(
            jax.random.PRNGKey(0), jnp.asarray(r))
    dims = dict(n_users=u, n_items=p, n_pairs=PAIRS)
    jarch, arch = _archs("cf_predict", "ml1m_predict", dims)
    jcell = jbuild_cell(jarch, "ml1m_predict", _mesh())
    cell = steps.build_cell(arch, "ml1m_predict")
    assert [tuple(a.shape) for a in cell.args] == [
        tuple(a.shape) for a in jcell.args]
    rng = np.random.default_rng(3)
    users = rng.integers(0, u, PAIRS).astype(np.int32)
    items = rng.integers(0, p, PAIRS).astype(np.int32)
    with _mesh():
        want = jcell.jit()(j_w, j_i, jnp.asarray(r), jnp.asarray(users),
                           jnp.asarray(items))
    # the reference's graph, carried across, so only Eq. (1) is compared
    got = cell.fn(torch.as_tensor(np.array(j_w)),
                  torch.as_tensor(np.array(j_i)), torch.as_tensor(r),
                  torch.as_tensor(users), torch.as_tensor(items))
    assert got.shape == (PAIRS,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_registry_cf_shapes_build():
    """Every registry CF shape builds: f32 ratings at every size (the
    reference's bf16 past 100,000 users is not kept: kernel 1 reads f32),
    users padded to 8."""
    arch = registry.get("landmark_cf")
    jarch = jregistry.get("landmark_cf")
    assert arch.family == jarch.family == "cf"
    assert [s.name for s in arch.shapes] == [s.name for s in jarch.shapes]
    for s in arch.shapes:
        cell = steps.build_cell(arch, s.name)
        r = cell.args[1] if s.kind == "cf_fit" else cell.args[2]
        assert r.dtype == torch.float32 and r.device.type == "meta"
        assert r.shape == (-(-s.dims["n_users"] // 8) * 8, s.dims["n_items"])
