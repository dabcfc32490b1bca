"""The port's distributed embedding (``distributed/embedding.py``) and the
recsys generators against the JAX reference, on the CPU.

Both packages get the same numpy tables and ids (made from a seed).

Tolerances:
- a lookup and a bag: equal to the reference (rows are copied, and a bag
  adds the same f32 values in the same order), stated as rtol 1e-5,
  atol 1e-6 for the bag's mean (a division);
- the lookup's gradient (``Gather``'s backward, the fixed-order segment
  sum) against ``jax.grad`` of the reference's lookup (XLA's
  scatter-add): rtol 1e-5, atol 1e-6 (f32);
- the mesh form against the plain form: bitwise, values and gradients
  (one shard gives a row its value, every other adds +0);
- ``distributed_topk`` against ``lax.top_k`` on tie-heavy scores: equal
  values and ids;
- ``segment_sum_ref`` at a Zipf head longer than its device slots:
  bitwise ``jax.ops.segment_sum``;
- the generators: byte-identical arrays.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.data import synthetic as JS
from repro.distributed import embedding as JE

from repro_torch.data import synthetic as S
from repro_torch.distributed import embedding as E
from repro_torch.kernels import ref
from repro_torch.kernels.segment_sum import build_csr
from repro_torch.launch.mesh import make_mesh

RTOL, ATOL = 1e-5, 1e-6


def _inputs(rows=64, dim=6, shape=(5, 7), seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(rows, dim)).astype(np.float32)
    ids = rng.integers(-1, rows, shape).astype(np.int32)
    ids[0, :3] = -1
    return table, ids


def _zipf_ids(shape, n_items, seed=0):
    """seq_rec_batch's item law: item 0 holds 56.5% of the ids."""
    u = np.random.default_rng(seed).random(shape)
    return (np.minimum(u ** (-1.0 / 1.2) - 1.0, n_items - 1) % n_items
            ).astype(np.int32)


@pytest.mark.parametrize("shape", [(5, 7), (11,), (3, 4, 2)])
def test_lookup_with_padding_equals_reference(shape):
    table, ids = _inputs(shape=shape if len(shape) > 1 else (1, 11))
    ids = ids.reshape(shape)
    want = np.asarray(JE.embedding_lookup(jnp.asarray(table),
                                          jnp.asarray(ids)))
    got = E.embedding_lookup(torch.as_tensor(table), torch.as_tensor(ids))
    assert got.shape == ids.shape + (table.shape[1],)
    np.testing.assert_array_equal(got.numpy(), want)
    pad = got[torch.as_tensor(ids) < 0]
    assert torch.equal(pad, torch.zeros_like(pad))
    assert not torch.signbit(pad).any()  # +0, as jnp.where gives


@pytest.mark.parametrize("zipf", [False, True])
def test_lookup_gradient_equals_jax_grad(zipf):
    """``Gather``'s backward against the reference's scatter-add gradient,
    with a cotangent from a seed; Zipf ids give a segment past the plain
    version's device slots."""
    rows, dim = 64, 6
    table, ids = _inputs(rows, dim, (40, 50))
    if zipf:
        ids = _zipf_ids((40, 50), rows)
        ids[:2, :4] = -1
    cot = np.random.default_rng(1).normal(size=ids.shape + (dim,)
                                          ).astype(np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(JE.embedding_lookup(
        t, jnp.asarray(ids)) * cot))(jnp.asarray(table)))
    t = torch.tensor(table, requires_grad=True)
    (E.embedding_lookup(t, torch.as_tensor(ids)) * torch.as_tensor(cot)
     ).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=RTOL, atol=ATOL)
    # the plain form's backward is the segment sum over one CSR of the ids
    csr = E.lookup_csr(torch.as_tensor(ids), rows)
    flat = torch.as_tensor(cot).reshape(-1, dim)
    assert torch.equal(t.grad, ref.segment_sum_ref(flat, csr.perm,
                                                   csr.indptr))


def test_lookup_without_grad_builds_no_csr(monkeypatch):
    """Serving gathers with index_select alone: no CSR, the same values."""
    table, ids = _inputs()
    tt, ti = torch.as_tensor(table), torch.as_tensor(ids)
    want = E.embedding_lookup(tt.clone().requires_grad_(), ti).detach()
    monkeypatch.setattr(E, "lookup_csr", lambda *a: pytest.fail("CSR"))
    assert torch.equal(E.embedding_lookup(tt, ti), want)
    with torch.no_grad():
        assert torch.equal(E.embedding_lookup(tt.requires_grad_(), ti), want)


@pytest.mark.parametrize("mode,weighted", [("sum", False), ("mean", False),
                                           ("sum", True), ("mean", True)])
def test_embedding_bag_equals_reference(mode, weighted):
    table, ids = _inputs(shape=(6, 9))
    w = (np.random.default_rng(2).random(ids.shape).astype(np.float32)
         if weighted else None)
    want = np.asarray(JE.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), mode,
        None if w is None else jnp.asarray(w)))
    got = E.embedding_bag(torch.as_tensor(table), torch.as_tensor(ids), mode,
                          None if w is None else torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("axes", [(("model",), (4,)),
                                  (("data", "model"), (2, 4)),
                                  (("data",), (2,))])
def test_mesh_lookup_is_bitwise_the_plain_form(axes):
    """The row-sharded lookup (shard s gathers its row range, the partials
    added in shard order) against the plain lookup: values and the
    table's gradient bit for bit (a mesh without ``model`` is the plain
    form)."""
    table, ids = _inputs(rows=64, shape=(8, 10))
    ids[3] = _zipf_ids((10,), 64)
    cot = torch.as_tensor(np.random.default_rng(3).normal(
        size=ids.shape + (table.shape[1],)).astype(np.float32))
    mesh = make_mesh(*axes, "cpu")
    out = {}
    for tag, m in (("plain", None), ("mesh", mesh)):
        t = torch.tensor(table, requires_grad=True)
        val = E.embedding_lookup(t, torch.as_tensor(ids), m)
        (val * cot).sum().backward()
        out[tag] = (val.detach(), t.grad)
    assert torch.equal(out["mesh"][0], out["plain"][0])
    assert torch.equal(out["mesh"][1], out["plain"][1])


def test_mesh_lookup_refuses_rows_that_do_not_divide_the_axis():
    table, ids = _inputs(rows=66)
    with pytest.raises(ValueError, match="must divide the 'model' axis"):
        E.embedding_lookup(torch.as_tensor(table), torch.as_tensor(ids),
                           make_mesh(("model",), (4,), "cpu"))


@pytest.mark.parametrize("k", [1, 10, 100])
def test_distributed_topk_equals_lax_top_k_under_ties(k):
    rng = np.random.default_rng(4)
    scores = rng.integers(0, 7, (3, 500)).astype(np.float32) / 4
    scores[1, 100:] = -np.inf
    wv, wi = jax.lax.top_k(jnp.asarray(scores), k)
    gv, gi = E.distributed_topk(torch.as_tensor(scores), k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_segment_sum_ref_zipf_head_is_jax_segment_sum():
    """A segment of thousands of members (past ``SEG_REF_SLOTS``) finishes
    its chain on the host in index order: still jax.ops.segment_sum's
    bits."""
    idx = _zipf_ids((30000,), 1000).astype(np.int64)
    x = torch.randn((30000, 4), generator=torch.Generator().manual_seed(5))
    csr = build_csr(torch.as_tensor(idx), 1000)
    assert int((csr.indptr[1:] - csr.indptr[:-1]).max()) > 100 * \
        ref.SEG_REF_SLOTS
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(x.numpy()),
                                          jnp.asarray(idx), 1000))
    np.testing.assert_array_equal(
        ref.segment_sum_ref(x, csr.perm, csr.indptr).numpy(), want)


@pytest.mark.parametrize("step", [0, 3])
def test_fm_train_batch_equals_reference(step):
    vocabs = (100, 50, 20, 10, 5)
    want, got = (JS.fm_train_batch(0, step, 64, vocabs),
                 S.fm_train_batch(0, step, 64, vocabs))
    assert want.keys() == got.keys()
    for key in want:
        assert want[key].dtype == got[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("n_mask,n_neg", [(0, 0), (4, 0), (0, 32), (4, 32)])
def test_seq_rec_batch_equals_reference(n_mask, n_neg):
    want = JS.seq_rec_batch(0, 2, 16, 20, 1000, n_mask, n_neg)
    got = S.seq_rec_batch(0, 2, 16, 20, 1000, n_mask, n_neg)
    assert want.keys() == got.keys()
    for key in want:
        assert want[key].dtype == got[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
