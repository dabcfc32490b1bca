"""Parity of the fused IVF probe (kernel 5, ``kernels/ivf_probe.py``) with
the reference's ``fused_probe_topk``, on the CPU: the port's wrapper runs
its plain version on CPU tensors, the reference's Pallas kernel runs in
interpret mode (so the batches stay small: b · nprobe grid steps).

Tolerances:
- scores: rtol=1e-5, atol=1e-6 (f32 dot products summed in different
  orders; bf16 and int8 payloads are dequantized exactly the same way);
- ids: equal where the reference's scores do not tie within that tolerance
  at the cut (``core.topk.list_mismatches``); empty slots are (-inf, 0) in
  both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ivf_probe import fused_probe_topk as j_fused
import repro_torch.core as T
from repro_torch.core.topk import list_mismatches
from repro_torch.kernels import ivf_probe, ops

RTOL, ATOL = 1e-5, 1e-6


def _layout(c, cap, n, seed, payload="f32", empty=(0,)):
    """Posting lists with ragged fills (``empty`` cells hold nothing), ids
    a permutation, payload rows random normal (quantized for bf16/int8)."""
    rng = np.random.default_rng(seed)
    fill = rng.integers(1, cap + 1, c).astype(np.int32)
    fill[list(empty)] = 0
    ids = rng.permutation(int(fill.sum())).astype(np.int32)
    lists = np.zeros((c, cap), np.int32)
    rows = np.zeros((c, cap, n), np.float32)
    o = 0
    for j in range(c):
        lists[j, :fill[j]] = ids[o:o + fill[j]]
        rows[j, :fill[j]] = rng.normal(size=(fill[j], n))
        o += fill[j]
    scale = None
    if payload == "int8":
        scale = (np.abs(rows).max(-1) / np.float32(127)).astype(np.float32)
        rows = np.round(rows / np.maximum(scale, 1e-8)[..., None]).astype(
            np.int8)
    return lists, rows, scale, fill


def _run_both(q, probe, lists, rows, scale, fill, k, measure, sids, ok,
              payload):
    jrows = (jnp.asarray(rows).astype(jnp.bfloat16) if payload == "bf16"
             else jnp.asarray(rows))
    want = j_fused(jnp.asarray(q), jnp.asarray(probe), jnp.asarray(lists),
                   jrows, None if scale is None else jnp.asarray(scale),
                   jnp.asarray(fill), k=k, measure=measure,
                   self_ids=jnp.asarray(sids),
                   probe_ok=None if ok is None else jnp.asarray(ok),
                   interpret=True)
    trows = torch.as_tensor(rows)
    if payload == "bf16":
        trows = trows.to(torch.bfloat16)
    got = ivf_probe.fused_probe_topk(
        torch.as_tensor(q), torch.as_tensor(probe), torch.as_tensor(lists),
        trows, None if scale is None else torch.as_tensor(scale),
        torch.as_tensor(fill), k=k, measure=measure,
        self_ids=torch.as_tensor(sids),
        probe_ok=None if ok is None else torch.as_tensor(ok))
    return [np.asarray(x) for x in want], got


@pytest.mark.parametrize("measure", T.MEASURES)
@pytest.mark.parametrize("payload", ["f32", "bf16", "int8"])
def test_fused_probe_plain_version_matches_reference_kernel(measure, payload):
    """C = 7 (not a multiple of 8) with an empty cell, self ids among the
    candidates, a probe_ok mask, every payload type."""
    c, cap, n, b, nprobe, k = 7, 12, 10, 6, 3, 8
    lists, rows, scale, fill = _layout(c, cap, n, seed=1, payload=payload)
    rng = np.random.default_rng(2)
    q = rng.normal(size=(b, n)).astype(np.float32)
    probe = np.stack([rng.permutation(c)[:nprobe] for _ in range(b)]
                     ).astype(np.int32)
    sids = lists[probe[:, 0], 0].copy()  # each query's first-probed id
    sids[0] = -1
    ok = rng.random((b, nprobe)) > 0.25
    (wv, wi), (v, i) = _run_both(q, probe, lists, rows, scale, fill, k,
                                 measure, sids, ok, payload)
    bad = list_mismatches(wv, wi, v, i, RTOL, ATOL)
    assert bad.size == 0, bad
    assert not (i.numpy() == sids[:, None]).any()
    np.testing.assert_array_equal(np.isfinite(wv), torch.isfinite(v).numpy())
    assert (i.numpy()[~np.isfinite(wv)] == 0).all()  # empty slots (-inf, 0)


@pytest.mark.parametrize("measure", T.MEASURES)
def test_fused_probe_k_above_live_candidates(measure):
    """Cells of at most 2 live slots and k = 9: the tail of every list is
    empty, in canonical order in both."""
    c, cap, n, b = 5, 2, 6, 4
    lists, rows, scale, fill = _layout(c, cap, n, seed=3, empty=(1, 3))
    rng = np.random.default_rng(4)
    q = rng.normal(size=(b, n)).astype(np.float32)
    probe = np.stack([rng.permutation(c)[:3] for _ in range(b)]
                     ).astype(np.int32)
    sids = np.full(b, -1, np.int32)
    (wv, wi), (v, i) = _run_both(q, probe, lists, rows, None, fill, 9,
                                 measure, sids, None, "f32")
    np.testing.assert_allclose(v.numpy(), wv, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(i.numpy(), wi)
    assert np.isinf(wv[:, -1]).all()


def test_fused_probe_ties_break_to_the_lowest_id():
    """Duplicate payload rows score equal: the lowest id comes first, as in
    the reference kernel, whatever the probe order."""
    c, cap, n = 3, 4, 5
    base = np.random.default_rng(5).normal(size=(1, n)).astype(np.float32)
    rows = np.repeat(base[None], c * cap, axis=1).reshape(c, cap, n)
    lists = np.array([[7, 3, 11, 0], [5, 9, 1, 0], [2, 8, 4, 6]], np.int32)
    fill = np.array([3, 3, 4], np.int32)
    probe = np.array([[2, 0, 1], [1, 2, 0]], np.int32)
    q = np.random.default_rng(6).normal(size=(2, n)).astype(np.float32)
    (wv, wi), (v, i) = _run_both(q, probe, lists, rows, None, fill, 6,
                                 "cosine", np.array([-1, 2], np.int32), None,
                                 "f32")
    np.testing.assert_array_equal(i.numpy(), wi)
    assert i[0].tolist() == [1, 2, 3, 4, 5, 6]
    assert i[1].tolist() == [1, 3, 4, 5, 6, 7]


def test_fused_wrapper_never_launches_for_cpu_tensors():
    ops.reset_launches()
    lists, rows, scale, fill = _layout(4, 6, 5, seed=7)
    q = torch.zeros((3, 5))
    probe = torch.zeros((3, 2), dtype=torch.int32)
    probe[:, 1] = 1
    ivf_probe.fused_probe_topk(q, probe, torch.as_tensor(lists),
                               torch.as_tensor(rows), None,
                               torch.as_tensor(fill), k=4)
    assert ivf_probe.fused_probe_topk.launches == 0
