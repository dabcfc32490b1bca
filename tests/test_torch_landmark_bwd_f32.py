"""The arithmetic of kernel 7's backward on float32 inputs, on the CPU.

``csrc/landmark_summary_bwd.cu``'s ``f32_split`` route (f32 q, k, v split
into 3, 3 and 2 bf16 planes, dO into 2; two passes of TMA + wgmma, 27 bf16
products, P and dS split into hi and lo) cannot run here.
``kernels/ref.py::landmark_summary_bwd_f32_split_ref`` does its arithmetic
in plain torch: the same planes, tiles, product order, online statistics in
log2 units and hi/lo roundings. It is held here

- to ``jax.vjp`` of the reference's plain landmark summary
  (``repro/kernels/ref.py::landmark_summary_ref``) in float32, within
  ``BWD_REL`` = 1e-4 of each gradient's largest |value| (the bound
  ``chip_smoke.py`` holds the kernel to on the card), on the seeded numpy
  inputs of ``tests/test_torch_landmark_grad.py`` (ragged S, n off the
  query tile, every head dim of the route, P > 1) and on q and k scaled 4×;
- to the plain backward ``ref.landmark_summary_bwd_ref`` at every tiling
  the kernel takes (64- and 32-key tiles in pass 1, 64- and 32-row query
  tiles in pass 2), within the same bound;

and leaving out each second-term product (K1 in dQ, q1 in dK, V1 in dP and
dPᵀ) is shown to break the bound, which is why the kernel issues all 27.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels import ref as jref

from repro_torch.kernels import ops, ref
from repro_torch.kernels import landmark_attention as lsum

BWD_REL = 1e-4  # chip_smoke.py::BWD_REL


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _inputs(p, n, s, d, seed):
    """q, k, v, dout as tests/test_torch_landmark_grad.py makes them
    (P = 0: one 2-D problem)."""
    shape = (lambda rows: (p, rows, d)) if p else (lambda rows: (rows, d))
    return (_normal(shape(n), seed), _normal(shape(s), seed + 1),
            _normal(shape(s), seed + 2), _normal(shape(n), seed + 3))


def _tiles(d):
    """(block_k, block_q) of the kernel's f32 form at head dim ``d``."""
    return (32, 32) if d == 128 else (64, 64)


def _torch_args(p, n, s, d, seed, qk_scale=1.0):
    q, k, v, do = (torch.as_tensor(x) for x in _inputs(p, n, s, d, seed))
    q, k = q * qk_scale, k * qk_scale
    scale = 1.0 / np.sqrt(d)
    return q, k, v, ref.landmark_summary_ref(q, k, v, scale), do, scale


def _rel(got, want):
    return [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]


# (P, n, S, D, scale of q and k): test_torch_landmark_grad.py's shapes on
# this route (one problem, ragged S, n off every query tile, P > 1, one
# key), kernel 7's phase-16a shapes, and q, k scaled 4× (scores 16× unit)
JAX_SHAPES = [(0, 16, 777, 32, 1.0), (3, 70, 130, 64, 1.0),
              (2, 33, 100, 128, 1.0), (4, 1, 1, 64, 1.0),
              (2, 100, 1000, 32, 1.0), (3, 70, 777, 64, 1.0),
              (2, 100, 300, 128, 1.0), (1, 128, 1024, 64, 4.0)]


@pytest.mark.parametrize("p,n,s,d,qk_scale", JAX_SHAPES)
def test_f32_split_backward_matches_jax_vjp(p, n, s, d, qk_scale):
    q, k, v, do = _inputs(p, n, s, d, seed=n + s)
    q, k = q * qk_scale, k * qk_scale
    scale = 1.0 / np.sqrt(d)
    fn = lambda a, b, c: jref.landmark_summary_ref(a, b, c, scale)
    if p:
        fn = jax.vmap(fn)
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(w) for w in vjp(jnp.asarray(do))]
    block_k, block_q = _tiles(d)
    got = ref.landmark_summary_bwd_f32_split_ref(
        *(torch.as_tensor(x) for x in (q, k, v)),
        torch.as_tensor(np.asarray(out)), torch.as_tensor(do), scale,
        block_k=block_k, block_q=block_q)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
        err = float(np.abs(g.numpy() - w).max())
        if s == 1 and i < 2:
            # one key: P = 1, so dS = dO·V − dO·O and with it dq and dk are
            # 0 in exact arithmetic; held to BWD_REL of the terms that
            # cancel, scale · max |dO| |V|ᵀ times max |k| (dq) or |q| (dk)
            terms = scale * float((np.abs(do) @ np.abs(v).swapaxes(-1, -2))
                                  .max()) * float(np.abs((k, q)[i]).max())
            assert err < BWD_REL * terms, (err, terms)
        else:
            assert err < BWD_REL * float(np.abs(w).max()), (i, err)


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("block_k,block_q", [(64, 64), (32, 32), (64, 32),
                                             (32, 64)])
def test_f32_split_backward_any_tiling(d, block_k, block_q):
    """The tiles change only the order of f32 sums: every tiling the
    kernel's forms use, at every head dim, within the bound of the plain
    backward."""
    args = _torch_args(2, 100, 777, d, seed=11 + d)
    want = ref.landmark_summary_bwd_ref(*args)
    got = ref.landmark_summary_bwd_f32_split_ref(*args, block_k=block_k,
                                                 block_q=block_q)
    assert max(_rel(got, want)) < BWD_REL, _rel(got, want)


# each second term and the gradients it reaches: K1 only dQ, q1 only dK, V1
# both (through dP and dPᵀ into dS)
REACHES = {"k1": (0,), "q1": (1,), "v1": (0, 1)}


@pytest.mark.parametrize("drop", sorted(REACHES))
@pytest.mark.parametrize("p,n,s,d,qk_scale", [(3, 70, 777, 64, 1.0),
                                              (2, 100, 300, 128, 1.0),
                                              (1, 128, 1024, 64, 4.0)])
def test_dropping_a_second_term_breaks_the_bound(p, n, s, d, qk_scale, drop):
    """Without its second-term product, each gradient that the term reaches
    goes past BWD_REL of the plain backward, while the full 27 products
    stay inside it: the kernel needs every one."""
    args = _torch_args(p, n, s, d, seed=n + s + d, qk_scale=qk_scale)
    block_k, block_q = _tiles(d)
    want = ref.landmark_summary_bwd_ref(*args)
    full = _rel(ref.landmark_summary_bwd_f32_split_ref(
        *args, block_k=block_k, block_q=block_q), want)
    dropped = _rel(ref.landmark_summary_bwd_f32_split_ref(
        *args, block_k=block_k, block_q=block_q, drop=(drop,)), want)
    assert max(full) < BWD_REL, full
    for i in REACHES[drop]:
        assert dropped[i] > BWD_REL, (drop, i, dropped)


def test_f32_split_ref_rejects_an_unknown_term():
    args = _torch_args(1, 8, 16, 32, seed=3)
    with pytest.raises(ValueError, match="unknown terms"):
        ref.landmark_summary_bwd_f32_split_ref(*args, drop=("v2",))


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_summary_function_on_cpu_f32_takes_the_plain_version(d):
    """The ``LandmarkSummary`` Function on CPU float32 tensors: gradients
    of the plain backward bit for bit, and no launch, route or split pass
    counted, though on the card these inputs take ``f32_split`` (D ≤ 128)
    or ``fma``."""
    q, k, v, _, do, scale = _torch_args(2, 40, 150, d, seed=d)
    ops.reset_launches()
    lsum.bf16_terms.launches = 0
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.landmark_summary(*a)
    out.backward(do)
    want = ref.landmark_summary_bwd_ref(q, k, v, out.detach(), do, scale)
    for x, w in zip(a, want):
        assert x.grad.dtype == torch.float32
        torch.testing.assert_close(x.grad, w, rtol=0, atol=0)
    assert lsum.bwd_route(torch.float32, d) == (
        "f32_split" if d <= 128 else "fma")
    assert ops.launch_counts()["landmark_summary_bwd"] == 0
    assert not any(lsum.landmark_summary_bwd.route_launches.values())
    assert not any(lsum.landmark_summary.route_launches.values())
    assert lsum.bf16_terms.launches == 0
