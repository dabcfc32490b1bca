"""The arithmetic of kernel 7's backward on the tensor cores, on the CPU.

``csrc/landmark_summary_bwd.cu``'s tensor-core route (bf16 q, k, v; two
passes of TMA + wgmma, with P, dS and dO each split into two bf16 terms)
cannot run here. ``kernels/ref.py::landmark_summary_bwd_split_ref`` does its
arithmetic in plain torch: the same tiles, online statistics in log2 units
and hi/lo roundings. It is held here

- to the plain backward ``ref.landmark_summary_bwd_ref`` on the same bf16
  inputs, within ``BWD_REL`` = 1e-4 of each gradient's largest |value| (the
  bound ``chip_smoke.py`` holds the kernel to on the card), at ragged S, n
  off the 64-row tile and every head dim;
- to ``jax.vjp`` of the reference's plain landmark summary
  (``repro/kernels/ref.py::landmark_summary_ref``) on the seeded numpy
  inputs of ``tests/test_torch_landmark_grad.py``, rounded to bf16 as the
  route takes them, within the same bound;

and one bf16 term of P, dS and dO (``split=False``) is shown to break the
bound, which is why the kernel splits them.
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


def _bf16(x):
    """numpy f32 → the f32 value of its bf16 rounding."""
    return torch.as_tensor(x).bfloat16().float().numpy()


def _inputs(p, n, s, d, seed):
    """bf16 q, k, v (P, n|S, D), f32 out = softmax(q kᵀ/√D) v and dout."""
    q, k, v = (torch.as_tensor(_normal((p, rows, d), seed + i)).bfloat16()
               for i, rows in enumerate((n, s, s)))
    scale = 1.0 / np.sqrt(d)
    out = ref.landmark_summary_ref(q, k, v, scale)
    return q, k, v, out, torch.as_tensor(_normal((p, n, d), seed + 3)), scale


def _rel(got, want):
    return [float((g - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]


# (P, n, S, D): ragged S (777, no multiple of a tile), n off the 64-row
# tile (70, 100, 33, 1), every head dim of the tensor-core route and 256
SHAPES = [(2, 100, 1000, 32), (3, 70, 777, 64), (2, 100, 300, 128),
          (1, 33, 777, 256), (2, 128, 512, 64), (1, 1, 2, 64),
          (2, 64, 777, 32), (1, 200, 130, 128)]
# With one key P = 1, so dS = dO·V − Δ = dO·V − dO·O is 0 and so are dq and
# dk: every version returns rounding noise there, which a bound relative to
# max |plain| cannot judge. Those gradients are held to BWD_REL of the terms
# that cancel instead: scale · max |dO| |V|ᵀ times max |k| (dq) or max |q|
# (dk).


@pytest.mark.parametrize("p,n,s,d", SHAPES)
def test_split_backward_matches_plain(p, n, s, d):
    args = _inputs(p, n, s, d, seed=n + s + d)
    got = ref.landmark_summary_bwd_split_ref(*args)
    want = ref.landmark_summary_bwd_ref(*args)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert bool(torch.isfinite(g).all())
    assert max(_rel(got, want)) < BWD_REL, _rel(got, want)


# the shapes of test_torch_landmark_grad.py::test_plain_backward_matches_jax_vjp
# (P = 0: one 2-D problem)
JAX_SHAPES = [(0, 16, 777, 32), (3, 70, 130, 64), (2, 33, 100, 128),
              (2, 20, 45, 256), (4, 1, 1, 64)]


@pytest.mark.parametrize("p,n,s,d", JAX_SHAPES)
def test_split_backward_matches_jax_vjp(p, n, s, d):
    shape = (lambda rows: (p, rows, d)) if p else (lambda rows: (rows, d))
    seed = n + s
    q, k, v = (_bf16(_normal(shape(rows), seed + i))
               for i, rows in enumerate((n, s, s)))
    do = _normal(shape(n), seed + 3)
    scale = 1.0 / np.sqrt(d)
    fn = lambda a, b, c: jref.landmark_summary_ref(a, b, c, scale)
    if p:
        fn = jax.vmap(fn)
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(w) for w in vjp(jnp.asarray(do))]
    got = ref.landmark_summary_bwd_split_ref(
        *(torch.as_tensor(x) for x in (q, k, v)),
        torch.as_tensor(np.asarray(out)), torch.as_tensor(do), scale)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        err = float(np.abs(g.numpy() - w).max())
        if s == 1 and i < 2:  # dq, dk: zero in exact arithmetic
            terms = scale * float((np.abs(do) @ np.abs(v).swapaxes(-1, -2))
                                  .max()) * float(np.abs((k, q)[i]).max())
            assert err < BWD_REL * terms, (err, terms)
        else:
            assert err < BWD_REL * float(np.abs(w).max()), err


@pytest.mark.parametrize("p,n,s,d", [(3, 70, 777, 64), (2, 100, 300, 128)])
def test_one_bf16_term_breaks_the_bound(p, n, s, d):
    """Rounded to one bf16 term each, P, dS and dO put some gradient past
    BWD_REL: the kernel's second terms are needed."""
    args = _inputs(p, n, s, d, seed=n + s + d)
    want = ref.landmark_summary_bwd_ref(*args)
    one = ref.landmark_summary_bwd_split_ref(*args, split=False)
    assert max(_rel(one, want)) > BWD_REL


@pytest.mark.parametrize("block", [(64, 64), (32, 128), (128, 32)])
def test_split_backward_any_tiling(block):
    """The tiles change only the order of f32 sums: every tiling within
    the bound, the kernel's (64, 64) among them."""
    args = _inputs(2, 100, 777, 64, seed=11)
    want = ref.landmark_summary_bwd_ref(*args)
    got = ref.landmark_summary_bwd_split_ref(*args, block_k=block[0],
                                             block_q=block[1])
    assert max(_rel(got, want)) < BWD_REL


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 32, "tensor_core"), (torch.bfloat16, 64, "tensor_core"),
    (torch.bfloat16, 128, "tensor_core"), (torch.bfloat16, 256, "fma"),
    (torch.float32, 64, "f32_split"), (torch.float32, 256, "fma"),
    (torch.float32, 32, "f32_split"), (torch.float32, 128, "f32_split")])
def test_backward_route_by_dtype_and_head_dim(dtype, d, route):
    assert lsum.bwd_route(dtype, d) == route


def test_cpu_backward_counts_no_route():
    """On CPU tensors the wrapper takes the plain version: no launch and no
    route counted, whatever the dtype."""
    args = _inputs(2, 9, 40, 32, seed=1)
    ops.reset_launches()
    got = lsum.landmark_summary_bwd(*args)
    want = ref.landmark_summary_bwd_ref(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert lsum.landmark_summary_bwd.launches == 0
    assert sum(lsum.landmark_summary_bwd.route_launches.values()) == 0
