"""The port's gradient compression (``repro_torch.distributed.compression``)
against the reference's (``repro.distributed.compression``), on the CPU.

The same f32 inputs, made from a seed with numpy, go through both. The
quantizers run the same f32 operations in the same order (the scale
max|x| / 127 + 1e-12, codes round-half-even(x / scale) clipped to ±127;
the port divides by tensors, never by a host scalar), so codes, scales,
residuals and dequantized values are bitwise the reference's, ties at
exactly .5 included. The error-feedback residual is exact and within
scale / 2 of each element, as ``tests/test_properties.py::
test_quantized_compression_error_bound`` asks. ``psum_compressed`` runs on
the port's ``make_debug_mesh(device="cpu")``; the expected sum is computed
with the reference's own quantizers on one device (the input is
replicated, so every position's codes and scale are the same:
dequantize(n·codes, scale)), which keeps this test free of the JAX host
device count.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.distributed import compression as J
from repro_torch.distributed import compression as T
from repro_torch.launch.mesh import make_debug_mesh, make_host_mesh

SCALES = (1e-6, 1e-2, 1.0, 3e3)


def _x(seed, shape=(37, 53), scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x.flat[0] = 127.0 * scale  # max|x| = 127·scale: the scale is ~exact
    x.flat[1] = 2.5 * scale    # and x / scale lands on .5: a tie
    return x


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


@pytest.mark.parametrize("scale", SCALES)
def test_quantize_dequantize_bitwise_reference(scale):
    for seed in range(8):
        x = _x(seed, scale=scale)
        jq, js = J.quantize_int8(jnp.asarray(x))
        tq, ts = T.quantize_int8(torch.as_tensor(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
        np.testing.assert_array_equal(
            _bits(T.dequantize_int8(tq, ts).numpy()),
            _bits(J.dequantize_int8(jq, js)))


def test_round_half_even_at_ties():
    """±2.5 and ±3.5 steps round to the even code, as ``jnp.round``."""
    x = np.array([127.0, 2.5, -2.5, 3.5, -3.5, 0.5, -0.5], np.float32)
    tq, ts = T.quantize_int8(torch.as_tensor(x))
    jq, _ = J.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.tolist()[1:] == [2, -2, 4, -4, 0, 0]


@pytest.mark.parametrize("scale", SCALES)
def test_compress_with_feedback_bitwise_and_exact(scale):
    for seed in range(6):
        g = _x(seed, (64, 64), scale)
        buf = _x(seed + 100, (64, 64), scale * 0.01)
        jq, js, je = J.compress_with_feedback(jnp.asarray(g), jnp.asarray(buf))
        tq, ts, te = T.compress_with_feedback(torch.as_tensor(g),
                                              torch.as_tensor(buf))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
        np.testing.assert_array_equal(_bits(te.numpy()), _bits(je))
        # the residual is exactly what the payload leaves out, and each
        # element is within half a step of its code
        total = torch.as_tensor(g) + torch.as_tensor(buf)
        deq = T.dequantize_int8(tq, ts)
        assert torch.equal(te, total - deq)
        assert float((total - deq).abs().max()) <= float(ts) * 0.5 + 1e-6


def test_tree_compress_and_error_buffers_bitwise_reference():
    rng = np.random.default_rng(7)
    shapes = {"w1": (16, 8), "b1": (8,), "emb": (5, 3, 4)}
    grads = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    tg = {k: torch.as_tensor(v) for k, v in grads.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    tbuf, jbuf = T.init_error_buffers(tg), J.init_error_buffers(jg)
    for k in shapes:
        assert tbuf[k].dtype == torch.float32 and not tbuf[k].any()
    for step in range(3):  # the residuals carried three steps
        (tq, ts), tbuf, tdeq = T.tree_compress(tg, tbuf)
        (jq, js), jbuf, jdeq = J.tree_compress(jg, jbuf)
        for k in shapes:
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
            np.testing.assert_array_equal(_bits(ts[k].numpy()), _bits(js[k]))
            np.testing.assert_array_equal(_bits(tbuf[k].numpy()),
                                          _bits(jbuf[k]))
            np.testing.assert_array_equal(_bits(tdeq[k].numpy()),
                                          _bits(jdeq[k]))
    # a bf16 gradient dequantizes back to bf16
    (_, _), _, deq = T.tree_compress({"h": tg["w1"].bfloat16()},
                                     {"h": torch.zeros(16, 8)})
    assert deq["h"].dtype == torch.bfloat16


@pytest.mark.parametrize("multi_pod,axis", [(False, "data"), (False, "model"),
                                            (True, "pod"), (True, "data")])
def test_psum_compressed_on_the_debug_mesh(multi_pod, axis):
    mesh = make_debug_mesh(multi_pod=multi_pod, device="cpu")
    n = mesh.shape[axis]
    x = np.random.default_rng(3).normal(size=(32, 32)).astype(np.float32)
    out = T.psum_compressed(torch.as_tensor(x), mesh, axis=axis)
    q, s = J.quantize_int8(jnp.asarray(x))
    want = J.dequantize_int8(jnp.asarray(q, jnp.int32) * n, s)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(want))
    # test_distributed.py::test_psum_compressed_close_to_exact's bound
    scale = float(np.abs(x).max()) / 127.0
    assert float(np.abs(out.numpy() - x * n).max()) <= n * scale + 1e-5


def test_psum_compressed_axis_not_in_mesh_is_identity():
    x = torch.randn(4, 5)
    assert T.psum_compressed(x, make_host_mesh("cpu"), axis="pod") is x
