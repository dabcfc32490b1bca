"""The port's landmark summary and landmark attention against the JAX
reference, on the CPU.

Both packages get the same numpy inputs. On CPU tensors
``ops.landmark_summary`` takes its plain version (a dense f32 softmax); the
reference's ``landmark_summary_kernel`` runs its Pallas kernel in interpret
mode, as ``tests/test_kernels.py`` runs it.

Tolerances:
- the summary: rtol=1e-4, atol=1e-5 — the reference's own kernel-vs-oracle
  tolerance (``tests/test_kernels.py``): a streamed softmax against a dense
  one, f32 sums in another order;
- landmark attention in f32: rtol=1e-4, atol=2e-5 — the same f32 sums, then
  eight Newton–Schulz iterations on an n × n softmax (a pseudo-inverse
  amplifies a last-bit difference by the matrix's condition number, which
  stays small for these segment-mean landmarks);
- the tensor-core kernel's arithmetic (``ref.landmark_summary_split_ref``:
  bf16 products summed in f32, P split into two bf16 terms) on bf16
  inputs, and the f32 route's (``ref.landmark_summary_f32_split_ref``: q
  and k as three bf16 terms, v as two) on f32 inputs: rtol=1e-4, atol=1e-5,
  the summary's bound, against the reference and against the dense plain
  version;
- the split into bf16 terms: exact (three terms hold a normal f32 value).
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels.landmark_attention import landmark_summary_kernel
from repro.models import layers as jlayers

from repro_torch.kernels import ops, ref
from repro_torch.kernels import landmark_attention as lsum
from repro_torch.models import layers

RTOL, ATOL = 1e-4, 1e-5


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("n,s,d", [(64, 1024, 64), (128, 2048, 128),
                                   (32, 512, 256)])
def test_summary_matches_reference_kernel(n, s, d):
    q, k, v = _normal((n, d), 1), _normal((s, d), 2), _normal((s, d), 3)
    want = landmark_summary_kernel(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), 1.0 / np.sqrt(d))
    got = ops.landmark_summary(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v))
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_summary_ragged_sequence_matches_reference_dispatch():
    """S = 777 is no multiple of the reference's 512-key block: its
    dispatch combines a kernel part and a dense tail; the port masks."""
    q, k = _normal((16, 32), 4), _normal((777, 32), 5)
    v = _normal((777, 32), 6)
    want = jops.landmark_summary(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v))
    got = ops.landmark_summary(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_summary_batches_problems_and_upcasts_bf16():
    """A (P, n, D) batch equals P single problems; on the CPU bf16 inputs
    give what their f32 upcast gives (the plain version upcasts)."""
    q = torch.as_tensor(_normal((3, 40, 64), 7)).bfloat16()
    k = torch.as_tensor(_normal((3, 300, 64), 8)).bfloat16()
    v = torch.as_tensor(_normal((3, 300, 64), 9)).bfloat16()
    got = ops.landmark_summary(q, k, v, 0.2)
    assert got.dtype == torch.float32 and got.shape == (3, 40, 64)
    for p in range(3):
        want = ref.landmark_summary_ref(q[p].float(), k[p].float(),
                                        v[p].float(), 0.2)
        assert torch.equal(got[p], want)


def test_summary_wrapper_never_launches_on_the_cpu():
    ops.reset_launches()
    x = torch.zeros((4, 8, 32))
    ops.landmark_summary(x, x, x)
    ops.landmark_summary(x.bfloat16(), x.bfloat16(), x.bfloat16())
    assert lsum.landmark_summary.launches == 0
    assert ops.launch_counts()["landmark_summary"] == 0
    assert lsum.landmark_summary.route_launches == {"tensor_core": 0,
                                                    "f32_split": 0}
    lsum.bf16_terms.launches = 0
    lsum.bf16_terms(x, 3)
    assert lsum.bf16_terms.launches == 0


def _bf16(shape, seed):
    """Normal samples rounded to bf16, as f32 numpy (exact in both)."""
    x = torch.as_tensor(_normal(shape, seed)).bfloat16()
    return x.float().numpy()


@pytest.mark.parametrize("n,s,d", [(64, 1024, 64), (128, 2048, 128),
                                   (32, 512, 256), (16, 777, 32),
                                   (48, 777, 128), (24, 100, 64),
                                   (8, 60, 256), (20, 50, 32)])
def test_split_arithmetic_matches_reference(n, s, d):
    """The tensor-core kernel's arithmetic on bf16 inputs — bf16 q·k
    products summed in f32, P as bf16(p) + bf16(p − bf16(p)), z from the
    f32 p, key tiles of the kernel's width (128 keys for D ≤ 64, 64 above)
    — against the reference's dispatch (its Pallas kernel in interpret mode
    where S is a multiple of 512, with its ragged combine otherwise) and
    against the dense plain version, at every head dim, a ragged S and an
    S shorter than one tile."""
    q, k, v = _bf16((n, d), 50), _bf16((s, d), 51), _bf16((s, d), 52)
    scale = 1.0 / np.sqrt(d)
    want = np.asarray(jops.landmark_summary(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v)))
    tq, tk, tv = (torch.as_tensor(x).bfloat16() for x in (q, k, v))
    got = ref.landmark_summary_split_ref(tq, tk, tv, scale,
                                         block=128 if d <= 64 else 64)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    dense = ref.landmark_summary_ref(tq, tk, tv, scale)
    torch.testing.assert_close(got, dense, rtol=RTOL, atol=ATOL)


def test_single_bf16_term_of_p_breaks_the_bound():
    """Why the kernel splits P: at (n, S, D) = (256, 4096, 64), p rounded to
    one bf16 term before PV misses rtol=1e-4 / atol=1e-5 against the plain
    version (max |err| ~1.6e-4); the two-term split meets it (~3e-7)."""
    q, k, v = (torch.as_tensor(_bf16(shape, 60 + i)).bfloat16()
               for i, shape in enumerate([(256, 64), (4096, 64), (4096, 64)]))
    want = ref.landmark_summary_ref(q, k, v, 0.125)
    one = ref.landmark_summary_split_ref(q, k, v, 0.125, split=False)
    two = ref.landmark_summary_split_ref(q, k, v, 0.125)
    assert not torch.allclose(one, want, rtol=RTOL, atol=ATOL)
    assert float((one - want).abs().max()) > 10 * ATOL
    torch.testing.assert_close(two, want, rtol=RTOL, atol=ATOL)
    assert float((two - want).abs().max()) < 0.1 * ATOL


# the f32 route's key tile per head dim (csrc/landmark_summary.cu Tiles)
F32_BLOCK = {32: 128, 64: 128, 128: 32, 256: 32}


@pytest.mark.parametrize("n,s,d", [(64, 1024, 64), (128, 2048, 128),
                                   (32, 512, 256), (16, 777, 32),
                                   (48, 777, 128), (24, 100, 64),
                                   (8, 20, 256), (20, 50, 32),
                                   (1536, 4096, 64)])
def test_f32_split_arithmetic_matches_reference(n, s, d):
    """The f32 route's arithmetic on f32 inputs — q and k as three bf16
    terms and v as two, six q̃Kᵀ products (small ones first), PV as
    p_hi v0 + p_lo v0 + p_hi v1, key tiles of the kernel's width — against
    the reference's dispatch (its Pallas kernel in interpret mode where S
    is a multiple of 512, with its ragged combine otherwise) and against
    the dense plain version, at every head dim, a ragged S, an S shorter
    than one tile and the SmolLM-360M landmark problem."""
    q, k, v = _normal((n, d), 70), _normal((s, d), 71), _normal((s, d), 72)
    want = np.asarray(jops.landmark_summary(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v)))
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    got = ref.landmark_summary_f32_split_ref(tq, tk, tv, 1.0 / np.sqrt(d),
                                             block=F32_BLOCK[d])
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    dense = ref.landmark_summary_ref(tq, tk, tv, 1.0 / np.sqrt(d))
    torch.testing.assert_close(got, dense, rtol=RTOL, atol=ATOL)


def test_two_bf16_terms_of_q_and_k_break_the_bound():
    """Why f32 q and k take three terms: with q and k scaled ×4 (scores 16×
    unit scale) at (n, S, D) = (256, 4096, 64), against an f64 oracle,
    three terms stay within 2× of the plain f32 version's own error (~0.9×)
    while two exceed 5× of it (~11×)."""
    q, k = (torch.as_tensor(_normal(shape, 80 + i)) * 4
            for i, shape in enumerate([(256, 64), (4096, 64)]))
    v = torch.as_tensor(_normal((4096, 64), 82))
    oracle = torch.softmax(q.double() @ k.double().T * 0.125, -1) @ v.double()

    def err(x):
        return float((x.double() - oracle).abs().max())

    plain = err(ref.landmark_summary_ref(q, k, v, 0.125))
    three = err(ref.landmark_summary_f32_split_ref(q, k, v, 0.125))
    two = err(ref.landmark_summary_f32_split_ref(q, k, v, 0.125, qk_terms=2))
    assert three < 2 * plain, (three, plain)
    assert two > 5 * plain, (two, plain)


def test_three_bf16_terms_hold_an_f32_exactly():
    """The split pass's plain version: x0 + x1 + x2 == x for normal f32
    values over 2^±100 (and zeros); each term is bf16(what is left); the
    wrapper takes it for CPU tensors."""
    rng = np.random.default_rng(90)
    x = torch.as_tensor((rng.normal(size=4000) * np.exp2(
        rng.integers(-100, 101, 4000))).astype(np.float32))
    x[::9] = 0.0
    t = lsum.bf16_terms(x, 3)
    assert t.dtype == torch.bfloat16 and t.shape == (3, 4000)
    assert torch.equal(t.double().sum(0), x.double())
    assert torch.equal(t[0], x.bfloat16())
    assert torch.equal(t[1], (x - t[0].float()).bfloat16())
    assert torch.equal(ref.bf16_terms(x, 2), t[:2])


@pytest.mark.parametrize("n_landmarks", [4, 8, 16])
def test_landmark_attention_gqa_matches_reference_f32(n_landmarks):
    """G = 3 (6 query heads over 2 kv heads), S = 64, D = 32, f32."""
    b, s, h, hkv, d = 2, 64, 6, 2, 32
    q = _normal((b, s, h, d), 10) * 0.5
    k = _normal((b, s, hkv, d), 11) * 0.5
    v = _normal((b, s, hkv, d), 12)
    want = jlayers.landmark_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), n_landmarks=n_landmarks)
    got = layers.landmark_attention(torch.as_tensor(q), torch.as_tensor(k),
                                    torch.as_tensor(v),
                                    n_landmarks=n_landmarks)
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=2e-5)


def test_landmark_attention_routes_bv_through_summary_fn():
    """B̃V goes through ``summary_fn`` once per call with the stacked
    (B·Hkv, G·n, D) landmark queries against (B·Hkv, S, D) keys/values."""
    b, s, h, hkv, d, n = 2, 32, 6, 2, 32, 8
    q = torch.as_tensor(_normal((b, s, h, d), 13))
    k = torch.as_tensor(_normal((b, s, hkv, d), 14))
    v = torch.as_tensor(_normal((b, s, hkv, d), 15))
    shapes = []

    def spy(qq, kk, vv, scale):
        shapes.append((tuple(qq.shape), tuple(kk.shape), tuple(vv.shape)))
        return ref.landmark_summary_ref(qq, kk, vv, scale)

    a = layers.landmark_attention(q, k, v, n_landmarks=n, summary_fn=spy)
    assert shapes == [((b * hkv, 3 * n, d), (b * hkv, s, d), (b * hkv, s, d))]
    assert torch.equal(a, layers.landmark_attention(q, k, v, n_landmarks=n))


def test_landmark_decode_state_matches_reference_f32():
    """``landmark_state_init`` → three ``landmark_state_append`` of one,
    two and one tokens → ``landmark_decode``, G = 3, f32: the running
    (m, z, s) and the decoded output."""
    b, n, hq, hkv, d = 2, 8, 6, 2, 32
    scale = 1.0 / np.sqrt(d)
    k_lm, q_lm = _normal((b, n, hkv, d), 16), _normal((b, n, hq, d), 17)
    js = jlayers.landmark_state_init(jnp.asarray(k_lm), jnp.asarray(q_lm))
    ts = layers.landmark_state_init(torch.as_tensor(k_lm),
                                    torch.as_tensor(q_lm))
    assert torch.isinf(ts.m).all() and not ts.z.any() and not ts.s.any()
    for i, t in enumerate((1, 2, 1)):
        k_new = _normal((b, t, hkv, d), 20 + i)
        v_new = _normal((b, t, hkv, d), 30 + i)
        js = jlayers.landmark_state_append(js, jnp.asarray(k_new),
                                           jnp.asarray(v_new), scale)
        ts = layers.landmark_state_append(ts, torch.as_tensor(k_new),
                                          torch.as_tensor(v_new), scale)
    for key in ("m", "z", "s"):
        np.testing.assert_allclose(getattr(ts, key).numpy(),
                                   np.asarray(getattr(js, key)), rtol=RTOL,
                                   atol=ATOL)
    q = _normal((b, 1, hq, d), 40)
    want = jlayers.landmark_decode(js, jnp.asarray(q), scale)
    got = layers.landmark_decode(ts, torch.as_tensor(q), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=2e-5)
