"""Gradients of the port against the JAX reference, on the CPU: kernel 7's
backward (its plain version, and the tiled arithmetic of the CUDA kernel)
and the LM's gradients on both attention backends.

Both packages get the same numpy inputs (the reference's ``init_lm``
makes the parameters; ``models.convert`` carries them). On CPU tensors
``ops.landmark_summary`` runs through ``LandmarkSummary`` with the plain
forward and ``ref.landmark_summary_bwd_ref`` as its backward, the
decomposition the backward kernel implements.

Tolerances:
- the plain backward against ``jax.vjp`` of the reference's oracle
  ``kernels/ref.py::landmark_summary_ref`` (f32): rtol 1e-5, atol 1e-6 —
  the same f32 products, summed in another order; the same through
  ``LandmarkSummary`` against ``torch.autograd`` of the plain forward, and
  for bf16 inputs within one bf16 step (rtol 2^-7: the f32 gradients,
  a last bit apart, may round to neighbouring bf16 values);
- the backward kernel's tiled arithmetic (``ref.landmark_summary_bwd_tiled_ref``:
  a running max and denominator in log2 units, then P recomputed from the
  log-sum-exp) against the plain backward: within 1e-5 of the largest
  |gradient| (seen: up to 6.5e-7);
- model gradients, f32: within 1e-4 of each leaf's largest |gradient|
  (the LM path's f32 bound): the same algorithm with softmaxes streamed in
  another order, through every layer, under remat on both sides. MoE
  routing of the forward must be equal (f32), as in
  ``tests/test_torch_lm.py``.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import registry as jregistry
from repro.data import synthetic as jsynthetic
from repro.distributed.sharding import DEFAULT_RULES
from repro.kernels import ref as jref
from repro.models import transformer as J

from repro_torch.configs import registry
from repro_torch.kernels import landmark_attention as lsum
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import lm_from_numpy

RTOL, ATOL = 1e-5, 1e-6
TILED_REL = 1e-5
GRAD_REL = 1e-4
B, S = 2, 32
ARCHS = ["smollm-360m", "gemma-7b", "llama3-405b", "deepseek-moe-16b",
         "dbrx-132b"]


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _inputs(p, n, s, d, seed):
    shape = (lambda rows: (p, rows, d)) if p else (lambda rows: (rows, d))
    return (_normal(shape(n), seed), _normal(shape(s), seed + 1),
            _normal(shape(s), seed + 2), _normal(shape(n), seed + 3))


# (P, n, S, D): one problem, ragged S (no multiple of any tile), P > 1,
# every head dim of the kernel
SHAPES = [(0, 16, 777, 32), (3, 70, 130, 64), (2, 33, 100, 128),
          (2, 20, 45, 256), (4, 1, 1, 64)]


@pytest.mark.parametrize("p,n,s,d", SHAPES)
def test_plain_backward_matches_jax_vjp(p, n, s, d):
    q, k, v, do = _inputs(p, n, s, d, seed=n + s)
    scale = 1.0 / np.sqrt(d)
    fn = lambda a, b, c: jref.landmark_summary_ref(a, b, c, scale)
    if p:
        fn = jax.vmap(fn)
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = ref.landmark_summary_bwd_ref(
        *(torch.as_tensor(x) for x in (q, k, v)),
        torch.as_tensor(np.asarray(out)), torch.as_tensor(do), scale)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("p,n,s,d", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_summary_function_gradients_match_autograd(p, n, s, d, dtype):
    """``ops.landmark_summary`` with inputs that require grad: the
    ``LandmarkSummary`` backward against ``torch.autograd`` through the
    plain forward, gradients in the inputs' dtype; no kernel launch on the
    CPU."""
    q, k, v, do = (torch.as_tensor(x) for x in _inputs(p, n, s, d, seed=7))
    ops.reset_launches()
    a = [t.to(dtype).requires_grad_() for t in (q, k, v)]
    b = [t.to(dtype).requires_grad_() for t in (q, k, v)]
    out = ops.landmark_summary(*a)
    assert out.grad_fn is not None and out.dtype == torch.float32
    out.backward(do)
    ref.landmark_summary_ref(*b, 1.0 / np.sqrt(d)).backward(do)
    # bf16 gradients: f32 values a last bit apart may round to
    # neighbouring bf16 values, one bf16 step (2^-7 relative) apart
    rtol = RTOL if dtype == torch.float32 else 2 ** -7
    for x, y in zip(a, b):
        assert x.grad.dtype == dtype
        torch.testing.assert_close(x.grad.float(), y.grad.float(),
                                   rtol=rtol, atol=ATOL)
    assert ops.launch_counts()["landmark_summary_bwd"] == 0
    with torch.no_grad():  # no graph without grad
        assert ops.landmark_summary(*a).grad_fn is None


@pytest.mark.parametrize("p,n,s,d", SHAPES)
def test_tiled_backward_arithmetic_matches_plain(p, n, s, d):
    q, k, v, do = (torch.as_tensor(x) for x in _inputs(p, n, s, d, seed=3))
    scale = 1.0 / np.sqrt(d)
    out = ref.landmark_summary_ref(q, k, v, scale)
    want = ref.landmark_summary_bwd_ref(q, k, v, out, do, scale)
    got = ref.landmark_summary_bwd_tiled_ref(q, k, v, out, do, scale,
                                             block=32 if d == 256 else 64)
    for g, w in zip(got, want):
        rel = float((g - w).abs().max() / w.abs().max())
        assert rel < TILED_REL, rel


def test_backward_wrapper_shapes_and_counts_on_cpu():
    """2-D and batched forms give the same gradients; the CPU never
    launches."""
    q, k, v, do = (torch.as_tensor(x) for x in _inputs(2, 9, 40, 32, 1))
    out = ref.landmark_summary_ref(q, k, v, 0.3)
    ops.reset_launches()
    batched = lsum.landmark_summary_bwd(q, k, v, out, do, 0.3)
    single = lsum.landmark_summary_bwd(q[1], k[1], v[1], out[1], do[1], 0.3)
    for a, b in zip(batched, single):
        torch.testing.assert_close(a[1], b)
    assert lsum.landmark_summary_bwd.launches == 0


# ------------------------------------------------------------ model grads
def _config(name):
    jc = dataclasses.replace(jregistry.get(name).smoke_model, n_landmarks=8,
                             dtype=jnp.float32)
    tc = dataclasses.replace(registry.get(name).smoke_model, n_landmarks=8,
                             dtype=torch.float32)
    return jc, tc


def _tree_of(model, grads):
    """The port's per-block gradients in the reference's stacked tree."""
    out = {"layers": {}}
    for name, g in grads.items():
        g = g.detach().numpy()
        if name.startswith("layers."):
            _, i, key = name.split(".", 2)
            out["layers"].setdefault(key, {})[int(i)] = g
        else:
            out[name] = g
    out["layers"] = {key: np.stack([rows[i] for i in sorted(rows)])
                     for key, rows in out["layers"].items()}
    return out


def _jax_routing(jc, params, tokens):
    """The reference's expert ids per MoE call of one forward (in order)."""
    calls = []

    def wrap(moe_ffn):
        def wrapped(x, router_w, *args, top_k, group_size=512, **kw):
            b, s, d = x.shape
            n_sub = max(1, s // group_size)
            probs = jax.nn.softmax(jnp.einsum(
                "gsd,de->gse", x.reshape(b * n_sub, s // n_sub, d).astype(
                    jnp.float32), router_w.astype(jnp.float32)), axis=-1)
            jax.debug.callback(lambda i: calls.append(np.asarray(i)),
                               jax.lax.top_k(probs, top_k)[1])
            return moe_ffn(x, router_w, *args, top_k=top_k,
                           group_size=group_size, **kw)
        return wrapped

    with mock.patch.object(J, "moe_ffn", wrap(J.moe_ffn)):
        jax.jit(lambda p, t: J.lm_forward(p, t, jc, DEFAULT_RULES)[0])(
            params, tokens).block_until_ready()
        jax.effects_barrier()
    return calls


@pytest.mark.parametrize("name", ARCHS)
def test_model_gradients_match_reference(name):
    """``jax.grad`` of the reference's ``lm_loss`` against the port's
    autograd (remat on both sides), f32, with backends full and landmark
    (kernel 7's B̃V through ``LandmarkSummary``), every parameter leaf."""
    jc, tc = _config(name)
    params = J.init_lm(jax.random.PRNGKey(0), jc)
    batch = {k: jnp.asarray(v) for k, v in
             jsynthetic.lm_batch(0, 0, B, S, jc.vocab).items()}
    cfgs = {b: dataclasses.replace(jc, attn_backend=b)
            for b in ("full", "landmark")}
    want = jax.jit(lambda p, bt: {
        b: jax.value_and_grad(lambda q: J.lm_loss(q, bt, c, DEFAULT_RULES))(p)
        for b, c in cfgs.items()})(params, batch)
    model = lm_from_numpy(jax.tree.map(np.asarray, params), tc, "cpu")
    tbatch = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
    if tc.moe is not None:  # the forward's routing, as the reference's
        ours = []
        router = L._router

        def logged(*args):
            out = router(*args)
            ours.append(out[2].numpy())
            return out

        with torch.no_grad(), mock.patch.object(L, "_router", logged):
            T.lm_forward(model, tbatch["tokens"])
        theirs = _jax_routing(jc, params, batch["tokens"])
        assert len(ours) == len(theirs) == tc.n_layers
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.reshape(-1), b.reshape(-1))
    for backend in ("full", "landmark"):
        model.cfg = dataclasses.replace(tc, attn_backend=backend)
        names, ps = zip(*model.named_parameters())
        loss = T.lm_loss(model, tbatch)
        grads = dict(zip(names, torch.autograd.grad(loss, ps)))
        jloss, jgrads = want[backend]
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   rtol=GRAD_REL)
        got = _tree_of(model, grads)
        ref_tree = jax.tree.map(np.asarray, jgrads)
        assert jax.tree.structure(got) == jax.tree.structure(ref_tree)
        for path, g in jax.tree_util.tree_leaves_with_path(got):
            w = dict(jax.tree_util.tree_leaves_with_path(ref_tree))[path]
            scale = np.abs(w).max()
            err = np.abs(g - w).max()
            assert err <= GRAD_REL * scale, (backend, path, err, scale)
