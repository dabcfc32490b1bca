"""The port's MoE FFNs against the JAX reference, on the CPU.

``moe_ffn`` (GShard dense dispatch: top-k, capacity drops, one-hot dispatch
and combine) and ``moe_ffn_ragged`` (sort-based dispatch, no drops) run on
the same numpy-seeded inputs in both packages. The reference returns only
(out, aux), so its routing (expert ids, slots, the dropped set) comes from
``_reference_routing``, its routing steps line for line; the outputs then
tie that routing to the reference's own function.

Tolerances:
- f32: rtol = atol = 1e-5 on outputs and aux (the same arithmetic with
  sums in another order; the largest difference seen is 1.2e-6 at outputs
  of magnitude ~2);
- bf16: outputs within 1e-2 of the largest |output| (bf16 keeps 8 bits;
  the products round to bf16 at other points in XLA and torch; seen: one
  bf16 ulp, 0.0078 at magnitude ~2, 0.4%); expert ids, slots and the
  dropped set equal, since the router runs in f32 on the same bf16 inputs.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
from repro.models import layers as JL
from repro.models import transformer as J

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import tensor_from_numpy

F32_TOL = 1e-5
BF16_REL = 1e-2
B, S, D, E, FF, K = 2, 32, 16, 8, 24, 2


def _inputs(seed, b=B, s=S, d=D, e=E, f=FF):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, d)).astype(np.float32),
            rng.normal(size=(d, e)).astype(np.float32),
            (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32),
            (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32),
            (rng.normal(size=(e, f, d)) / np.sqrt(f)).astype(np.float32))


def _both(arrays, f32):
    jd = jnp.float32 if f32 else jnp.bfloat16
    td = torch.float32 if f32 else torch.bfloat16
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [tensor_from_numpy(a, td, "cpu") for a in arrays])


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, f32):
    got, want = _np(got), _np(want)
    if f32:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < BF16_REL, rel


def _reference_routing(x, router_w, top_k, capacity_factor, group_size):
    """The reference ``moe_ffn``'s routing steps (``repro.models.layers``):
    (expert ids, slots, kept) per (group, token, k)."""
    b, s, d = x.shape
    e = router_w.shape[1]
    n_sub = max(1, s // group_size)
    n_groups, gs = b * n_sub, s // n_sub
    xg = x.reshape(n_groups, gs, d)
    logits = jnp.einsum("gsd,de->gse", xg.astype(jnp.float32),
                        router_w.astype(jnp.float32))
    _, expert_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    cap = int(np.ceil(gs * top_k * capacity_factor / e))
    flat = jax.nn.one_hot(expert_idx, e, dtype=jnp.int32).reshape(
        n_groups, gs * top_k, e)
    pos = ((jnp.cumsum(flat, axis=1) - 1) * flat).sum(-1).reshape(
        n_groups, gs, top_k)
    return np.asarray(expert_idx), np.asarray(pos), np.asarray(pos < cap)


@pytest.fixture(params=[True, False], ids=["f32", "bf16"])
def f32(request):
    return request.param


# capacity 0.5 and 1.25 drop tokens, E / K * 2 = 8 drops none
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 8.0],
                         ids=["cap0.5", "cap1.25", "ample"])
@pytest.mark.parametrize("group_size", [S, S // 4], ids=["1group", "4groups"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_ffn_matches_reference(capacity_factor, group_size, act, f32):
    (jx, jr, *jw), (tx, tr, *tw) = _both(_inputs(0), f32)
    want, want_aux = JL.moe_ffn(jx, jr, *jw, top_k=K,
                                capacity_factor=capacity_factor,
                                group_size=group_size, act=act)
    got, aux = L.moe_ffn(tx, tr, *tw, top_k=K,
                         capacity_factor=capacity_factor,
                         group_size=group_size, act=act)
    assert got.shape == (B, S, D) and got.dtype == tx.dtype
    ids, pos, kept = _reference_routing(jx, jr, K, capacity_factor,
                                        group_size)
    r = L.moe_route(tx, tr, K, capacity_factor, group_size)
    np.testing.assert_array_equal(r.expert_idx.numpy(), ids)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.kept.numpy(), kept)
    assert kept.all() == (capacity_factor == 8.0)  # drops where expected
    _close(got, want, f32)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=F32_TOL)


def test_router_ties_go_to_the_lowest_expert_id():
    """Experts 1 and 2 have the same router column: every token ties them
    for its second expert, and both packages take expert 1 (``lax.top_k``
    breaks ties toward the lowest index; the port's canonical top-k too)."""
    x, router, *w = _inputs(1, e=4)
    x = np.abs(x)
    base = np.abs(router[:, 0])
    router = np.stack([2.0 * base, base, base, 0.1 * base], axis=1)
    (jx, jr, *jw), (tx, tr, *tw) = _both((x, router, *w), True)
    r = L.moe_route(tx, tr, K, 2.0, S)
    assert (r.probs[..., 1] == r.probs[..., 2]).all()
    assert (r.expert_idx[..., 1] == 1).all()
    ids, pos, _ = _reference_routing(jx, jr, K, 2.0, S)
    np.testing.assert_array_equal(r.expert_idx.numpy(), ids)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    want, _ = JL.moe_ffn(jx, jr, *jw, top_k=K, capacity_factor=2.0,
                         group_size=S)
    got, _ = L.moe_ffn(tx, tr, *tw, top_k=K, capacity_factor=2.0,
                       group_size=S)
    _close(got, want, True)


def test_route_flips_and_replayed_gates():
    """The tie rule's measure: at each (token, k) whose expert differs from
    the other run's, the other run's relative probability gap of the two
    experts; the replayed gates are this run's probabilities at the other
    run's experts, renormalized."""
    other_p = torch.tensor([[0.4, 0.3, 0.2, 0.1], [0.1, 0.2, 0.3, 0.4]])
    other_i = torch.tensor([[0, 1], [3, 2]])
    idx = torch.tensor([[0, 2], [2, 3]])
    at, gaps = L.route_flips(idx, other_p, other_i)
    assert at.tolist() == [[0, 1], [1, 0], [1, 1]]
    torch.testing.assert_close(gaps, torch.tensor([1 / 3, 0.25, 1 / 3]))
    at, gaps = L.route_flips(other_i, other_p, other_i)
    assert at.numel() == 0 and gaps.numel() == 0
    probs = torch.tensor([[0.5, 0.1, 0.3, 0.1], [0.25, 0.25, 0.25, 0.25]])
    torch.testing.assert_close(L.replayed_gates(probs, other_i),
                               torch.tensor([[5 / 6, 1 / 6], [0.5, 0.5]]))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_ffn_ragged_matches_reference_and_dense_dispatch(act, f32):
    """The ragged form against the reference's, and against the port's
    dense dispatch at a capacity where nothing drops (the reference's own
    claim): the same routing, outputs within the dtype's bound."""
    (jx, jr, *jw), (tx, tr, *tw) = _both(_inputs(2), f32)
    want, want_aux = JL.moe_ffn_ragged(jx, jr, *jw, top_k=K, act=act)
    got, aux = L.moe_ffn_ragged(tx, tr, *tw, top_k=K, act=act)
    assert got.shape == (B, S, D) and got.dtype == tx.dtype
    _close(got, want, f32)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=F32_TOL)
    dense, _ = L.moe_ffn(tx, tr, *tw, top_k=K, capacity_factor=E / K,
                         group_size=S, act=act)
    assert L.moe_route(tx, tr, K, E / K, S).kept.all()
    _close(got, dense, f32)


def test_moe_ffn_ragged_skips_empty_experts():
    """Experts that no token picks have an empty run (no rows), and the
    result still matches the reference."""
    x, router, *w = _inputs(3, e=6)
    router[:, 4:] = -50.0  # experts 4, 5: never in a token's top 2
    (jx, jr, *jw), (tx, tr, *tw) = _both((np.abs(x), router, *w), True)
    _, _, ids = L._router(tx.reshape(-1, D), tr, K)
    assert not (ids >= 4).any()
    want, _ = JL.moe_ffn_ragged(jx, jr, *jw, top_k=K)
    got, _ = L.moe_ffn_ragged(tx, tr, *tw, top_k=K)
    _close(got, want, True)


@pytest.mark.parametrize("n_shared", [0, 2])
def test_ffn_with_shared_experts_matches_reference(n_shared, f32):
    """``transformer._ffn``: the routed experts plus n_shared shared ones
    through one GLU of width n_shared · F."""
    moe = dict(n_experts=E, top_k=K, d_ff_expert=FF, n_shared=n_shared,
               group_size=S // 2)
    jc = J.LMConfig(name="moe", n_layers=1, d_model=D, n_heads=2,
                    n_kv_heads=2, head_dim=8, d_ff=0, vocab=64,
                    moe=J.MoEConfig(**moe),
                    dtype=jnp.float32 if f32 else jnp.bfloat16)
    tc = T.LMConfig(name="moe", n_layers=1, d_model=D, n_heads=2,
                    n_kv_heads=2, head_dim=8, d_ff=0, vocab=64,
                    moe=T.MoEConfig(**moe),
                    dtype=torch.float32 if f32 else torch.bfloat16)
    params = J.init_lm(jax.random.PRNGKey(4), jc)
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    blk = T.Block(tc, "cpu")
    assert [n for n, _ in blk.named_parameters()] == list(
        J._layer_shapes(jc))
    with torch.no_grad():
        for name, a in lp.items():
            getattr(blk, name).copy_(tensor_from_numpy(a, tc.dtype, "cpu"))
    (jx,), (tx,) = _both([_inputs(5)[0]], f32)
    want, want_aux = J._ffn(jx.astype(jc.dtype), lp, jc)
    with torch.no_grad():
        got, aux = T._ffn(tx, blk, tc)
    _close(got, want, f32)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=F32_TOL)


@given(st.integers(0, 2**31 - 1))
@settings(max_examples=10, deadline=None)
def test_moe_conserves_tokens_and_matches_dense_when_topk_equals_experts(
        seed):
    """top_k == n_experts with ample capacity ⇒ MoE == weighted sum of ALL
    experts (no token dropped); output must be finite and gate-normalized
    (``tests/test_properties.py``'s property, on the port)."""
    rng = np.random.default_rng(seed)
    b, s, d, e, f = 2, 16, 8, 4, 16
    x = torch.from_numpy(rng.normal(size=(b, s, d)).astype(np.float32))
    router = torch.from_numpy(rng.normal(size=(d, e)).astype(np.float32))
    w1, w3, w2 = (torch.from_numpy(
        rng.normal(size=shape).astype(np.float32) * 0.1)
        for shape in ((e, d, f), (e, d, f), (e, f, d)))
    out, _ = L.moe_ffn(x, router, w1, w3, w2, top_k=e,
                       capacity_factor=float(e), group_size=s)
    assert bool(torch.isfinite(out).all())
    gates = torch.softmax(torch.einsum("bsd,de->bse", x, router), -1)
    h = torch.nn.functional.silu(torch.einsum("bsd,edf->besf", x, w1)) * (
        torch.einsum("bsd,edf->besf", x, w3))
    ref = torch.einsum("bse,besd->bsd", gates,
                       torch.einsum("besf,efd->besd", h, w2))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_moe_route_asserts_groups_divide_the_sequence():
    x = torch.zeros((1, 25, D))
    with pytest.raises(AssertionError, match="not divisible"):
        L.moe_route(x, torch.zeros((D, E)), K, 1.25, 10)  # 2 groups of 12.5
    assert L.moe_route(x, torch.zeros((D, E)), K, 1.25, 5).pos.shape == (
        5, 5, K)


def test_moe_config_fields_and_defaults_match_reference():
    t = {f.name: f.default for f in dataclasses.fields(T.MoEConfig)}
    j = {f.name: f.default for f in dataclasses.fields(J.MoEConfig)}
    assert t == j
