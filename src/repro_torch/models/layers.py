"""Transformer building blocks: RMSNorm, RoPE, grouped-query attention
(chunked flash recurrence for prefill, cache decode), SwiGLU/GeGLU MLPs,
mixture-of-experts FFNs (GShard dense dispatch and sort-based ragged
dispatch), and landmark (Nyström) attention with its O(n) decode state.

Layouts are the reference's: activations (B, S, H, D), grouped scores
(B, Hkv, G, Sq, Skv). bf16 rounds where the reference's bf16 products
round: scores leave ``_gqa_scores`` as bf16 before the f32 upcast, and
probabilities are cast to the values' dtype before each PV product. The
B̃V term of landmark attention goes through ``kernels.ops.landmark_summary``
(the CUDA kernel on the card), which does not round in between.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.topk import canonical_topk
from ..distributed.sharding import constrain, replicated_like
from ..kernels import ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(dt)


# --------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D) — rotate pairs (d, d+D/2). positions: (B, S) int.
    On a mesh the angles are replicated beside the DTensor ``x``."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(d, theta), device=x.device)
    ang = positions[..., None].float() * freqs  # (B, S, D/2)
    cos = replicated_like(torch.cos(ang)[:, :, None, :], x)
    sin = replicated_like(torch.sin(ang)[:, :, None, :], x)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------- attention (full)
def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float
                ) -> torch.Tensor:
    """q: (B,Sq,Hkv,G,D), k: (B,Skv,Hkv,D) -> (B,Hkv,G,Sq,Skv) f32; the
    product rounds to the inputs' dtype before the upcast."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q, k).float() * scale


def _flash_scan(qg, kc, vc, scale, causal, q_lo, kv_chunk, skv):
    """The flash recurrence for one q block over a list of kv chunks.
    qg: (B, Sq, Hkv, G, D); kc/vc: chunks of (B, Ckv, Hkv, D)."""
    b, sq, hkv, g, d = qg.shape
    dev = qg.device
    q_pos = q_lo + torch.arange(sq, device=dev)
    m = torch.full((b, hkv, g, sq), float("-inf"), device=dev)
    l = torch.zeros((b, hkv, g, sq), device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), device=dev)
    for c_idx, (kb, vb) in enumerate(zip(kc, vc)):
        s = _gqa_scores(qg, kb, scale)  # (B,Hkv,G,Sq,Ckv)
        kv_pos = c_idx * kv_chunk + torch.arange(kv_chunk, device=dev)
        valid = (kv_pos < skv)[None, :].expand(sq, kv_chunk)
        if causal:
            valid = valid & (kv_pos[None, :] <= q_pos[:, None])
        s = s.masked_fill(~valid, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))  # fully-masked rows
        p = torch.where(valid, torch.exp(s - m_safe[..., None]),
                        torch.zeros_like(s))
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                            torch.zeros_like(m))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(vb.dtype), vb).float()
        m = m_new
    return acc / torch.clamp_min(l, 1e-30)[..., None]  # (B,Hkv,G,Sq,D)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, D)
    causal: bool = True,
    kv_chunk: int = 1024,
    q_chunk: int = 4096,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Memory-efficient attention: the FlashAttention recurrence in plain
    torch ops. Scores never exceed (B, H, q_chunk, kv_chunk); a causal q
    block scans only the kv chunks at or below its diagonal."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    n_kv = -(-skv // kv_chunk)
    pad = n_kv * kv_chunk - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    kc = k.split(kv_chunk, dim=1)
    vc = v.split(kv_chunk, dim=1)
    q_chunk = min(q_chunk, sq)
    assert sq % q_chunk == 0, f"Sq {sq} % q_chunk {q_chunk} != 0"
    outs = []
    for qi in range(sq // q_chunk):
        q_lo = qi * q_chunk
        qg = q[:, qi * q_chunk:(qi + 1) * q_chunk].reshape(b, q_chunk, hkv,
                                                           g, d)
        hi = min(n_kv, -(-(q_lo + q_chunk) // kv_chunk)) if causal else n_kv
        o = _flash_scan(qg, kc[:hi], vc[:hi], scale, causal, q_lo, kv_chunk,
                        skv)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, hq, d))
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, 1, Hq, D)
    k_cache: torch.Tensor,  # (B, S, Hkv, D)
    v_cache: torch.Tensor,
    length: torch.Tensor,  # () or (B,) valid cache length
    scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token attention over the first ``length`` cache positions."""
    b, _, hq, d = q.shape
    skv, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    qg = q.reshape(b, 1, hkv, g, d)
    s = _gqa_scores(qg, k_cache, scale)[:, :, :, 0, :]  # (B,Hkv,G,Skv)
    pos = torch.arange(skv, device=q.device)
    mask = pos[None, :] < torch.as_tensor(length, device=q.device).reshape(
        -1, 1)  # (B|1, Skv)
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, hq, d).to(q.dtype)


# ------------------------------------------- landmark (Nyström) attention
def _newton_schulz_pinv(a: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Moore-Penrose pseudo-inverse via Newton-Schulz (Nyströmformer §3.2)."""
    abs_a = a.abs()
    z = a.transpose(-1, -2) / (abs_a.sum(-1).amax(-1)
                               * abs_a.sum(-2).amax(-1))[..., None, None]
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    for _ in range(iters):
        az = a @ z
        z = 0.25 * z @ (13.0 * eye - az @ (15.0 * eye - az @ (7.0 * eye - az)))
    return z


SummaryFn = Callable[..., torch.Tensor]


def landmark_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    n_landmarks: int = 64,
    scale: Optional[float] = None,
    summary_fn: Optional[SummaryFn] = None,
) -> torch.Tensor:
    """Landmark (Nyström) attention, bidirectional:
    softmax(QKᵀ)V ≈ F̃ · pinv(Ã) · (B̃V) at O(S·n) instead of O(S²), with
    segment means of q/k as the n landmarks.

    B̃V = softmax(Q̃Kᵀ)V runs through ``summary_fn`` (default
    ``ops.landmark_summary``: the CUDA kernel for CUDA tensors, one launch
    serving every (batch, kv-head)) and is cast to ``v.dtype``, as the
    reference's bf16 product is.
    """
    summary_fn = summary_fn or ops.landmark_summary
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    m = n_landmarks
    assert s % m == 0, f"seq {s} must be divisible by n_landmarks {m}"
    # landmark = segment means of q/k (mean accumulated in f32)
    q_lm = q.float().reshape(b, m, s // m, h, d).mean(2).to(q.dtype)
    k_lm = k.float().reshape(b, m, s // m, hkv, d).mean(2).to(k.dtype)

    qg = q.reshape(b, s, hkv, g, d)
    qlg = q_lm.reshape(b, m, hkv, g, d)

    f = torch.softmax(_gqa_scores(qg, k_lm, scale), dim=-1)  # (B,Hkv,G,S,m)
    a = torch.softmax(_gqa_scores(qlg, k_lm, scale), dim=-1)  # (B,Hkv,G,m,m)
    # B̃V: per (batch, kv-head) the G·m landmark queries against (S, D)
    ql = qlg.permute(0, 2, 3, 1, 4).reshape(b * hkv, g * m, d).contiguous()
    kk = k.permute(0, 2, 1, 3).reshape(b * hkv, s, d).contiguous()
    vv = v.permute(0, 2, 1, 3).reshape(b * hkv, s, d).contiguous()
    bv = summary_fn(ql, kk, vv, scale).reshape(b, hkv, g, m, d).to(v.dtype)
    c = _newton_schulz_pinv(a).to(v.dtype) @ bv  # (B,Hkv,G,m,D)
    out = f.to(v.dtype) @ c  # (B,Hkv,G,S,D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


# Landmark decode: O(n_landmarks) per token via cached landmark summaries.
@dataclasses.dataclass
class LandmarkKVState:
    """Per-layer landmark cache (replaces the (S, D) KV cache with O(n)
    state). m/z/s are flash-style accumulators of softmax(Q̃ Kᵀ)V over the
    stream, so appending a token and decoding are O(n·d)."""

    k_lm: torch.Tensor  # (B, n, Hkv, D) landmark keys
    q_lm: torch.Tensor  # (B, n, Hq, D)  landmark queries
    m: torch.Tensor  # (B, Hkv, G, n) running max
    z: torch.Tensor  # (B, Hkv, G, n) running denom
    s: torch.Tensor  # (B, Hkv, G, n, D) running numerator


def landmark_state_init(k_lm: torch.Tensor, q_lm: torch.Tensor
                        ) -> LandmarkKVState:
    b, n, hkv, d = k_lm.shape
    g = q_lm.shape[2] // hkv
    dev = k_lm.device
    return LandmarkKVState(
        k_lm, q_lm,
        torch.full((b, hkv, g, n), float("-inf"), device=dev),
        torch.zeros((b, hkv, g, n), device=dev),
        torch.zeros((b, hkv, g, n, d), device=dev))


def landmark_state_append(state: LandmarkKVState, k_new: torch.Tensor,
                          v_new: torch.Tensor, scale: float
                          ) -> LandmarkKVState:
    """Fold one (or a chunk of) new KV pair(s) into the accumulators.
    k_new/v_new: (B, T, Hkv, D)."""
    b, n, hkv, d = state.k_lm.shape
    g = state.q_lm.shape[2] // hkv
    qlg = state.q_lm.reshape(b, n, hkv, g, d)
    logits = _gqa_scores(qlg, k_new, scale)  # (B,Hkv,G,n,T)
    m_new = torch.maximum(state.m, logits.amax(-1))
    alpha = torch.where(torch.isfinite(state.m), torch.exp(state.m - m_new),
                        torch.zeros_like(m_new))
    p = torch.exp(logits - m_new[..., None])
    z = state.z * alpha + p.sum(-1)
    s = state.s * alpha[..., None] + torch.einsum(
        "bhgnt,bthd->bhgnd", p.to(v_new.dtype), v_new)
    return LandmarkKVState(state.k_lm, state.q_lm, m_new, z, s)


def landmark_decode(state: LandmarkKVState, q: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, 1, Hq, D) -> (B, 1, Hq, D), cost O(n·d) per head."""
    b, n, hkv, d = state.k_lm.shape
    hq = q.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / np.sqrt(d)
    qg = q.reshape(b, 1, hkv, g, d)
    f = torch.softmax(_gqa_scores(qg, state.k_lm, scale), dim=-1)
    qlg = state.q_lm.reshape(b, n, hkv, g, d)
    a = torch.softmax(_gqa_scores(qlg, state.k_lm, scale), dim=-1)
    c = _newton_schulz_pinv(a) @ (state.s / torch.clamp_min(
        state.z, 1e-30)[..., None])  # (B,Hkv,G,n,D)
    out = f.to(c.dtype) @ c  # (B,Hkv,G,1,D)
    return out.reshape(b, 1, hq, d).to(q.dtype)


# ---------------------------------------------------------------------- MLP
def glu_mlp(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
            w2: torch.Tensor, act: str = "silu", rules=None) -> torch.Tensor:
    """SwiGLU/GeGLU: down(act(x@w1) * (x@w3)); gelu is the tanh form. On a
    mesh the hidden is pinned to the tensor-parallel axis (column then
    row parallel), as the reference's."""
    a = constrain(x @ w1, ("batch", "null", "tp"), rules)
    b = constrain(x @ w3, ("batch", "null", "tp"), rules)
    return (_act(a, act) * b) @ w2


def _act(a: torch.Tensor, act: str) -> torch.Tensor:
    return F.silu(a) if act == "silu" else F.gelu(a, approximate="tanh")


# ---------------------------------------------------------------------- MoE
def _router(xt: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """xt (T, D) -> (probs (T, E) f32, gates (T, K) f32 summing to 1,
    expert ids (T, K) int64). The product runs in f32, and the top-k is
    canonical: ties go to the lowest expert id, as ``lax.top_k``'s."""
    logits = xt.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = canonical_topk(probs, top_k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return probs, gates, idx


def route_flips(idx: torch.Tensor, other_probs: torch.Tensor,
                other_idx: torch.Tensor):
    """Where a router's expert ids ``idx`` (T, K) differ from another
    run's ``other_idx`` at the same (token, k): the (N, 2) positions, and
    at each the other run's relative gap between its probabilities of the
    two experts, |p[other id] − p[own id]| / p[other id] (``other_probs``
    (T, E)). Two runs whose router inputs differ in rounding may flip an
    expert only at a near-tie: a gap within the comparison's stated
    limit."""
    at = (idx != other_idx).nonzero()
    t, k = at.unbind(1)
    a = other_probs[t, other_idx[t, k]]
    return at, (a - other_probs[t, idx[t, k]]).abs() / a


def replayed_gates(probs: torch.Tensor, other_idx: torch.Tensor):
    """This run's router probabilities (T, E) at another run's experts
    (T, K), renormalized: the gates of a run routed as the other was."""
    gates = probs.gather(-1, other_idx)
    return gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)


@dataclasses.dataclass
class MoERouting:
    """GShard routing of (G, S) groups of tokens: per (token, k) its
    expert, its gate and its slot in that expert's queue; slots at or past
    ``capacity`` are dropped."""

    probs: torch.Tensor  # (G, S, E) f32 router softmax
    gates: torch.Tensor  # (G, S, K) f32, renormalized over K
    expert_idx: torch.Tensor  # (G, S, K) int64
    onehot: torch.Tensor  # (G, S, K, E) int32
    pos: torch.Tensor  # (G, S, K) slot in the expert's queue
    capacity: int

    @property
    def kept(self) -> torch.Tensor:
        return self.pos < self.capacity


def moe_route(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
              capacity_factor: float = 1.25, group_size: int = 512
              ) -> MoERouting:
    """Group x (B, S, D) along the sequence into ``max(1, S // group_size)``
    groups a row and route each group: top-k experts a token, capacity
    ``ceil(gs · top_k · capacity_factor / E)`` a group, and each (token, k)
    slotted by a running count over the group's (S·K) pairs in token-major
    order, so the first come keep their slots."""
    b, s, d = x.shape
    e = router_w.shape[1]
    n_sub = max(1, s // group_size)
    assert s % n_sub == 0, f"seq {s} not divisible into groups of {group_size}"
    n_groups, gs = b * n_sub, s // n_sub
    # the router's product on (T, D) rows, as moe_ffn_ragged's: both
    # functions then route a token alike on every device
    probs, gates, idx = _router(x.reshape(-1, d), router_w, top_k)
    cap = int(np.ceil(gs * top_k * capacity_factor / e))
    onehot = F.one_hot(idx, e).to(torch.int32).reshape(n_groups, gs, top_k, e)
    # the running count in int32 on (G, E, S·K): the scan runs along the
    # inner axis
    flat = onehot.reshape(n_groups, gs * top_k, e).transpose(1, 2).contiguous()
    pos = ((torch.cumsum(flat, dim=-1, dtype=torch.int32) - 1) * flat).sum(1)
    return MoERouting(probs.reshape(n_groups, gs, e),
                      gates.reshape(n_groups, gs, top_k),
                      idx.reshape(n_groups, gs, top_k), onehot,
                      pos.reshape(n_groups, gs, top_k), cap)


def moe_ffn(
    x: torch.Tensor,  # (B, S, D)
    router_w: torch.Tensor,  # (D, E)
    w1: torch.Tensor,  # (E, D, F)
    w3: torch.Tensor,
    w2: torch.Tensor,  # (E, F, D)
    top_k: int,
    capacity_factor: float = 1.25,
    group_size: int = 512,
    act: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style dense-dispatch MoE (top-k, capacity-dropped): per group
    a (S, E, C) one-hot dispatch and a gate-weighted combine, in x's dtype,
    route tokens into an (E, C, D) buffer; the experts run as one batched
    product over E. Returns (out (B, S, D), the GShard load-balance aux
    loss, f32)."""
    b, s, d = x.shape
    e = router_w.shape[1]
    r = moe_route(x, router_w, top_k, capacity_factor, group_size)
    cap, (n_groups, gs, _) = r.capacity, r.pos.shape
    xg = x.reshape(n_groups, gs, d)
    oh_e = r.onehot.to(x.dtype)  # (G, S, K, E)
    # overflow slots map to the extra column cap, which is cut off
    oh_c = F.one_hot(torch.where(r.kept, r.pos, cap), cap + 1).to(
        x.dtype)[..., :cap]  # (G, S, K, C)
    disp = torch.einsum("gske,gskc->gsec", oh_e, oh_c)
    combine = torch.einsum("gske,gskc->gsec",
                           oh_e * r.gates.to(x.dtype)[..., None], oh_c)
    expert_in = torch.einsum("gsec,gsd->egcd", disp, xg).reshape(
        e, n_groups * cap, d)
    h = _act(torch.bmm(expert_in, w1), act) * torch.bmm(expert_in, w3)
    expert_out = torch.bmm(h, w2).reshape(e, n_groups, cap, d)
    out = torch.einsum("gsec,egcd->gsd", combine, expert_out)

    density = r.onehot.float().sum(2).mean(1)  # (G, E) fraction routed
    aux = (density * r.probs.mean(1)).sum(-1).mean() * (e ** 2) / (top_k ** 2)
    return out.reshape(b, s, d), aux


def _ragged_dot(x: torch.Tensor, w: torch.Tensor, sizes: List[int]
                ) -> torch.Tensor:
    """``lax.ragged_dot``: rows of x in contiguous runs of ``sizes`` (one
    run an expert, in expert order), each run times its expert's w[e]."""
    runs = x.split(sizes)
    return torch.cat([run @ w[i] for i, run in enumerate(runs)])


def moe_ffn_ragged(
    x: torch.Tensor,  # (B, S, D)
    router_w: torch.Tensor,  # (D, E)
    w1: torch.Tensor,  # (E, D, F)
    w3: torch.Tensor,
    w2: torch.Tensor,  # (E, F, D)
    top_k: int,
    act: str = "silu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based ragged dispatch (MegaBlocks-style): no capacity drops and
    no one-hot dispatch products. The (token, k) pairs are sorted stably by
    expert, each expert's run goes through one product, and each token sums
    its K weighted rows in sorted order (no atomics: the bits do not depend
    on the device). Equals :func:`moe_ffn` at ample capacity. Returns
    (out (B, S, D) in x's dtype, aux f32)."""
    b, s, d = x.shape
    e = router_w.shape[1]
    t = b * s
    xt = x.reshape(t, d)
    probs, gate_vals, expert_idx = _router(xt, router_w, top_k)

    eid = expert_idx.reshape(-1)  # (T·K,)
    order = torch.argsort(eid, stable=True)
    tok = torch.div(order, top_k, rounding_mode="floor")
    gates = gate_vals.reshape(-1)[order]
    xs = xt[tok]  # (T·K, D) expert-sorted
    sizes = torch.bincount(eid, minlength=e).tolist()

    h = _act(_ragged_dot(xs, w1, sizes), act) * _ragged_dot(xs, w3, sizes)
    rows = _ragged_dot(h, w2, sizes)  # (T·K, D)
    rows = rows * gates[:, None].to(rows.dtype)
    # each token's K rows at their sorted positions, summed in that order
    # from zero, as the reference's segment sum scatters them
    at = torch.empty_like(order)
    at[order] = torch.arange(t * top_k, device=x.device)
    picked = rows[at.reshape(t, top_k).sort(-1).values]  # (T, K, D)
    out = torch.zeros_like(picked[:, 0])
    for j in range(top_k):
        out = out + picked[:, j]

    density = F.one_hot(expert_idx, e).float().sum(1).mean(0)
    aux = (density * probs.mean(0)).sum() * (e ** 2) / (top_k ** 2)
    return out.reshape(b, s, d).to(x.dtype), aux
