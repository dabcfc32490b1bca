"""Transformer building blocks: RMSNorm, RoPE, grouped-query attention
(chunked flash recurrence for prefill, cache decode), SwiGLU/GeGLU MLPs,
and landmark (Nyström) attention with its O(n) decode state.

Layouts are the reference's: activations (B, S, H, D), grouped scores
(B, Hkv, G, Sq, Skv). bf16 rounds where the reference's bf16 products
round: scores leave ``_gqa_scores`` as bf16 before the f32 upcast, and
probabilities are cast to the values' dtype before each PV product. The
B̃V term of landmark attention goes through ``kernels.ops.landmark_summary``
(the CUDA kernel on the card), which does not round in between.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

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
    """x: (B, S, H, D) — rotate pairs (d, d+D/2). positions: (B, S) int."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(d, theta), device=x.device)
    ang = positions[..., None].float() * freqs  # (B, S, D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
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
            w2: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU/GeGLU: down(act(x@w1) * (x@w3)); gelu is the tanh form."""
    a = x @ w1
    b = x @ w3
    h = (F.silu(a) if act == "silu" else F.gelu(a, approximate="tanh")) * b
    return h @ w2
