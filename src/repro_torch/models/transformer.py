"""Decoder-only LM: GQA, RoPE, SwiGLU/GeGLU, GShard-style MoE with shared
experts (DeepSeekMoE, DBRX), tied or untied vocab, chunked flash
attention, and the landmark attention backend.

The parameters live in an :class:`LM` ``nn.Module`` (a ``ModuleList`` of
:class:`Block`\\ s) under the reference's names and layouts: weights are
(in, out) and applied as ``x @ w``, norm scales are stored as ``scale`` of
``x · (1 + scale)``. The functions below mirror the reference's
``lm_forward`` / ``lm_prefill`` / ``lm_decode_step`` /
``lm_landmark_decode_step`` on one device. ``lm_forward`` and ``lm_loss``
are differentiable on both attention backends (the landmark kernel's
backward is ``kernels.landmark_attention.LandmarkSummary``): with grad
enabled each block is recomputed in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does;
serve under ``torch.inference_mode()``. Decode steps update their cache's
tensors in place and return it with ``length`` + 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import (LandmarkKVState, apply_rope, decode_attention,
                     flash_attention, glu_mlp, landmark_attention,
                     landmark_decode, landmark_state_append, moe_ffn,
                     rms_norm)

INV_127 = float(np.float32(1.0 / 127.0))  # the f32 reciprocal of 127


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    group_size: int = 512


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """The reference's ``LMConfig`` fields that change numbers or memory
    (sharding, scan-unroll and one-hot-embedding switches have no
    single-device counterpart)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "silu"  # silu (llama/smollm) | gelu (gemma geglu)
    tied_embed: bool = False
    rope_theta: float = 10000.0
    embed_scale: bool = False  # gemma: x *= sqrt(d_model)
    moe: Optional[MoEConfig] = None
    dtype: torch.dtype = torch.bfloat16
    kv_chunk: int = 2048
    q_chunk: int = 1 << 30
    n_landmarks: int = 512  # landmark attention backend
    attn_backend: str = "full"  # full | landmark
    kv_quant: bool = False  # int8 KV cache + per-(token, head) scales

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        return self._param_count(self.moe.n_experts if self.moe else 0)

    def active_param_count(self) -> int:
        """Parameters a token touches: the router, its top_k routed experts
        and the shared ones in each MoE layer."""
        return self._param_count(self.moe.top_k if self.moe else 0)

    def _param_count(self, routed: int) -> int:
        """All parameters, with ``routed`` of an MoE layer's experts."""
        d, l = self.d_model, self.n_layers
        attn = d * self.q_dim * 2 + d * self.kv_dim * 2
        if self.moe:
            m = self.moe
            ffn = d * m.n_experts + 3 * d * m.d_ff_expert * (routed
                                                             + m.n_shared)
        else:
            ffn = 3 * d * self.d_ff
        embed = self.vocab * d * (1 if self.tied_embed else 2)
        return l * (attn + ffn + 2 * d) + embed + d


# --------------------------------------------------------------- parameters
def _layer_shapes(cfg: LMConfig) -> Dict[str, Tuple[int, ...]]:
    """One block's parameter shapes, in the reference's key order: the
    router (D, E), the routed experts (E, D, F) and (E, F, D), and the
    shared experts as one GLU of width n_shared · F, for an MoE FFN."""
    d = cfg.d_model
    out = {
        "attn_norm": (d,),
        "mlp_norm": (d,),
        "wq": (d, cfg.q_dim),
        "wk": (d, cfg.kv_dim),
        "wv": (d, cfg.kv_dim),
        "wo": (cfg.q_dim, d),
    }
    if cfg.moe:
        m = cfg.moe
        out |= {
            "router": (d, m.n_experts),
            "ew1": (m.n_experts, d, m.d_ff_expert),
            "ew3": (m.n_experts, d, m.d_ff_expert),
            "ew2": (m.n_experts, m.d_ff_expert, d),
        }
        if m.n_shared:
            f = m.n_shared * m.d_ff_expert
            out |= {"sw1": (d, f), "sw3": (d, f), "sw2": (f, d)}
    else:
        out |= {"w1": (d, cfg.d_ff), "w3": (d, cfg.d_ff), "w2": (cfg.d_ff, d)}
    return out


class Block(nn.Module):
    """One transformer block's parameters (applied by :func:`block`)."""

    def __init__(self, cfg: LMConfig, device="cuda"):
        super().__init__()
        for name, shape in _layer_shapes(cfg).items():
            self.register_parameter(name, nn.Parameter(torch.zeros(
                shape, dtype=cfg.dtype, device=device)))


class LM(nn.Module):
    """The LM's parameters: ``embed`` (V, D), ``final_norm`` (D,),
    ``layers`` (a ``ModuleList`` of :class:`Block`), ``unembed`` (D, V)
    when the vocab is untied. The functions below apply it."""

    def __init__(self, cfg: LMConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.dtype
        self.embed = nn.Parameter(torch.zeros((cfg.vocab, d), dtype=dt,
                                              device=device))
        self.final_norm = nn.Parameter(torch.zeros((d,), dtype=dt,
                                                   device=device))
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))
        if not cfg.tied_embed:
            self.unembed = nn.Parameter(torch.zeros((d, cfg.vocab), dtype=dt,
                                                    device=device))


def init_lm(cfg: LMConfig, generator: Optional[torch.Generator] = None,
            device="cuda") -> LM:
    """Random weights N(0, 1/fan_in) drawn from ``generator`` (on its own
    device, then moved) and cast to ``cfg.dtype``; norm scales zero. The
    draws cannot reproduce ``jax.random``: parity with the reference goes
    through ``models.convert``."""
    generator = generator or torch.Generator().manual_seed(0)
    model = LM(cfg, device)

    def fill(p: torch.Tensor, fan_in: int) -> None:
        w = torch.randn(p.shape, generator=generator,
                        device=generator.device) / np.sqrt(fan_in)
        p.data.copy_(w.to(device=p.device, dtype=p.dtype))

    with torch.no_grad():
        for name, shape in _layer_shapes(cfg).items():
            if "norm" in name:
                continue
            for blk in model.layers:
                fill(getattr(blk, name), shape[-2])
        fill(model.embed, cfg.d_model)
        if not cfg.tied_embed:
            fill(model.unembed, cfg.d_model)
    return model


# --------------------------------------------------------------- embeddings
def embed_tokens(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    x = model.embed[tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype)
    return x


def logits_from(model: LM, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32, rounded to the weights' dtype first as the
    reference's product is."""
    w = model.embed.T if model.cfg.tied_embed else model.unembed
    return (x @ w).float()


# ------------------------------------------------------------------- blocks
def _ffn(x: torch.Tensor, lp: Block, cfg: LMConfig):
    """Dense or MoE FFN (routed experts plus the shared ones); returns
    (out, aux_loss)."""
    if cfg.moe is None:
        return glu_mlp(x, lp.w1, lp.w3, lp.w2, cfg.act), 0.0
    m = cfg.moe
    out, aux = moe_ffn(x, lp.router, lp.ew1, lp.ew3, lp.ew2, top_k=m.top_k,
                       capacity_factor=m.capacity_factor,
                       group_size=m.group_size, act=cfg.act)
    if m.n_shared:
        out = out + glu_mlp(x, lp.sw1, lp.sw3, lp.sw2, cfg.act)
    return out, aux


def _attn_qkv(x: torch.Tensor, lp: Block, cfg: LMConfig,
              positions: torch.Tensor):
    b, s, _ = x.shape
    q = (x @ lp.wq).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (x @ lp.wk).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ lp.wv).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def block(x: torch.Tensor, lp: Block, cfg: LMConfig, positions: torch.Tensor):
    """One transformer block (train/prefill, causal). Returns (x, aux).
    The landmark backend (bidirectional) runs only when s > n_landmarks,
    as the reference's."""
    b, s, _ = x.shape
    h = rms_norm(x, lp.attn_norm)
    q, k, v = _attn_qkv(h, lp, cfg, positions)
    if cfg.attn_backend == "landmark" and s > cfg.n_landmarks:
        attn = landmark_attention(q, k, v, n_landmarks=cfg.n_landmarks)
    else:
        attn = flash_attention(q, k, v, causal=True,
                               kv_chunk=min(cfg.kv_chunk, s),
                               q_chunk=min(cfg.q_chunk, s))
    x = x + attn.reshape(b, s, cfg.q_dim) @ lp.wo
    f, aux = _ffn(rms_norm(x, lp.mlp_norm), lp, cfg)
    return x + f, aux


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


# -------------------------------------------------------------- full passes
def lm_forward(model: LM, tokens: torch.Tensor):
    """Causal forward; returns (logits f32, moe_aux). With grad enabled
    every block runs under ``torch.utils.checkpoint``."""
    cfg = model.cfg
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = embed_tokens(model, tokens)
    aux = 0.0
    remat = torch.is_grad_enabled()
    for lp in model.layers:
        if remat:  # keep only each block's input for the backward
            x, a = checkpoint(block, x, lp, cfg, positions,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = block(x, lp, cfg, positions)
        aux = aux + a
    x = rms_norm(x, model.final_norm)
    return logits_from(model, x), aux


def lm_loss(model: LM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token cross-entropy over labels >= 0 (+ 0.01 · aux)."""
    logits, aux = lm_forward(model, batch["tokens"])
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    ce = ((lse - label_logit) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return ce + 0.01 * aux


# ------------------------------------------------------------------ serving
def make_cache(cfg: LMConfig, batch: int, max_seq: int, device="cuda",
               dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Exact KV cache (L, B, max_seq, Hkv, D) with a ``length`` scalar;
    int8 plus per-(token, head) f32 scales under ``cfg.kv_quant``."""
    dtype = torch.int8 if cfg.kv_quant else (dtype or cfg.dtype)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.kv_quant:
        sshape = shape[:-1]
        cache["k_scale"] = torch.zeros(sshape, device=device)
        cache["v_scale"] = torch.zeros(sshape, device=device)
    return cache


def _kv_quantize(x: torch.Tensor):
    """x (B, T, H, D) → (int8, per-(token, head) scale). The scale is
    max|x| times the f32 reciprocal of 127, as the compiled reference
    computes it (XLA turns the division by a constant into that product)."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    scale = amax * torch.full_like(amax, INV_127) + 1e-9
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def lm_prefill(model: LM, tokens: torch.Tensor,
               max_seq: Optional[int] = None):
    """Run the prompt with causal flash attention (whatever
    ``attn_backend`` says, as the reference); returns (last-token logits
    (B, 1, V), cache)."""
    cfg = model.cfg
    b, s = tokens.shape
    max_seq = max_seq or s
    positions = _positions(b, s, tokens.device)
    x = embed_tokens(model, tokens)
    ks, vs = [], []
    for lp in model.layers:
        h = rms_norm(x, lp.attn_norm)
        q, k, v = _attn_qkv(h, lp, cfg, positions)
        attn = flash_attention(q, k, v, causal=True,
                               kv_chunk=min(cfg.kv_chunk, s),
                               q_chunk=min(cfg.q_chunk, s))
        x = x + attn.reshape(b, s, cfg.q_dim) @ lp.wo
        f, _ = _ffn(rms_norm(x, lp.mlp_norm), lp, cfg)
        x = x + f
        pad = (0, 0, 0, 0, 0, max_seq - s)
        ks.append(torch.nn.functional.pad(k, pad))
        vs.append(torch.nn.functional.pad(v, pad))
    x = rms_norm(x, model.final_norm)
    logits = logits_from(model, x[:, -1:, :])
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "length": torch.tensor(s, dtype=torch.int32,
                                    device=tokens.device)}
    return logits, cache


def lm_decode_step(model: LM, cache: Dict[str, torch.Tensor],
                   token: torch.Tensor):
    """One decode step. token: (B, 1) int. Returns (logits (B, 1, V), the
    cache updated in place with ``length`` + 1). Under ``cfg.kv_quant`` the
    cache holds int8 + per-(token, head) scales and is dequantized whole
    for attention, as the reference's."""
    cfg = model.cfg
    b = token.shape[0]
    pos = cache["length"]
    positions = pos.expand(b, 1)
    at = pos.reshape(1).long()
    x = embed_tokens(model, token)
    for i, lp in enumerate(model.layers):
        h = rms_norm(x, lp.attn_norm)
        q, k, v = _attn_qkv(h, lp, cfg, positions)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        if cfg.kv_quant:
            kq, ks_new = _kv_quantize(k)
            vq, vs_new = _kv_quantize(v)
            k_cache.index_copy_(1, at, kq)
            v_cache.index_copy_(1, at, vq)
            cache["k_scale"][i].index_copy_(1, at, ks_new)
            cache["v_scale"][i].index_copy_(1, at, vs_new)
            k_full = _kv_dequantize(k_cache, cache["k_scale"][i], cfg.dtype)
            v_full = _kv_dequantize(v_cache, cache["v_scale"][i], cfg.dtype)
        else:
            k_cache.index_copy_(1, at, k.to(k_cache.dtype))
            v_cache.index_copy_(1, at, v.to(v_cache.dtype))
            k_full, v_full = k_cache, v_cache
        attn = decode_attention(q, k_full, v_full, pos + 1)
        x = x + attn.reshape(b, 1, cfg.q_dim) @ lp.wo
        f, _ = _ffn(rms_norm(x, lp.mlp_norm), lp, cfg)
        x = x + f
    x = rms_norm(x, model.final_norm)
    cache["length"] = pos + 1
    return logits_from(model, x), cache


# -------------------------------------------------- landmark decode serving
def make_landmark_cache(cfg: LMConfig, batch: int, device="cuda"
                        ) -> Dict[str, torch.Tensor]:
    """O(n_landmarks) decode state per layer (stacked over layers)."""
    n, dh = cfg.n_landmarks, cfg.head_dim
    l, hkv, hq = cfg.n_layers, cfg.n_kv_heads, cfg.n_heads
    g = hq // hkv
    return {
        "k_lm": torch.zeros((l, batch, n, hkv, dh), dtype=cfg.dtype,
                            device=device),
        "q_lm": torch.zeros((l, batch, n, hq, dh), dtype=cfg.dtype,
                            device=device),
        "m": torch.full((l, batch, hkv, g, n), float("-inf"), device=device),
        "z": torch.zeros((l, batch, hkv, g, n), device=device),
        "s": torch.zeros((l, batch, hkv, g, n, dh), device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def lm_landmark_decode_step(model: LM, cache: Dict[str, torch.Tensor],
                            token: torch.Tensor):
    """Decode against the landmark summaries — O(n·d) per token per layer.
    Returns (logits (B, 1, V), the cache with m/z/s updated in place and
    ``length`` + 1)."""
    cfg = model.cfg
    b = token.shape[0]
    pos = cache["length"]
    positions = pos.expand(b, 1)
    x = embed_tokens(model, token)
    scale = 1.0 / np.sqrt(cfg.head_dim)
    for i, lp in enumerate(model.layers):
        st = LandmarkKVState(cache["k_lm"][i], cache["q_lm"][i],
                             cache["m"][i], cache["z"][i], cache["s"][i])
        h = rms_norm(x, lp.attn_norm)
        q, k, v = _attn_qkv(h, lp, cfg, positions)
        st = landmark_state_append(st, k, v, scale)
        attn = landmark_decode(st, q, scale)
        x = x + attn.reshape(b, 1, cfg.q_dim) @ lp.wo
        f, _ = _ffn(rms_norm(x, lp.mlp_norm), lp, cfg)
        x = x + f
        cache["m"][i], cache["z"][i], cache["s"][i] = st.m, st.z, st.s
    x = rms_norm(x, model.final_norm)
    cache["length"] = pos + 1
    return logits_from(model, x), cache
