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

**On a mesh.** :func:`lm_logical`, :func:`cache_logical` and
:func:`landmark_cache_logical` are the reference's logical-axis trees.
The port's blocks are not stacked, so block i's parameter
``layers.{i}.{name}`` takes the reference's tuple without its leading
``"layers"`` entry (:func:`param_logical`, the one mapping). With the
parameters and inputs as DTensors (``launch/steps.py`` places them) and
``rules`` given, the functions constrain activations at the reference's
sites (``distributed/sharding.py::constrain``) and DTensor issues the
collectives. Weights are gathered over ``fsdp`` before their product
(ZeRO-3), and the sequence is gathered around each block's products (the
sequence-split residual stays between them). Where DTensor has no rule
for an op the code redistributes explicitly: the embedding lookup,
attention (and the landmark kernel in it), the MoE FFN and the cache
writes run on each rank's batch block (``sharding.local_over``), with the
whole sequence of keys; attention's heads
stay split over ``model`` only when both the query and the kv heads
divide it (otherwise the split would cut a query group from its kv
head: SmolLM's 15 and 5 heads at a model axis of 4). The loss keeps the
logits vocab-sharded: the log-sum-exp reduces over the shards and the
label logit is a one-hot contraction, each rank building its own slice
of the one-hot, as the reference's loss avoids a gather over the vocab.
Without a mesh every function is what it was on one device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import (DTensor, constrain, local_over,
                                    mesh_size, mesh_size_of, replicated_like)
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
    """The reference's ``LMConfig`` fields that change numbers, memory or
    sharding (its scan-unroll and one-hot-embedding switches have no
    counterpart here)."""

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
    shard_heads: bool = True  # False when n_heads % tp != 0 (smollm)
    shard_kv: bool = True  # False when n_kv_heads % tp != 0 (llama, dbrx)
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


def _layer_logical(cfg: LMConfig) -> Dict[str, Tuple]:
    """The reference's logical axes of one stacked block parameter,
    leading ``"layers"`` included."""
    tp_q = "tp" if cfg.shard_heads else "null"
    tp_kv = "tp" if (cfg.shard_heads and cfg.shard_kv) else "null"
    out = {
        "attn_norm": ("layers", "null"),
        "mlp_norm": ("layers", "null"),
        "wq": ("layers", "fsdp", tp_q),
        "wk": ("layers", "fsdp", tp_kv),
        "wv": ("layers", "fsdp", tp_kv),
        "wo": ("layers", tp_q, "fsdp"),
    }
    if cfg.moe:
        out |= {
            "router": ("layers", "fsdp", "null"),
            "ew1": ("layers", "expert", "fsdp", "null"),
            "ew3": ("layers", "expert", "fsdp", "null"),
            "ew2": ("layers", "expert", "null", "fsdp"),
        }
        if cfg.moe.n_shared:
            out |= {"sw1": ("layers", "fsdp", "tp"),
                    "sw3": ("layers", "fsdp", "tp"),
                    "sw2": ("layers", "tp", "fsdp")}
    else:
        out |= {"w1": ("layers", "fsdp", "tp"), "w3": ("layers", "fsdp", "tp"),
                "w2": ("layers", "tp", "fsdp")}
    return out


def lm_logical(cfg: LMConfig) -> Dict:
    """The reference's logical-axis tree of the parameters (its stacked
    ``layers``)."""
    tree = {"embed": ("vocab", "fsdp"), "final_norm": ("null",),
            "layers": _layer_logical(cfg)}
    if not cfg.tied_embed:
        tree["unembed"] = ("fsdp", "vocab")
    return tree


def param_logical(cfg: LMConfig) -> Dict[str, Tuple]:
    """Logical axes by ``named_parameters()`` name: block i's
    ``layers.{i}.{name}`` takes the reference's stacked tuple without its
    leading ``"layers"``."""
    tree = lm_logical(cfg)
    out = {k: v for k, v in tree.items() if k != "layers"}
    for i in range(cfg.n_layers):
        for name, la in tree["layers"].items():
            out[f"layers.{i}.{name}"] = la[1:]
    return out


def _gathered(w: torch.Tensor, logical: Tuple, rules) -> torch.Tensor:
    """A weight for its product: on a mesh its ``fsdp`` axes gathered
    (ZeRO-3: the all-gather of the weight before use, and a
    reduce-scatter of its gradient after), its ``tp`` split kept."""
    return constrain(w, tuple("null" if a == "fsdp" else a
                              for a in logical), rules)


def _w(lp, name: str, cfg: LMConfig, rules) -> torch.Tensor:
    """Block parameter ``name`` for its product (:func:`_gathered`)."""
    w = getattr(lp, name)
    if rules is None:
        return w
    return _gathered(w, _layer_logical(cfg)[name][1:], rules)


def cache_logical(long_context: bool = False, kv_quant: bool = False
                  ) -> Dict:
    """The reference's logical axes of the exact KV cache (stacked over
    layers, as the port's is)."""
    seq = "kv_seq_all" if long_context else "kv_seq"
    out = {"k": ("layers", "batch", seq, "null", "null"),
           "v": ("layers", "batch", seq, "null", "null"),
           "length": ()}
    if kv_quant:
        out["k_scale"] = ("layers", "batch", seq, "null")
        out["v_scale"] = ("layers", "batch", seq, "null")
    return out


def landmark_cache_logical() -> Dict:
    """The reference's logical axes of the landmark decode state."""
    lay = ("layers", "batch", "null", "null", "null")
    return {"k_lm": lay, "q_lm": lay, "m": lay, "z": lay, "s": lay,
            "length": ()}


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
def embed_tokens(model: LM, tokens: torch.Tensor, rules=None
                 ) -> torch.Tensor:
    cfg = model.cfg
    # on a mesh the table is gathered whole and each rank looks up its
    # batch block (DTensor's rule for the lookup's backward, an
    # accumulating index_put, fails on torch 2.11); the table's gradient
    # is then a partial sum over the batch's ranks
    x = local_over(lambda e, t: e[t.long()], (model.embed, tokens),
                   (("null", "null"), ("batch", "null")),
                   ("batch", "null", "null"), rules, partial_grads=(0,))
    if cfg.embed_scale:
        x = x * replicated_like(
            torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.dtype,
                         device=x.device), x)
    # the lookup's gradient comes back whole over the sequence (its
    # backward flattens (B, S))
    return constrain(x, ("batch", "null", "null"), rules)


def logits_from(model: LM, x: torch.Tensor, rules=None) -> torch.Tensor:
    """Logits in f32, rounded to the weights' dtype first as the
    reference's product is; on a mesh kept vocab-sharded."""
    if model.cfg.tied_embed:
        w = (_gathered(model.embed, ("vocab", "fsdp"), rules)
             if rules is not None else model.embed).T
    else:
        w = (_gathered(model.unembed, ("fsdp", "vocab"), rules)
             if rules is not None else model.unembed)
    # the sequence gathered first: the product then splits the vocab with
    # no gather of the logits or, in the backward, of their gradient
    x = constrain(x, ("batch", "null", "null"), rules)
    return constrain((x @ w).float(), ("batch", "null", "vocab"), rules)


# ------------------------------------------------------------------- blocks
def _ffn(x: torch.Tensor, lp: Block, cfg: LMConfig, rules=None):
    """Dense or MoE FFN (routed experts plus the shared ones); returns
    (out, aux_loss). On a mesh the routed experts run on each rank's batch
    block with the experts' weights gathered."""
    if cfg.moe is None:
        return glu_mlp(x, _w(lp, "w1", cfg, rules), _w(lp, "w3", cfg, rules),
                       _w(lp, "w2", cfg, rules), cfg.act, rules), 0.0
    m = cfg.moe

    # the aux loss is a mean over groups: each rank's share of it is its
    # groups' mean over the ranks the batch is split on, summed over them
    # (a sum's gradient reaches every rank whole; a mean's would not be
    # divided back)
    share = 1.0 / mesh_size_of(x, ("batch",), rules)

    def routed(x, router, w1, w3, w2):
        out, aux = moe_ffn(x, router, w1, w3, w2, top_k=m.top_k,
                           capacity_factor=m.capacity_factor,
                           group_size=m.group_size, act=cfg.act)
        return out, aux * share

    tok = ("batch", "null", "null")
    out, aux = local_over(
        routed, (x, lp.router, lp.ew1, lp.ew3, lp.ew2),
        (tok, ("null",) * 2, ("null",) * 3, ("null",) * 3, ("null",) * 3),
        [tok, "sum"], rules, partial_grads=(1, 2, 3, 4))
    if m.n_shared:
        out = out + glu_mlp(x, _w(lp, "sw1", cfg, rules),
                            _w(lp, "sw3", cfg, rules),
                            _w(lp, "sw2", cfg, rules), cfg.act, rules)
    return out, aux


def _heads(x: torch.Tensor, n: int, d: int) -> torch.Tensor:
    """(B, S, n·d) -> (B, S, n, d). A DTensor whose last dim is split over
    a number of ranks that does not divide ``n`` is gathered on that dim
    first: the split would not fall on whole heads."""
    if isinstance(x, DTensor):
        last = x.ndim - 1
        split = [getattr(p, "dim", None) == last for p in x.placements]
        ranks = math.prod(sz for sz, hit in zip(x.device_mesh.mesh.shape,
                                                split) if hit)
        if n % ranks:
            from torch.distributed.tensor import Replicate
            x = x.redistribute(x.device_mesh, [
                Replicate() if hit else p
                for p, hit in zip(x.placements, split)])
    b, s = x.shape[:2]
    return x.reshape(b, s, n, d)


def _attn_qkv(x: torch.Tensor, lp: Block, cfg: LMConfig,
              positions: torch.Tensor, rules=None):
    q = _heads(x @ _w(lp, "wq", cfg, rules), cfg.n_heads, cfg.head_dim)
    k = _heads(x @ _w(lp, "wk", cfg, rules), cfg.n_kv_heads, cfg.head_dim)
    v = _heads(x @ _w(lp, "wv", cfg, rules), cfg.n_kv_heads, cfg.head_dim)
    if rules is not None:
        # heads pinned to tp where shardable; GQA with n_kv < tp keeps k/v
        # replicated (shard_kv=False)
        hq = "tp" if cfg.shard_heads else "null"
        hkv = "tp" if (cfg.shard_heads and cfg.shard_kv) else "null"
        q = constrain(q, ("batch", "null", hq, "null"), rules)
        k = constrain(k, ("batch", "null", hkv, "null"), rules)
        v = constrain(v, ("batch", "null", hkv, "null"), rules)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _entry(h: torch.Tensor, rules) -> torch.Tensor:
    """A block's normed input with its sequence gathered (the
    sequence-parallel residual's all-gather at block entry; its gradient
    is reduce-scattered back): the projections then flatten (B, S) with
    only the batch split."""
    return constrain(h, ("batch", "null", "null"), rules)


def _exit(y: torch.Tensor, rules) -> torch.Tensor:
    """A block branch's output (B, S, D) before the residual add, whole
    over the sequence: the gradient coming back from the sequence-split
    residual is gathered here, so the branch's products see it whole in
    their backward (DTensor refuses to flatten (B, S) while S is split)."""
    return constrain(y, ("batch", "null", "null"), rules)


def _attn_heads(cfg: LMConfig, x: torch.Tensor) -> str:
    """The logical axis of the heads while attention runs on each rank's
    block: ``tp`` when both the query and the kv heads split evenly over
    ``model`` (each rank then holds whole groups), else ``null``."""
    tp = mesh_size(x, "model")
    return ("tp" if cfg.shard_heads and cfg.shard_kv and tp > 1
            and cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0
            else "null")


def attend(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: LMConfig, rules=None) -> torch.Tensor:
    """``fn(q, k, v)`` (an attention over whole key sequences), returned
    as (B, S, q_dim): on a mesh each rank runs it on its batch block,
    heads as :func:`_attn_heads` says, every key of the sequence present;
    the flat output is pinned to those placements, so its gradient comes
    back on whole heads."""
    h = _attn_heads(cfg, q)
    la = ("batch", "null", h, "null")
    out = local_over(fn, (q, k, v), (la, la, la), la, rules)
    b, s = out.shape[:2]
    return constrain(out.reshape(b, s, cfg.q_dim), ("batch", "null", h),
                     rules)


def block(x: torch.Tensor, lp: Block, cfg: LMConfig, positions: torch.Tensor,
          rules=None):
    """One transformer block (train/prefill, causal). Returns (x, aux).
    The landmark backend (bidirectional) runs only when s > n_landmarks,
    as the reference's."""
    b, s, _ = x.shape
    h = _entry(rms_norm(x, lp.attn_norm), rules)
    q, k, v = _attn_qkv(h, lp, cfg, positions, rules)
    if cfg.attn_backend == "landmark" and s > cfg.n_landmarks:
        def fn(q, k, v):
            return landmark_attention(q, k, v, n_landmarks=cfg.n_landmarks)
    else:
        def fn(q, k, v):
            return flash_attention(q, k, v, causal=True,
                                   kv_chunk=min(cfg.kv_chunk, s),
                                   q_chunk=min(cfg.q_chunk, s))
    attn = attend(fn, q, k, v, cfg, rules)
    x = constrain(x + _exit(attn @ _w(lp, "wo", cfg, rules), rules),
                  ("batch", "seq", "null"), rules)
    f, aux = _ffn(_entry(rms_norm(x, lp.mlp_norm), rules), lp, cfg, rules)
    return constrain(x + _exit(f, rules), ("batch", "seq", "null"), rules), aux


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


# -------------------------------------------------------------- full passes
def lm_forward(model: LM, tokens: torch.Tensor, rules=None):
    """Causal forward; returns (logits f32, moe_aux). With grad enabled
    every block runs under ``torch.utils.checkpoint``."""
    cfg = model.cfg
    b, s = tokens.shape
    positions = _positions(b, s, tokens.device)
    x = embed_tokens(model, tokens, rules)
    aux = 0.0
    remat = torch.is_grad_enabled()
    for lp in model.layers:
        if remat:  # keep only each block's input for the backward
            x, a = checkpoint(block, x, lp, cfg, positions, rules,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = block(x, lp, cfg, positions, rules)
        aux = aux + a
    x = rms_norm(x, model.final_norm)
    return logits_from(model, x, rules), aux


class _LogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim in the ops ATen's CPU kernel
    runs (max, shifted exp, sum, log, add back) and with its backward
    (g · exp(x − lse)), as DTensor ops: the max and the sum reduce over a
    vocab-sharded dim across its ranks. Each step is pinned to the
    logits' placements. On one rank the bits are ``torch.logsumexp``'s."""

    @staticmethod
    def forward(ctx, x, rules):
        m = x.amax(-1, keepdim=True)
        m = torch.where(m.abs() == float("inf"), torch.zeros_like(m), m)
        e = constrain((x - m).exp(), ("batch", "null", "vocab"), rules)
        tot = constrain(e.sum(-1), ("batch", "null"), rules)
        lse = constrain(tot.log() + m[..., 0], ("batch", "null"), rules)
        ctx.save_for_backward(x, lse)
        ctx.rules = rules
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        grad = g.unsqueeze(-1) * (x - lse.unsqueeze(-1)).exp()
        return constrain(grad, ("batch", "null", "vocab"), ctx.rules), None


def _label_onehot(labels: torch.Tensor, logits: torch.Tensor, rules):
    """The one-hot of ``labels`` (B, S) over the vocab, as ``logits``'
    dtype and sharding: each rank fills the slice of the vocab it holds."""
    offset = 0
    if isinstance(logits, DTensor):
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        _, off = compute_local_shape_and_global_offset(
            logits.shape, logits.device_mesh, logits.placements)
        offset = off[-1]

    def fill(lab, lg):
        idx = lab - offset
        hit = (idx >= 0) & (idx < lg.shape[-1])
        oh = torch.zeros(lg.shape, dtype=lg.dtype, device=lg.device)
        return oh.scatter_(-1, idx.clamp(0, lg.shape[-1] - 1)[..., None],
                           hit[..., None].to(lg.dtype))

    return local_over(fill, (labels, logits.detach()),
                      (("batch", "null"), ("batch", "null", "vocab")),
                      ("batch", "null", "vocab"), rules)


def lm_loss(model: LM, batch: Dict[str, torch.Tensor],
            rules=None) -> torch.Tensor:
    """Mean next-token cross-entropy over labels >= 0 (+ 0.01 · aux). On a
    mesh the logits stay vocab-sharded: the label logit is a one-hot
    contraction (the sum of zeros and one logit: exact) and the
    log-sum-exp reduces across the vocab's ranks."""
    logits, aux = lm_forward(model, batch["tokens"], rules)
    labels = batch["labels"].long()
    mask = (labels >= 0).float()
    if isinstance(logits, DTensor):
        lse = _LogSumExp.apply(logits, rules)
        onehot = _label_onehot(labels.clamp_min(0), logits, rules)
        label_logit = constrain((logits * onehot).sum(-1), ("batch", "null"),
                                rules)
        mask = constrain(mask, ("batch", "null"), rules)
    else:
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
               max_seq: Optional[int] = None, rules=None):
    """Run the prompt with causal flash attention (whatever
    ``attn_backend`` says, as the reference); returns (last-token logits
    (B, 1, V), cache). On a mesh the cache comes placed by
    :func:`cache_logical`."""
    cfg = model.cfg
    b, s = tokens.shape
    max_seq = max_seq or s
    positions = _positions(b, s, tokens.device)
    x = embed_tokens(model, tokens, rules)
    ks, vs = [], []
    pad = (0, 0, 0, 0, 0, max_seq - s)
    heads = ("batch", "null", "null", "null")
    for lp in model.layers:
        h = _entry(rms_norm(x, lp.attn_norm), rules)
        q, k, v = _attn_qkv(h, lp, cfg, positions, rules)
        attn = attend(lambda q, k, v: flash_attention(
            q, k, v, causal=True, kv_chunk=min(cfg.kv_chunk, s),
            q_chunk=min(cfg.q_chunk, s)), q, k, v, cfg, rules)
        x = constrain(x + _exit(attn @ _w(lp, "wo", cfg, rules), rules),
                      ("batch", "seq", "null"), rules)
        f, _ = _ffn(_entry(rms_norm(x, lp.mlp_norm), rules), lp, cfg, rules)
        x = constrain(x + _exit(f, rules), ("batch", "seq", "null"), rules)
        kp, vp = local_over(
            lambda k, v: (torch.nn.functional.pad(k, pad),
                          torch.nn.functional.pad(v, pad)),
            (k, v), (heads, heads), [heads, heads], rules)
        ks.append(kp)
        vs.append(vp)
    x = rms_norm(x, model.final_norm)
    logits = logits_from(model, x[:, -1:, :], rules)
    la = cache_logical()
    cache = {"k": constrain(torch.stack(ks), la["k"], rules),
             "v": constrain(torch.stack(vs), la["v"], rules),
             "length": torch.tensor(s, dtype=torch.int32,
                                    device=tokens.device)}
    return logits, cache


def _seq_offset(x: torch.Tensor, dim: int) -> int:
    """The global index of the first row of this rank's block of DTensor
    ``x`` along ``dim`` (0 for a plain tensor)."""
    if not isinstance(x, DTensor):
        return 0
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    return compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)[1][dim]


def _cache_write(dst: torch.Tensor, at: torch.Tensor, new: torch.Tensor,
                 la, rules) -> None:
    """Write ``new`` (B, 1, ...) into ``dst`` (B, S, ...) at position
    ``at`` (a (1,) tensor), in place. On a mesh whose ``la`` splits S the
    rank holding the position writes it, the others write back what they
    hold (no host sync decides which)."""
    off = _seq_offset(dst, 1)
    new_la = (la[0], "null") + tuple(la[2:])

    def write(d, n):
        if not off and d.shape[1] == dst.shape[1]:
            d.index_copy_(1, at, n.to(d.dtype))
            return
        idx = at - off
        hit = (idx >= 0) & (idx < d.shape[1])
        idx = idx.clamp(0, d.shape[1] - 1)
        keep = d.index_select(1, idx)
        d.index_copy_(1, idx, torch.where(hit, n.to(d.dtype), keep))

    local_over(write, (dst, new), (la, new_la), None, rules)


def lm_decode_step(model: LM, cache: Dict[str, torch.Tensor],
                   token: torch.Tensor, rules=None):
    """One decode step. token: (B, 1) int. Returns (logits (B, 1, V), the
    cache updated in place with ``length`` + 1). Under ``cfg.kv_quant`` the
    cache holds int8 + per-(token, head) scales and is dequantized whole
    for attention, as the reference's. On a mesh each rank writes its own
    block of the cache and attention gathers the keys' sequence."""
    cfg = model.cfg
    b = token.shape[0]
    pos = cache["length"]
    positions = pos.expand(b, 1)
    at = pos.reshape(1).long()
    x = embed_tokens(model, token, rules)
    # the reference's long-context cache (past 100,000 positions) splits
    # its sequence over every axis
    la = cache_logical(long_context=cache["k"].shape[2] > 100_000,
                       kv_quant=cfg.kv_quant)
    kv_la, sc_la = la["k"][1:], la.get("k_scale", ("",) * 4)[1:]
    for i, lp in enumerate(model.layers):
        h = rms_norm(x, lp.attn_norm)
        q, k, v = _attn_qkv(h, lp, cfg, positions, rules)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        if cfg.kv_quant:
            kq, ks_new = _kv_quantize(k)
            vq, vs_new = _kv_quantize(v)
            _cache_write(k_cache, at, kq, kv_la, rules)
            _cache_write(v_cache, at, vq, kv_la, rules)
            _cache_write(cache["k_scale"][i], at, ks_new, sc_la, rules)
            _cache_write(cache["v_scale"][i], at, vs_new, sc_la, rules)
            k_full = _kv_dequantize(k_cache, cache["k_scale"][i], cfg.dtype)
            v_full = _kv_dequantize(v_cache, cache["v_scale"][i], cfg.dtype)
        else:
            _cache_write(k_cache, at, k, kv_la, rules)
            _cache_write(v_cache, at, v, kv_la, rules)
            k_full, v_full = k_cache, v_cache
        attn = attend(lambda q, k, v: decode_attention(q, k, v, pos + 1),
                      q, k_full, v_full, cfg, rules)
        x = x + attn @ _w(lp, "wo", cfg, rules)
        f, _ = _ffn(rms_norm(x, lp.mlp_norm), lp, cfg, rules)
        x = x + f
    x = rms_norm(x, model.final_norm)
    cache["length"] = pos + 1
    return logits_from(model, x, rules), cache


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
                            token: torch.Tensor, rules=None):
    """Decode against the landmark summaries — O(n·d) per token per layer.
    Returns (logits (B, 1, V), the cache with m/z/s updated in place and
    ``length`` + 1). On a mesh each rank updates and reads its batch
    block of the state."""
    cfg = model.cfg
    b = token.shape[0]
    pos = cache["length"]
    positions = pos.expand(b, 1)
    x = embed_tokens(model, token, rules)
    scale = 1.0 / np.sqrt(cfg.head_dim)

    def step(k_lm, q_lm, m, z, s, q, k, v):
        st = landmark_state_append(LandmarkKVState(k_lm, q_lm, m, z, s),
                                   k, v, scale)
        m.copy_(st.m)
        z.copy_(st.z)
        s.copy_(st.s)
        return landmark_decode(st, q, scale)

    st_la = landmark_cache_logical()["m"][1:]
    tok = ("batch", "null", "null", "null")
    for i, lp in enumerate(model.layers):
        h = rms_norm(x, lp.attn_norm)
        q, k, v = _attn_qkv(h, lp, cfg, positions, rules)
        attn = local_over(
            step, (cache["k_lm"][i], cache["q_lm"][i], cache["m"][i],
                   cache["z"][i], cache["s"][i], q, k, v),
            (st_la,) * 5 + (tok,) * 3, tok, rules)
        x = x + attn.reshape(b, 1, cfg.q_dim) @ _w(lp, "wo", cfg, rules)
        f, _ = _ffn(rms_norm(x, lp.mlp_norm), lp, cfg, rules)
        x = x + f
    x = rms_norm(x, model.final_norm)
    cache["length"] = pos + 1
    return logits_from(model, x, rules), cache
