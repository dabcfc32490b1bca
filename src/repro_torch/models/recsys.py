"""The four recsys architectures, FM, BERT4Rec, MIND and DIEN: the
reference's ``repro.models.recsys`` in PyTorch.

Shared substrate: embedding tables gathered through
``distributed/embedding.py`` (a lookup's backward is the fixed-order
segment sum, so a training step is bitwise reproducible on the card),
sampled-softmax training losses (vocabularies of 10⁶ rule out a full
softmax), and top-k retrieval over every item (``distributed_topk``, the
reference's ``lax.top_k`` order).

Each model is an ``nn.Module`` holding the reference's parameters under
its names (BERT4Rec's blocks as ``layers.{i}.{name}``, which
``train/optimizer.py::stacks`` gathers into the reference's stacked
tree; DIEN's GRUs as ``gru1.{wx,wh,b}``), with ``init_*(cfg, generator,
device)`` and the functions ``*_loss(model, batch)``,
``*_scores(model, batch)`` and ``*_retrieval(model, batch, k)``. The
reference's ``lax.scan`` loops (BERT4Rec's blocks, MIND's routing,
DIEN's two GRU scans) are Python loops. On plain tensors the reference's
sharding annotations (``shard_batch_full``) are identities.

On a mesh of ranks the parameters are DTensors placed by the reference's
``*_logical`` trees (:func:`param_logical`: every table's rows over
``model``, everything else replicated) and the batch is split over the
batch axes, or over every axis where it divides them
(``launch/steps.py``): the lookups run on each rank's row shard
(``distributed/embedding.py``), ``shard_batch_full`` splits their rows
over every axis, DTensor carries the dense layers, and the steps it has
no rule for (attention's recurrence, the masked positions' gather) run
on each rank's rows (``sharding.rowwise``). Retrieval scores over a
row-sharded table take each shard's top k, then the top k of those
(``distributed_topk``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.types import round_up
from ..distributed.embedding import (distributed_topk, embedding_lookup,
                                     embedding_lookups)
from ..distributed.sharding import rowwise, shard_batch_full, zeros_rows
from . import layers


def _param(shape, dtype, device, fill=0.0) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, fill, dtype=dtype, device=device))


def _draw(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device)


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy with logits, the reference's stable form."""
    y = labels.float()
    return torch.mean(torch.clamp_min(logits, 0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))


# ===================================================================== FM
@dataclasses.dataclass(frozen=True)
class FMConfig:
    name: str = "fm"
    n_fields: int = 39
    embed_dim: int = 10
    field_vocabs: Tuple[int, ...] = ()  # len == n_fields
    dtype: torch.dtype = torch.float32

    @property
    def total_rows(self) -> int:
        return int(sum(self.field_vocabs))

    @property
    def table_rows(self) -> int:
        # padded so the row-sharded table divides any tp axis up to 512
        return round_up(self.total_rows, 512)

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.field_vocabs)[:-1]]
                              ).astype(np.int32)


class FM(nn.Module):
    """``v`` (rows, D), ``w`` (rows,), ``b`` ()."""

    def __init__(self, cfg: FMConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.v = _param((cfg.table_rows, cfg.embed_dim), cfg.dtype, device)
        self.w = _param((cfg.table_rows,), cfg.dtype, device)
        self.b = _param((), cfg.dtype, device)


def fm_logical(cfg: FMConfig):
    return {"v": ("rows", "null"), "w": ("rows",), "b": ()}


def init_fm(cfg: FMConfig, generator: Optional[torch.Generator] = None,
            device="cuda") -> FM:
    """v, w ~ N(0, 0.01²) in that order, b = 0. ``torch.Generator`` cannot
    reproduce ``jax.random``: parity goes through ``models.convert``."""
    generator = generator or torch.Generator().manual_seed(0)
    model = FM(cfg, device)
    with torch.no_grad():
        model.v.copy_(_draw(generator, model.v.shape) * 0.01)
        model.w.copy_(_draw(generator, model.w.shape) * 0.01)
    return model


def fm_scores(model: FM, field_ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """Rendle's O(nk) sum-square trick. field_ids: (B, F), already offset.
    ``v`` and ``w`` take the same ids, so their lookups share one CSR."""
    v, w = embedding_lookups((model.v, model.w[:, None]), field_ids, mesh)
    v = shard_batch_full(v, mesh)
    w = shard_batch_full(w, mesh)[..., 0]
    sum_v = v.sum(dim=1)
    sum_sq = (v * v).sum(dim=1)
    pair = 0.5 * (sum_v * sum_v - sum_sq).sum(dim=-1)
    return model.b + w.sum(dim=1) + pair


def fm_loss(model: FM, batch, mesh=None) -> torch.Tensor:
    return _bce(fm_scores(model, batch["field_ids"], mesh), batch["labels"])


def fm_retrieval(model: FM, field_ids: torch.Tensor, cand_ids: torch.Tensor,
                 k: int = 100, mesh=None):
    """Score one user's context against C candidate rows (retrieval_cand):
    score(u, c) = w_c + v_c·Σv_u (the user's constant dropped), one
    (C, D) × (D,) product over the candidates."""
    v_u = embedding_lookup(model.v, field_ids, mesh).sum(dim=1)  # (B, D)
    v_c = embedding_lookup(model.v, cand_ids, mesh)  # (C, D)
    w_c = embedding_lookup(model.w[:, None], cand_ids, mesh)[..., 0]  # (C,)
    scores = torch.einsum("bd,cd->bc", v_u, v_c) + w_c[None, :]
    return distributed_topk(scores, k)


# ================================================================ BERT4Rec
@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    n_negatives: int = 511
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.n_heads

    @property
    def table_rows(self) -> int:
        return round_up(self.n_items + 1, 512)


BLOCK_MATS = ("wq", "wk", "wv", "wo", "w1", "w2")
BLOCK_NORMS = ("ln1", "ln2")


class Bert4RecBlock(nn.Module):
    """One block: wq, wk, wv, wo (d, d), w1 (d, 4d), w2 (4d, d), ln1, ln2
    (d,)."""

    def __init__(self, cfg: Bert4RecConfig, device="cuda"):
        super().__init__()
        d, dt = cfg.embed_dim, cfg.dtype
        shapes = dict(wq=(d, d), wk=(d, d), wv=(d, d), wo=(d, d),
                      w1=(d, 4 * d), w2=(4 * d, d))
        for name in BLOCK_MATS:
            self.register_parameter(name, _param(shapes[name], dt, device))
        for name in BLOCK_NORMS:
            self.register_parameter(name, _param((d,), dt, device, 1.0))


class Bert4Rec(nn.Module):
    """``item_embed`` (rows, d; the [MASK] token at id n_items),
    ``pos_embed`` (S, d), ``layers`` (a ``ModuleList`` of
    :class:`Bert4RecBlock`), ``final_ln`` (d,)."""

    def __init__(self, cfg: Bert4RecConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.embed_dim, cfg.dtype
        self.item_embed = _param((cfg.table_rows, d), dt, device)
        self.pos_embed = _param((cfg.seq_len, d), dt, device)
        self.layers = nn.ModuleList(Bert4RecBlock(cfg, device)
                                    for _ in range(cfg.n_blocks))
        self.final_ln = _param((d,), dt, device, 1.0)


def bert4rec_logical(cfg: Bert4RecConfig):
    lin = ("layers", "null", "null")
    return {
        "item_embed": ("rows", "null"),
        "pos_embed": ("null", "null"),
        "layers": {**{k: lin for k in BLOCK_MATS},
                   **{k: ("layers", "null") for k in BLOCK_NORMS}},
        "final_ln": ("null",),
    }


def init_bert4rec(cfg: Bert4RecConfig,
                  generator: Optional[torch.Generator] = None,
                  device="cuda") -> Bert4Rec:
    """item_embed, pos_embed ~ N(0, 0.02²), then each block matrix as an
    (L, a, b) stack ~ N(0, 1/a), in the reference's order; norms 1."""
    generator = generator or torch.Generator().manual_seed(0)
    model = Bert4Rec(cfg, device)
    with torch.no_grad():
        model.item_embed.copy_(_draw(generator, model.item_embed.shape) * 0.02)
        model.pos_embed.copy_(_draw(generator, model.pos_embed.shape) * 0.02)
        for name in BLOCK_MATS:
            a, b = getattr(model.layers[0], name).shape
            stack = _draw(generator, (cfg.n_blocks, a, b)) / np.sqrt(a)
            for blk, w in zip(model.layers, stack):
                getattr(blk, name).copy_(w)
    return model


def _ln(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * s


def bert4rec_encode(model: Bert4Rec, item_ids: torch.Tensor,
                    mesh=None) -> torch.Tensor:
    """item_ids: (B, S) with -1 padding → (B, S, D) bidirectional
    encodings."""
    cfg = model.cfg
    b, s = item_ids.shape
    heads = (b, s, cfg.n_heads, cfg.head_dim)
    x = (embedding_lookup(model.item_embed, item_ids, mesh)
         + model.pos_embed[None, :s])
    x = shard_batch_full(x, mesh)
    for lp in model.layers:
        h = _ln(x, lp.ln1)
        q = (h @ lp.wq).reshape(heads)
        k = (h @ lp.wk).reshape(heads)
        v = (h @ lp.wv).reshape(heads)
        a = rowwise(lambda q, k, v: layers.flash_attention(
            q, k, v, causal=False, kv_chunk=s), q, k, v)
        x = x + a.reshape(b, s, -1) @ lp.wo
        h = _ln(x, lp.ln2)
        f = F.gelu(h @ lp.w1, approximate="tanh")
        x = x + f @ lp.w2
    return _ln(x, model.final_ln)


def _sampled_softmax(user_vec, pos_ids, neg_ids, table, mesh=None):
    """CE over [positive ∥ shared negatives]. user_vec: (..., D)."""
    pos_e = embedding_lookup(table, pos_ids, mesh)  # (..., D)
    neg_e = embedding_lookup(table, neg_ids, mesh)  # (N, D)
    pos_logit = (user_vec * pos_e).sum(-1, keepdim=True)
    neg_logit = torch.einsum("...d,nd->...n", user_vec, neg_e)
    logits = torch.cat([pos_logit, neg_logit], dim=-1).float()
    return -torch.log_softmax(logits, dim=-1)[..., 0]


def _take_positions(enc: torch.Tensor, positions: torch.Tensor
                    ) -> torch.Tensor:
    """``take_along_axis(enc, positions[..., None], axis=1)``: (B, M, D).
    Positions repeat within a row, so the gather's backward is the
    fixed-order segment sum over the flattened (B·S, D) encodings, not
    ``torch.gather``'s scatter-add. On a mesh each rank takes its own
    rows'."""
    def take(enc, positions):
        b, s, d = enc.shape
        rows = (torch.arange(b, device=enc.device)[:, None] * s
                + positions.long())
        return embedding_lookup(enc.reshape(b * s, d), rows)

    return rowwise(take, enc, positions)


def bert4rec_loss(model: Bert4Rec, batch, mesh=None) -> torch.Tensor:
    """Masked-item prediction with sampled softmax (vocab 10⁶)."""
    enc = bert4rec_encode(model, batch["item_ids"], mesh)  # (B, S, D)
    targets = batch["targets"]  # (B, M) true item ids, -1 pad
    vecs = _take_positions(enc, batch["mask_positions"])  # (B, M, D)
    losses = _sampled_softmax(vecs, torch.clamp_min(targets, 0),
                              batch["negatives"], model.item_embed, mesh)
    w = (targets >= 0).float()
    return (losses * w).sum() / torch.clamp_min(w.sum(), 1.0)


def bert4rec_scores(model: Bert4Rec, batch, mesh=None) -> torch.Tensor:
    """Serve: score the given candidates for the next position."""
    user = bert4rec_encode(model, batch["item_ids"], mesh)[:, -1]  # (B, D)
    cand = embedding_lookup(model.item_embed, batch["candidates"], mesh)
    return torch.einsum("bd,bcd->bc", user, cand)


def bert4rec_retrieval(model: Bert4Rec, batch, k: int = 100, mesh=None):
    user = bert4rec_encode(model, batch["item_ids"], mesh)[:, -1]
    scores = user @ model.item_embed.T
    return distributed_topk(scores, k, model.cfg.n_items)


# ==================================================================== MIND
@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    n_items: int = 1_000_000
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    seq_len: int = 50
    n_negatives: int = 511
    dtype: torch.dtype = torch.float32

    @property
    def table_rows(self) -> int:
        return round_up(self.n_items, 512)


class MIND(nn.Module):
    """``item_embed`` (rows, d), ``s_matrix`` (d, d)."""

    def __init__(self, cfg: MINDConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.item_embed = _param((cfg.table_rows, d), cfg.dtype, device)
        self.s_matrix = _param((d, d), cfg.dtype, device)


def mind_logical(cfg: MINDConfig):
    return {"item_embed": ("rows", "null"), "s_matrix": ("null", "null")}


def init_mind(cfg: MINDConfig, generator: Optional[torch.Generator] = None,
              device="cuda") -> MIND:
    """item_embed ~ N(0, 0.02²), s_matrix ~ N(0, 1/d)."""
    generator = generator or torch.Generator().manual_seed(0)
    model = MIND(cfg, device)
    d = cfg.embed_dim
    with torch.no_grad():
        model.item_embed.copy_(_draw(generator, model.item_embed.shape) * 0.02)
        model.s_matrix.copy_(_draw(generator, (d, d)) / np.sqrt(d))
    return model


def _squash(x: torch.Tensor) -> torch.Tensor:
    n2 = (x * x).sum(-1, keepdim=True)
    return (n2 / (1.0 + n2)) * x * torch.rsqrt(n2 + 1e-9)


def mind_interests(model: MIND, item_ids: torch.Tensor,
                   mesh=None) -> torch.Tensor:
    """B2I dynamic routing → (B, K, D) interest capsules."""
    cfg = model.cfg
    e = shard_batch_full(embedding_lookup(model.item_embed, item_ids, mesh),
                         mesh)
    msg = e @ model.s_matrix
    valid = (item_ids >= 0).float()
    b_logits = zeros_rows(e, (e.shape[0], cfg.n_interests, e.shape[1]),
                          torch.float32)
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b_logits, dim=1) * valid[:, None, :]
        caps = _squash(torch.einsum("bks,bsd->bkd", w, msg))
        b_logits = b_logits + torch.einsum("bkd,bsd->bks", caps, msg)
    return caps  # (B, K, D)


def mind_loss(model: MIND, batch, mesh=None) -> torch.Tensor:
    caps = mind_interests(model, batch["item_ids"], mesh)  # (B, K, D)
    target_e = embedding_lookup(model.item_embed, batch["targets"], mesh)
    # label-aware attention: the interest most aligned with the target
    att = torch.softmax(torch.einsum("bkd,bd->bk", caps, target_e) * 2.0,
                        dim=-1)
    user = torch.einsum("bk,bkd->bd", att, caps)
    return _sampled_softmax(user, batch["targets"], batch["negatives"],
                            model.item_embed, mesh).mean()


def mind_scores(model: MIND, batch, mesh=None) -> torch.Tensor:
    caps = mind_interests(model, batch["item_ids"], mesh)
    cand = embedding_lookup(model.item_embed, batch["candidates"], mesh)
    return torch.einsum("bkd,bcd->bkc", caps, cand).amax(dim=1)


def mind_retrieval(model: MIND, batch, k: int = 100, mesh=None):
    caps = mind_interests(model, batch["item_ids"], mesh)
    scores = torch.einsum("bkd,vd->bkv", caps, model.item_embed).amax(dim=1)
    return distributed_topk(scores, k, model.cfg.n_items)


# ==================================================================== DIEN
@dataclasses.dataclass(frozen=True)
class DIENConfig:
    name: str = "dien"
    n_items: int = 1_000_000
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp_dims: Tuple[int, int] = (200, 80)
    dtype: torch.dtype = torch.float32

    @property
    def table_rows(self) -> int:
        return round_up(self.n_items, 512)


class GRU(nn.Module):
    """``wx`` (d_in, 3h), ``wh`` (h, 3h), ``b`` (3h,): gates z, r, n."""

    def __init__(self, d_in: int, d_h: int, dtype, device="cuda"):
        super().__init__()
        self.wx = _param((d_in, 3 * d_h), dtype, device)
        self.wh = _param((d_h, 3 * d_h), dtype, device)
        self.b = _param((3 * d_h,), dtype, device)


MLP_NAMES = ("mlp_w1", "mlp_b1", "mlp_w2", "mlp_b2", "mlp_w3", "mlp_b3")


class DIEN(nn.Module):
    """``item_embed`` (rows, d), ``gru1`` (d → g), ``gru2`` (g → g, the
    AUGRU), ``att_w`` (g, d), and the MLP ``mlp_w1`` (g + 2d, m0),
    ``mlp_b1``, ``mlp_w2`` (m0, m1), ``mlp_b2``, ``mlp_w3`` (m1, 1),
    ``mlp_b3`` ()."""

    def __init__(self, cfg: DIENConfig, device="cuda"):
        super().__init__()
        self.cfg = cfg
        d, g, dt = cfg.embed_dim, cfg.gru_dim, cfg.dtype
        m0, m1 = cfg.mlp_dims
        self.item_embed = _param((cfg.table_rows, d), dt, device)
        self.gru1 = GRU(d, g, dt, device)
        self.gru2 = GRU(g, g, dt, device)
        self.att_w = _param((g, d), dt, device)
        shapes = dict(mlp_w1=(g + 2 * d, m0), mlp_b1=(m0,), mlp_w2=(m0, m1),
                      mlp_b2=(m1,), mlp_w3=(m1, 1), mlp_b3=())
        for name in MLP_NAMES:
            self.register_parameter(name, _param(shapes[name], dt, device))


def dien_logical(cfg: DIENConfig):
    gru = {"wx": ("null", "null"), "wh": ("null", "null"), "b": ("null",)}
    return {"item_embed": ("rows", "null"), "gru1": gru, "gru2": dict(gru),
            "att_w": ("null", "null"), "mlp_w1": ("null", "null"),
            "mlp_b1": ("null",), "mlp_w2": ("null", "null"),
            "mlp_b2": ("null",), "mlp_w3": ("null", "null"), "mlp_b3": ()}


def init_dien(cfg: DIENConfig, generator: Optional[torch.Generator] = None,
              device="cuda") -> DIEN:
    """item_embed ~ N(0, 0.02²); each GRU's wx, wh ~ N(0, 1/(d_in + h));
    att_w and the MLP matrices ~ N(0, 1/fan_in), in the reference's order;
    biases 0."""
    generator = generator or torch.Generator().manual_seed(0)
    model = DIEN(cfg, device)
    with torch.no_grad():
        model.item_embed.copy_(_draw(generator, model.item_embed.shape) * 0.02)
        for gru in (model.gru1, model.gru2):
            s = 1.0 / np.sqrt(gru.wx.shape[0] + gru.wh.shape[0])
            gru.wx.copy_(_draw(generator, gru.wx.shape) * s)
            gru.wh.copy_(_draw(generator, gru.wh.shape) * s)
        for p in (model.att_w, model.mlp_w1, model.mlp_w2, model.mlp_w3):
            p.copy_(_draw(generator, p.shape) / np.sqrt(p.shape[0]))
    return model


def _gru_step(p: GRU, h, x, a=None):
    """Standard GRU; with ``a`` the update gate is scaled by it (AUGRU)."""
    zx, rx, nx = (x @ p.wx + p.b).chunk(3, dim=-1)
    zh, rh, nh = (h @ p.wh).chunk(3, dim=-1)
    z = torch.sigmoid(zx + zh)
    if a is not None:
        z = z * a[:, None]
    r = torch.sigmoid(rx + rh)
    n = torch.tanh(nx + r * nh)
    return (1.0 - z) * h + z * n


def _interest_states(model: DIEN, e, valid):
    """The interest-extraction GRU over the history: the state after each
    step, a list over S of (B, G). Padded steps keep the state. The steps
    take ``unbind`` views of the history, whose backward is one stack
    (indexing ``e[:, t]`` would add S zero-filled (B, S, d) gradients)."""
    h = zeros_rows(e, (e.shape[0], model.cfg.gru_dim), model.cfg.dtype)
    states = []
    for x, m in zip(e.unbind(1), valid[..., None].unbind(1)):
        h = m * _gru_step(model.gru1, h, x) + (1 - m) * h
        states.append(h)
    return states


def dien_logits(model: DIEN, batch, mesh=None) -> torch.Tensor:
    hist, target = batch["item_ids"], batch["targets"]  # (B, S), (B,)
    e = shard_batch_full(embedding_lookup(model.item_embed, hist, mesh), mesh)
    te = shard_batch_full(embedding_lookup(model.item_embed, target, mesh),
                          mesh)
    valid = (hist >= 0).to(e.dtype)
    states = _interest_states(model, e, valid)
    # attention of each interest state vs the target item (DIN-style)
    att = torch.softmax(
        torch.einsum("bsg,gd,bd->bs", torch.stack(states, dim=1),
                     model.att_w, te)
        + (valid - 1.0) * 1e9, dim=-1)
    # the interest-evolving AUGRU
    h = torch.zeros_like(states[0])
    for x, a, m in zip(states, att.unbind(1), valid[..., None].unbind(1)):
        h = m * _gru_step(model.gru2, h, x, a) + (1 - m) * h
    mean_e = ((e * valid[..., None]).sum(1)
              / torch.clamp_min(valid.sum(1, keepdim=True), 1.0))
    feat = torch.cat([h, te, mean_e], dim=-1)
    h = torch.relu(feat @ model.mlp_w1 + model.mlp_b1)
    h = torch.relu(h @ model.mlp_w2 + model.mlp_b2)
    return (h @ model.mlp_w3)[:, 0] + model.mlp_b3


def dien_loss(model: DIEN, batch, mesh=None) -> torch.Tensor:
    return _bce(dien_logits(model, batch, mesh), batch["labels"])


def dien_retrieval(model: DIEN, batch, k: int = 100, mesh=None):
    """1M candidates: the GRU's final interest state, projected by att_w,
    dotted with every item embedding (the AUGRU re-ranks the top-k
    shortlist in a second stage)."""
    hist = batch["item_ids"]
    e = embedding_lookup(model.item_embed, hist, mesh)
    h = _interest_states(model, e, (hist >= 0).to(e.dtype))[-1]
    scores = (h @ model.att_w) @ model.item_embed.T
    return distributed_topk(scores, k, model.cfg.n_items)


# ---------------------------------------------------------------- dispatch
@dataclasses.dataclass(frozen=True)
class RecFamily:
    """One architecture's module, init, loss, scores and retrieval."""

    cls: type
    logical: object
    init: object
    loss: object
    scores: object
    retrieval: object


def _fm_scores_batch(model, batch, mesh=None):
    return fm_scores(model, batch["field_ids"], mesh)


def _fm_retrieval_batch(model, batch, k=100, mesh=None):
    return fm_retrieval(model, batch["field_ids"], batch["cand_ids"], k, mesh)


# config type -> its functions; scores take a batch, as the cells call them
FAMILIES = {
    FMConfig: RecFamily(FM, fm_logical, init_fm, fm_loss, _fm_scores_batch,
                        _fm_retrieval_batch),
    Bert4RecConfig: RecFamily(Bert4Rec, bert4rec_logical, init_bert4rec,
                              bert4rec_loss, bert4rec_scores,
                              bert4rec_retrieval),
    MINDConfig: RecFamily(MIND, mind_logical, init_mind, mind_loss,
                          mind_scores, mind_retrieval),
    DIENConfig: RecFamily(DIEN, dien_logical, init_dien, dien_loss,
                          dien_logits, dien_retrieval),
}
MODELS = tuple(f.cls for f in FAMILIES.values())


def family(cfg) -> RecFamily:
    return FAMILIES[type(cfg)]


def param_logical(cfg) -> dict:
    """Logical axes by ``named_parameters()`` name, from the reference's
    tree (``family(cfg).logical``): BERT4Rec's ``layers.{i}.{name}`` takes
    the stacked tuple without its leading ``"layers"``, DIEN's
    ``gru1.wx`` the nested entry."""
    out = {}

    def walk(tree, prefix):
        for key, la in tree.items():
            if key == "layers":
                for i in range(cfg.n_blocks):
                    for name, sub in la.items():
                        out[f"layers.{i}.{name}"] = sub[1:]
            elif isinstance(la, dict):
                walk(la, f"{prefix}{key}.")
            else:
                out[prefix + key] = la

    walk(family(cfg).logical(cfg), "")
    return out


def init_recsys(cfg, generator: Optional[torch.Generator] = None,
                device="cuda") -> nn.Module:
    """The model of ``cfg`` (any of the four configs) with random weights."""
    return family(cfg).init(cfg, generator, device)
