"""The LM architectures, dense and MoE, the GNN, the four recsys
architectures and the paper's landmark CF, with the reference registry's
exact hyperparameters, smoke models, optimizers and gradient accumulation
(sources inline)."""
from __future__ import annotations

from typing import Dict

import torch

from ..models.gnn import GNNConfig
from ..models.recsys import Bert4RecConfig, DIENConfig, FMConfig, MINDConfig
from ..models.transformer import LMConfig, MoEConfig
from ..train.optimizer import OptConfig
from . import landmark_cf
from .base import GNN_SHAPES, RECSYS_SHAPES, ArchConfig, lm_shapes

ARCHS: Dict[str, ArchConfig] = {}


def _register(cfg: ArchConfig) -> ArchConfig:
    ARCHS[cfg.name] = cfg
    return cfg


_register(ArchConfig(
    name="llama3-405b",
    family="lm",
    source="arXiv:2407.21783 (unverified tier)",
    model=LMConfig(
        name="llama3-405b", n_layers=126, d_model=16384, n_heads=128,
        n_kv_heads=8, head_dim=128, d_ff=53248, vocab=128256,
        act="silu", rope_theta=500000.0, kv_chunk=1024, n_landmarks=512),
    smoke_model=LMConfig(
        name="llama3-smoke", n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
        head_dim=16, d_ff=256, vocab=512, act="silu", n_landmarks=8),
    shapes=lm_shapes(),
    opt=OptConfig(name="adafactor", state_dtype=torch.bfloat16),
    grad_accum={"train_4k": 8},
))

_register(ArchConfig(
    name="smollm-360m",
    family="lm",
    source="hf:HuggingFaceTB/SmolLM-360M (hf tier)",
    model=LMConfig(
        name="smollm-360m", n_layers=32, d_model=960, n_heads=15,
        n_kv_heads=5, head_dim=64, d_ff=2560, vocab=49152,
        act="silu", tied_embed=True, n_landmarks=512),
    smoke_model=LMConfig(
        name="smollm-smoke", n_layers=2, d_model=96, n_heads=3, n_kv_heads=1,
        head_dim=32, d_ff=256, vocab=512, act="silu", tied_embed=True,
        n_landmarks=8),
    shapes=lm_shapes(),
    opt=OptConfig(name="adamw"),
    grad_accum={"train_4k": 1},
))

_register(ArchConfig(
    name="gemma-7b",
    family="lm",
    source="arXiv:2403.08295 (hf tier)",
    model=LMConfig(
        name="gemma-7b", n_layers=28, d_model=3072, n_heads=16,
        n_kv_heads=16, head_dim=256, d_ff=24576, vocab=256000,
        act="gelu", tied_embed=True, embed_scale=True, n_landmarks=512),
    smoke_model=LMConfig(
        name="gemma-smoke", n_layers=2, d_model=96, n_heads=4, n_kv_heads=4,
        head_dim=32, d_ff=256, vocab=512, act="gelu", tied_embed=True,
        embed_scale=True, n_landmarks=8),
    shapes=lm_shapes(),
    opt=OptConfig(name="adamw"),
    grad_accum={"train_4k": 2},
))

_register(ArchConfig(
    name="deepseek-moe-16b",
    family="lm",
    source="arXiv:2401.06066 (hf tier)",
    model=LMConfig(
        name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
        n_kv_heads=16, head_dim=128, d_ff=0, vocab=102400, act="silu",
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                      capacity_factor=1.25, group_size=512),
        n_landmarks=512),
    smoke_model=LMConfig(
        name="deepseek-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=0, vocab=512, act="silu",
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=2,
                      group_size=16),
        n_landmarks=8),
    shapes=lm_shapes(),
    opt=OptConfig(name="adamw"),
    grad_accum={"train_4k": 2},
))

_register(ArchConfig(
    name="dbrx-132b",
    family="lm",
    source="hf:databricks/dbrx-base (unverified tier)",
    model=LMConfig(
        name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48,
        n_kv_heads=8, head_dim=128, d_ff=0, vocab=100352, act="silu",
        moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752, n_shared=0,
                      capacity_factor=1.25, group_size=512),
        kv_chunk=1024, n_landmarks=512),
    smoke_model=LMConfig(
        name="dbrx-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=0, vocab=512, act="silu",
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, group_size=16),
        n_landmarks=8),
    shapes=lm_shapes(),
    opt=OptConfig(name="adamw", state_dtype=torch.bfloat16),
    grad_accum={"train_4k": 8},
))

# ===================================================================== GNN
# The paper's landmark technique does not apply to message passing; the
# GNN runs without it, as the reference's.
_register(ArchConfig(
    name="gatedgcn",
    family="gnn",
    source="arXiv:2003.00982 (paper tier)",
    model=GNNConfig(name="gatedgcn", n_layers=16, d_hidden=70),
    smoke_model=GNNConfig(name="gatedgcn-smoke", n_layers=3, d_hidden=16,
                          d_feat=32, n_classes=5),
    shapes=GNN_SHAPES,
    opt=OptConfig(name="adamw", lr=1e-3),
))

# ==================================================================== recsys
# FM field vocabularies: a criteo-like long-tail mix, 39 fields, 41,688,900
# rows (41,689,088 once padded to a multiple of 512).
_FM_VOCABS = tuple(
    [20_000_000, 10_000_000, 5_000_000, 2_000_000]
    + [1_000_000] * 4
    + [100_000] * 6
    + [10_000] * 8
    + [1_000] * 8
    + [100] * 9
)
assert len(_FM_VOCABS) == 39

_register(ArchConfig(
    name="fm",
    family="recsys",
    source="ICDM'10 Rendle (paper tier)",
    model=FMConfig(name="fm", n_fields=39, embed_dim=10,
                   field_vocabs=_FM_VOCABS),
    smoke_model=FMConfig(name="fm-smoke", n_fields=5, embed_dim=8,
                         field_vocabs=(100, 50, 20, 10, 5)),
    shapes=RECSYS_SHAPES,
    opt=OptConfig(name="adamw", lr=1e-3),
))

_register(ArchConfig(
    name="bert4rec",
    family="recsys",
    source="arXiv:1904.06690 (paper tier)",
    model=Bert4RecConfig(name="bert4rec", n_items=1_000_000, embed_dim=64,
                         n_blocks=2, n_heads=2, seq_len=200,
                         n_negatives=511),
    smoke_model=Bert4RecConfig(name="bert4rec-smoke", n_items=1000,
                               embed_dim=32, n_blocks=2, n_heads=2,
                               seq_len=20, n_negatives=32),
    shapes=RECSYS_SHAPES,
    opt=OptConfig(name="adamw", lr=1e-3),
))

_register(ArchConfig(
    name="mind",
    family="recsys",
    source="arXiv:1904.08030 (unverified tier)",
    model=MINDConfig(name="mind", n_items=1_000_000, embed_dim=64,
                     n_interests=4, capsule_iters=3, seq_len=50,
                     n_negatives=511),
    smoke_model=MINDConfig(name="mind-smoke", n_items=1000, embed_dim=32,
                           n_interests=4, capsule_iters=3, seq_len=20,
                           n_negatives=32),
    shapes=RECSYS_SHAPES,
    opt=OptConfig(name="adamw", lr=1e-3),
))

_register(ArchConfig(
    name="dien",
    family="recsys",
    source="arXiv:1809.03672 (unverified tier)",
    model=DIENConfig(name="dien", n_items=1_000_000, embed_dim=18,
                     seq_len=100, gru_dim=108, mlp_dims=(200, 80)),
    smoke_model=DIENConfig(name="dien-smoke", n_items=1000, embed_dim=8,
                           seq_len=20, gru_dim=16, mlp_dims=(32, 16)),
    shapes=RECSYS_SHAPES,
    opt=OptConfig(name="adamw", lr=1e-3),
))

# ======================================= paper-native: landmark CF as an arch
# its spec and four shapes live in configs/landmark_cf.py beside the
# lifecycle's thresholds
_register(ArchConfig(
    name="landmark_cf",
    family="cf",
    source="the reproduced paper (Lima, Mello, Zimbrão 2017)",
    model=landmark_cf.MODEL,
    smoke_model=landmark_cf.SMOKE,
    shapes=landmark_cf.SHAPES,
    opt=OptConfig(),
))


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
