"""The LM architectures, dense and MoE, with the reference registry's
exact hyperparameters, smoke models, optimizers and gradient accumulation
(sources inline)."""
from __future__ import annotations

from typing import Dict

import torch

from ..models.transformer import LMConfig, MoEConfig
from ..train.optimizer import OptConfig
from .base import ArchConfig, lm_shapes

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


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
