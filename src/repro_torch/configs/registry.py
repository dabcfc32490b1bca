"""The dense LM architectures, with the reference registry's exact
hyperparameters and smoke models (sources inline). The MoE entries
(``deepseek-moe-16b``, ``dbrx-132b``) wait for the MoE FFN (ROADMAP queue
1 (MoE))."""
from __future__ import annotations

from typing import Dict

from ..models.transformer import LMConfig
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
))


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
