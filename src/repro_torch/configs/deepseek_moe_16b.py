"""Arch config 'deepseek-moe-16b' — exact hyperparameters in registry.py (one
source of truth)."""
from .registry import get

CONFIG = get("deepseek-moe-16b")
MODEL = CONFIG.model
SMOKE = CONFIG.smoke_model
SHAPES = CONFIG.shapes
