"""Arch config 'smollm-360m' — exact hyperparameters in registry.py (one
source of truth)."""
from .registry import get

CONFIG = get("smollm-360m")
MODEL = CONFIG.model
SMOKE = CONFIG.smoke_model
SHAPES = CONFIG.shapes
