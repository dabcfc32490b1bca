"""Arch config 'mind' — exact hyperparameters in registry.py (one
source of truth)."""
from .registry import get

CONFIG = get("mind")
MODEL = CONFIG.model
SMOKE = CONFIG.smoke_model
SHAPES = CONFIG.shapes
