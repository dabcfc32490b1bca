"""Arch config 'gemma-7b' — exact hyperparameters in registry.py (one
source of truth)."""
from .registry import get

CONFIG = get("gemma-7b")
MODEL = CONFIG.model
SMOKE = CONFIG.smoke_model
SHAPES = CONFIG.shapes
