"""Arch config 'bert4rec' — exact hyperparameters in registry.py (one
source of truth)."""
from .registry import get

CONFIG = get("bert4rec")
MODEL = CONFIG.model
SMOKE = CONFIG.smoke_model
SHAPES = CONFIG.shapes
