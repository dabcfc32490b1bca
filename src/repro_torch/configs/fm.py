"""Arch config 'fm' — exact hyperparameters in registry.py (one
source of truth)."""
from .registry import get

CONFIG = get("fm")
MODEL = CONFIG.model
SMOKE = CONFIG.smoke_model
SHAPES = CONFIG.shapes
