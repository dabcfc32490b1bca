"""Arch config 'dbrx-132b' — exact hyperparameters in registry.py (one
source of truth)."""
from .registry import get

CONFIG = get("dbrx-132b")
MODEL = CONFIG.model
SMOKE = CONFIG.smoke_model
SHAPES = CONFIG.shapes
