"""Arch config 'llama3-405b' — exact hyperparameters in registry.py (one
source of truth)."""
from .registry import get

CONFIG = get("llama3-405b")
MODEL = CONFIG.model
SMOKE = CONFIG.smoke_model
SHAPES = CONFIG.shapes
