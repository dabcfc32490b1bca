"""Config schema for the LM family: an ``ArchConfig`` holds one
architecture's published hyperparameters, a reduced smoke model for CPU
tests, and its shape set — the reference's schema without the sharding
rules and optimizer settings, which the single-device serving path does
not read."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    dims: Dict[str, Any]
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # lm
    model: Any
    smoke_model: Any
    shapes: Tuple[ShapeSpec, ...]
    source: str = ""


# The four LM shapes shared by every transformer arch.
def lm_shapes() -> Tuple[ShapeSpec, ...]:
    return (
        ShapeSpec("train_4k", "train", dict(batch=256, seq=4096)),
        ShapeSpec("prefill_32k", "prefill", dict(batch=32, seq=32768)),
        ShapeSpec("decode_32k", "decode", dict(batch=128, cache_len=32768)),
        ShapeSpec(
            "long_500k", "decode",
            dict(batch=1, cache_len=524288, landmark_variant=True),
            note="pure full-attention arch: the baseline decodes over the "
            "exact cache (O(S)/token); the landmark variant decodes through "
            "landmark summaries at O(n)/token."),
    )
