"""Config schema for the LM family: an ``ArchConfig`` holds one
architecture's published hyperparameters, a reduced smoke model for CPU
tests, its shape set, its optimizer and its gradient accumulation per
shape — the reference's schema without the sharding rules, which the
single-device port does not read."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from ..train.optimizer import OptConfig


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
    opt: OptConfig = OptConfig()
    grad_accum: Dict[str, int] = dataclasses.field(default_factory=dict)

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.name} has no shape {name!r}; has "
                       f"{[s.name for s in self.shapes]}")


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
