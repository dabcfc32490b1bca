"""Config schema for the LM, GNN, recsys and CF families: an ``ArchConfig``
holds one architecture's published hyperparameters, a reduced smoke model
for CPU tests, its shape set, its optimizer and its gradient accumulation
per shape — the reference's schema without the sharding rules, which the
single-device port does not read."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from ..train.optimizer import OptConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    # train | prefill | decode | train_graph | scores | retrieval |
    # cf_fit | cf_predict
    kind: str
    dims: Dict[str, Any]
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # lm | gnn | recsys | cf
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


# The GNN shapes (the reference's ``GNN_SHAPES``, dims unchanged).
GNN_SHAPES = (
    ShapeSpec(
        "full_graph_sm", "train_graph",
        dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7)),
    ShapeSpec(
        "minibatch_lg", "train_graph",
        dict(n_total_nodes=232965, n_total_edges=114615892, batch_nodes=1024,
             fanouts=(15, 10), d_feat=602, n_classes=41,
             pad_nodes=170496, pad_edges=169984),
        note="sampled-training: the dry-run cell is the sampled block "
        "(1024 seeds × fanout 15·10); the host NeighborSampler feeds it."),
    ShapeSpec(
        "ogb_products", "train_graph",
        dict(n_nodes=2449029, n_edges=61859140, d_feat=100, n_classes=47)),
    ShapeSpec(
        "molecule", "train_graph",
        dict(batch=128, n_nodes=30, n_edges=64, d_feat=28, n_classes=1)),
)


# The recsys shapes (the reference's ``RECSYS_SHAPES``, dims unchanged),
# shared by FM, BERT4Rec, MIND and DIEN.
RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", dict(batch=65536)),
    ShapeSpec("serve_p99", "scores", dict(batch=512, n_candidates=512)),
    ShapeSpec("serve_bulk", "scores", dict(batch=262144, n_candidates=16)),
    ShapeSpec("retrieval_cand", "retrieval",
              dict(batch=1, n_candidates=1_000_000)),
)
