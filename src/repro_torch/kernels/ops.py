"""Dispatch entry points: the CUDA kernel for CUDA tensors, its plain
version (``ref.py``) for CPU tensors.

``masked_similarity`` is a drop-in for
``repro_torch.core.similarity.masked_similarity`` and the default ``sim_fn``
of ``core.landmark_cf.fit`` / ``build_representation`` / ``fold_in``;
``landmark_summary`` computes the B̃V term of
``models.layers.landmark_attention`` (differentiable: its backward is
``landmark_summary_bwd``); ``segment_sum`` sums the GNN's messages in a
fixed order (``kernels/segment_sum.py``).
"""
from __future__ import annotations

from .assign_clusters import assign_clusters
from .ivf_probe import fused_probe_topk
from .landmark_attention import landmark_summary, landmark_summary_bwd
from .masked_similarity import masked_similarity
from .knn_topk import foldin_topk, topk_sim
from .score_candidates import score_candidates
from .segment_sum import segment_sum

# every kernel wrapper of the package; each carries a ``launches`` count,
# a wrapper with more than one kernel a ``route_launches`` count each, and
# d1 its card-side count of guarded results (``results``)
WRAPPERS = (masked_similarity, topk_sim, foldin_topk, assign_clusters,
            fused_probe_topk, score_candidates, landmark_summary,
            landmark_summary_bwd, segment_sum)


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
        if hasattr(fn, "route_launches"):
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)
        if hasattr(fn, "results"):
            fn.results = {}


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


__all__ = ["masked_similarity", "topk_sim", "foldin_topk", "assign_clusters",
           "fused_probe_topk", "score_candidates", "landmark_summary",
           "landmark_summary_bwd", "segment_sum", "WRAPPERS", "reset_launches", "launch_counts"]
