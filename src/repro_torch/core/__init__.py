"""Paper core: landmark-accelerated memory-based collaborative filtering."""
from .types import LandmarkSpec, NeighborGraph, RatingMatrix, pad_to, round_up
from .topk import canonical_topk
from .similarity import (
    MEASURES,
    corated_moments,
    dense_similarity,
    full_similarity_matrix,
    masked_similarity,
    similarity_from_distance,
    streaming_knn_graph,
)
from .selection import STRATEGIES, select_landmarks
from .graph import BACKENDS, build_neighbor_graph, extend_neighbor_graph
from . import knn
from .landmark_cf import (
    LandmarkState,
    build_representation,
    fit,
    fit_baseline,
    fold_in,
    predict,
    predict_dense,
)

__all__ = [
    "LandmarkSpec",
    "NeighborGraph",
    "RatingMatrix",
    "LandmarkState",
    "MEASURES",
    "STRATEGIES",
    "BACKENDS",
    "canonical_topk",
    "corated_moments",
    "dense_similarity",
    "full_similarity_matrix",
    "masked_similarity",
    "similarity_from_distance",
    "streaming_knn_graph",
    "select_landmarks",
    "build_neighbor_graph",
    "build_representation",
    "extend_neighbor_graph",
    "fit",
    "fit_baseline",
    "fold_in",
    "predict",
    "predict_dense",
    "knn",
    "pad_to",
    "round_up",
]
