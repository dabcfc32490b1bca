"""Carry a fitted state across frameworks as numpy arrays.

The keys are ``landmark_idx``, ``representation``, ``ratings``,
``graph.indices`` and ``graph.weights``. The tests fit with the JAX
reference, convert its state with ``numpy.asarray`` under these keys, and
serve it from this package, so both serve from the same fitted state.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .landmark_cf import LandmarkState
from .types import NeighborGraph

KEYS = ("landmark_idx", "representation", "ratings", "graph.indices",
        "graph.weights")


def landmark_state_from_numpy(d: Dict[str, np.ndarray], device="cuda"
                              ) -> LandmarkState:
    """A graph-backed :class:`LandmarkState` on ``device`` from numpy arrays."""
    t = {key: torch.tensor(np.asarray(d[key]), device=device) for key in KEYS}
    return LandmarkState(
        t["landmark_idx"].to(torch.int64), t["representation"], t["ratings"],
        graph=NeighborGraph(t["graph.indices"].to(torch.int32),
                            t["graph.weights"].to(torch.float32)))


def landmark_state_to_numpy(state: LandmarkState) -> Dict[str, np.ndarray]:
    """The numpy arrays of a graph-backed state, under :data:`KEYS`."""
    if state.graph is None:
        raise ValueError("only graph-backed states carry across")
    g = state.graph.to_full()
    return {
        "landmark_idx": state.landmark_idx.cpu().numpy(),
        "representation": state.representation.cpu().numpy(),
        "ratings": state.ratings.cpu().numpy(),
        "graph.indices": g.indices.cpu().numpy(),
        "graph.weights": g.weights.cpu().numpy(),
    }
