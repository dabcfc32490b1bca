"""Carry a fitted state, a mutable state or an IVF index across frameworks
as numpy arrays.

A state's keys are ``landmark_idx``, ``representation``, ``ratings``,
``graph.indices`` and ``graph.weights``; a mutable state's
(``mutation.MutableState``, its bucketed state padded to its capacity)
add :data:`MUTABLE_KEYS`; an index's are
:data:`IVF_KEYS` (``scale`` only for int8 payloads). The tests build with
the JAX reference, convert with ``numpy.asarray`` under these keys, and
serve from this package, so both packages work on the same artifact.
bfloat16 payload rows travel as their uint16 bits: a numpy ``bfloat16``
array (``ml_dtypes``) is read through its bits, and
:func:`ivf_index_to_numpy` returns the bits with ``rows_dtype`` naming
them.
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


MUTABLE_KEYS = ("landmarks", "tomb", "dirty", "n_valid")


def mutable_state_from_numpy(d: Dict[str, np.ndarray], device="cuda"):
    """A ``mutation.MutableState`` on ``device`` from numpy arrays under
    :data:`KEYS` + :data:`MUTABLE_KEYS` (the state's arrays at capacity)."""
    from ..lifecycle.buckets import BucketedState
    from ..mutation import MutableState

    return MutableState(
        BucketedState(landmark_state_from_numpy(d, device), int(d["n_valid"])),
        torch.tensor(np.asarray(d["landmarks"], np.float32), device=device),
        torch.tensor(np.asarray(d["tomb"], bool), device=device),
        torch.tensor(np.asarray(d["dirty"], bool), device=device))


def mutable_state_to_numpy(mst) -> Dict[str, np.ndarray]:
    """The numpy arrays of a ``mutation.MutableState``, under :data:`KEYS`
    + :data:`MUTABLE_KEYS`."""
    d = landmark_state_to_numpy(mst.bstate.state)
    d.update(landmarks=mst.landmarks.cpu().numpy(),
             tomb=mst.tomb.cpu().numpy(), dirty=mst.dirty.cpu().numpy(),
             n_valid=np.int64(mst.n_valid))
    return d


IVF_KEYS = ("centroids", "lists", "rows", "fill", "scale")


def _rows_from_numpy(rows: np.ndarray, device) -> torch.Tensor:
    if rows.dtype.name == "bfloat16":
        rows = rows.view(np.uint16)
    if rows.dtype == np.uint16:  # bfloat16 bits
        return torch.from_numpy(rows.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(rows, device=device)


def ivf_index_from_numpy(d: Dict[str, np.ndarray], device="cuda"):
    """A ``retrieval.IVFIndex`` on ``device`` from numpy arrays under
    :data:`IVF_KEYS` (``scale`` may be absent or None)."""
    from ..retrieval import IVFIndex

    scale = d.get("scale")
    return IVFIndex(
        torch.tensor(np.asarray(d["centroids"], np.float32), device=device),
        torch.tensor(np.asarray(d["lists"]).astype(np.int32), device=device),
        _rows_from_numpy(np.asarray(d["rows"]), device),
        torch.tensor(np.asarray(d["fill"]).astype(np.int32), device=device),
        None if scale is None else torch.tensor(
            np.asarray(scale, np.float32), device=device))


def ivf_index_to_numpy(index) -> Dict[str, np.ndarray]:
    """The numpy arrays of an index under :data:`IVF_KEYS`, plus
    ``rows_dtype`` (``float32``, ``bfloat16`` — rows as uint16 bits — or
    ``int8``)."""
    rows = index.rows.cpu()
    bf16 = rows.dtype == torch.bfloat16
    return {
        "centroids": index.centroids.cpu().numpy(),
        "lists": index.lists.to(torch.int32).cpu().numpy(),
        "rows": (rows.view(torch.int16).numpy().view(np.uint16) if bf16
                 else rows.numpy()),
        "rows_dtype": "bfloat16" if bf16 else str(rows.numpy().dtype),
        "fill": index.fill.cpu().numpy(),
        "scale": None if index.scale is None else index.scale.cpu().numpy(),
    }
