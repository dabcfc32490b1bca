"""Canonical top-k: value descending, then id ascending.

Every neighbor list, landmark pick and top-N list of the port is stored in
this order. The JAX reference gets it from ``lax.top_k``, which breaks ties
toward the lowest index. ``torch.topk`` promises no order among ties, so the
port builds the order from stable sorts instead.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def canonical_topk(values: torch.Tensor, k: int, dim: int = -1,
                   ids: Optional[torch.Tensor] = None,
                   rank: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best entries of ``values`` along ``dim``: value descending,
    ties to the lowest id.

    ``ids`` (same shape as ``values``) names each entry; when it is None the
    position along ``dim`` is the id, and the returned ids are int64
    positions. With ``ids``, a stable sort by id runs first, so that the
    stable descending sort by value that follows leaves equal values in
    ascending-id order. ``rank`` (same shape) breaks the ties in its place:
    on a mesh, sharded ids do not follow the logical arrival order that
    the single-device ids do, so ties go to the lowest logical rank there.
    Returns ``(values, ids)``.
    """
    m = values.shape[dim]
    if k > m:
        raise ValueError(f"k={k} exceeds the {m} candidates along dim {dim}")
    if ids is not None:
        key = ids if rank is None else rank
        by_id = torch.sort(key, dim=dim, stable=True).indices
        values = values.gather(dim, by_id)
        ids = ids.gather(dim, by_id)
    sel = torch.sort(values, dim=dim, descending=True,
                     stable=True).indices.narrow(dim, 0, k)
    return values.gather(dim, sel), (sel if ids is None
                                     else ids.gather(dim, sel))


def list_mismatches(ref_vals, ref_ids, vals, ids, rtol: float = 1e-5,
                    atol: float = 1e-6) -> np.ndarray:
    """Rows where two canonical (rows, k) top-k lists disagree beyond the
    tie rule; an empty array means they agree.

    Two lists agree when their values match slot by slot within tolerance,
    every id in both lists carries values that match within tolerance, and
    every id in only one list has a value within tolerance of the
    reference's cut-off (its k-th value): two implementations that round
    differently may break a tie at the cut either way. Arguments are numpy
    arrays (or tensors, which are copied to the host).
    """
    ref_vals, ref_ids, vals, ids = (
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in (ref_vals, ref_ids, vals, ids))

    def close(a, b):
        return np.isclose(a, b, rtol=rtol, atol=atol) | (a == b)

    bad = ~close(ref_vals, vals).all(axis=1)
    for r in np.flatnonzero(~bad):
        if (ref_ids[r] == ids[r]).all():
            continue
        ref_w = dict(zip(ref_ids[r].tolist(), ref_vals[r].tolist()))
        got_w = dict(zip(ids[r].tolist(), vals[r].tolist()))
        cut = ref_vals[r, -1]
        for i in ref_w.keys() | got_w.keys():
            if i in ref_w and i in got_w:
                ok = close(ref_w[i], got_w[i])
            else:
                ok = close(ref_w.get(i, got_w.get(i)), cut)
            if not ok:
                bad[r] = True
                break
    return np.flatnonzero(bad)
