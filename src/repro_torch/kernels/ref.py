"""Plain PyTorch versions of the port's CUDA kernels.

Each function here computes what its kernel computes, with ordinary tensor
ops. The wrappers in this package take them for CPU tensors (the CPU tests
run them against the JAX reference), and ``chip_smoke.py`` holds every
kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.similarity import EPS, _finalize, _sqrt, corated_moments
from ..core.topk import canonical_topk


def masked_similarity_ref(r_a: torch.Tensor, r_b: torch.Tensor,
                          measure: str = "cosine") -> torch.Tensor:
    """Oracle for kernels.masked_similarity: co-rated similarity (A, B)."""
    return _finalize(measure, *corated_moments(r_a.float(), r_b.float()))


def _row_sums(x: torch.Tensor) -> torch.Tensor:
    """Σ_d x[:, d] added left to right, as the kernel adds."""
    s = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for d in range(x.shape[1]):
        s = s + x[:, d]
    return s


def _row_means(x: torch.Tensor) -> torch.Tensor:
    """The row sums over a tensor of n: a true IEEE division, as the
    kernel's. (Dividing by a Python number lets torch multiply by its
    reciprocal on the card, one rounding more.)"""
    s = _row_sums(x)
    return s / torch.full_like(s, x.shape[1])


def tile_sims(rep: torch.Tensor, cand: torch.Tensor, measure: str
              ) -> torch.Tensor:
    """(rows, C) d2 scores with the measure epilogue of the top-k kernels.

    Cosine expects rows L2-normalized by the caller and is the raw dot
    product; pearson centers the rows, then takes the cosine; euclidean
    is 1/(1+√d²) with d² = |u|² − 2z + |v|². Every sum runs over the
    landmark axis left to right, with a rounding after each multiply and
    each add, and the epilogue uses the same IEEE operations in the same
    order as the kernel, so on the card the two agree bitwise — the
    euclidean epilogue cancels badly for near-duplicate rows, where two
    summation orders could differ by ~1e-3.
    """
    if measure == "pearson":
        rep = rep - _row_means(rep)[:, None]
        cand = cand - _row_means(cand)[:, None]
    z = torch.zeros((rep.shape[0], cand.shape[0]), dtype=rep.dtype,
                    device=rep.device)
    for d in range(rep.shape[1]):
        z = z + rep[:, d, None] * cand[None, :, d]
    if measure == "cosine":
        return z
    nu = _row_sums(rep * rep)[:, None]
    nv = _row_sums(cand * cand)[None, :]
    if measure == "pearson":
        return z / (_sqrt(nu) * _sqrt(nv)).clamp(min=EPS)
    if measure == "euclidean":
        d2 = (nu - 2.0 * z + nv).clamp(min=0.0)
        return 1.0 / (1.0 + _sqrt(d2))
    raise ValueError(f"unknown measure {measure!r}")


def _masked_topk(rep, cand, k, self_offset, n_valid, measure):
    rep, cand = rep.float(), cand.float()
    c = cand.shape[0]
    n_valid = c if n_valid is None else n_valid
    sims = tile_sims(rep, cand, measure)
    col = torch.arange(c, device=rep.device)[None, :]
    invalid = col >= n_valid
    if self_offset is not None:
        row = self_offset + torch.arange(rep.shape[0], device=rep.device)
        invalid = invalid | (col == row[:, None])
    sims = sims.masked_fill(invalid, float("-inf"))
    if c < k:  # fewer candidates than slots: the tail is empty
        sims = torch.cat([sims, sims.new_full((sims.shape[0], k - c),
                                              float("-inf"))], dim=1)
    vals, ids = canonical_topk(sims, k)
    ids = torch.where(torch.isfinite(vals), ids, torch.zeros_like(ids))
    return vals, ids.to(torch.int32)


def topk_sim_ref(rep: torch.Tensor, cand: torch.Tensor, k: int = 14,
                 exclude_self: bool = False, n_valid: Optional[int] = None,
                 measure: str = "cosine"):
    """Oracle for kernels.topk_sim: per rep row, the canonical top-k
    (value desc, id asc) of its d2 scores against ``cand``. Candidates
    ``>= n_valid`` and, with ``exclude_self``, the diagonal are masked;
    empty slots are (-inf, 0)."""
    return _masked_topk(rep, cand, k, 0 if exclude_self else None, n_valid,
                        measure)


def foldin_topk_ref(rep: torch.Tensor, cand: torch.Tensor, k: int = 14,
                    self_offset: Optional[int] = None,
                    n_valid: Optional[int] = None, measure: str = "cosine"):
    """Oracle for kernels.foldin_topk: :func:`topk_sim_ref` where query row
    i is candidate ``self_offset + i`` (None: the queries are not among the
    candidates)."""
    return _masked_topk(rep, cand, k, self_offset, n_valid, measure)
