"""Masked co-rated similarity measures as matrix products (plain PyTorch).

The paper's Algorithms 2 and 4 (scalar triple loops over co-rated items)
decompose into six shared contractions over the item axis:

    z  = (R)(R_L)ᵀ         co-rated dot products          (R has 0 at missing)
    x  = (R²) M_Lᵀ         Σ r_uv² over the co-rated set
    y  = M (R_L²)ᵀ         Σ r_lv² over the co-rated set
    c  = M M_Lᵀ            co-rated counts
    sx = R M_Lᵀ            Σ r_uv  over the co-rated set   (Pearson)
    sy = M R_Lᵀ            Σ r_lv  over the co-rated set   (Pearson)

These functions are the plain versions: ``masked_similarity`` here is the
oracle of the CUDA kernel behind ``repro_torch.kernels.ops``. Products run
in full f32 (callers keep TF32 off), as the reference's
``Precision.HIGHEST`` does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .topk import canonical_topk

EPS = 1e-8
MEASURES = ("cosine", "pearson", "euclidean")


def corated_moments(r_a: torch.Tensor, r_b: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
    """Six co-rated moment matrices between user blocks ``r_a (A,P)``, ``r_b (B,P)``."""
    m_a = (r_a != 0).to(r_a.dtype)
    m_b = (r_b != 0).to(r_b.dtype)
    z = r_a @ r_b.T
    x = (r_a * r_a) @ m_b.T
    y = m_a @ (r_b * r_b).T
    c = m_a @ m_b.T
    sx = r_a @ m_b.T
    sy = m_a @ r_b.T
    return z, x, y, c, sx, sy


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on every device.

    torch's vectorized CPU sqrt is not (it can be one ulp off); the f64 root
    rounded to f32 is, as are XLA's and the card's ``sqrtf``.
    """
    return torch.sqrt(x.double()).to(x.dtype)


def _finalize(measure: str, z, x, y, c, sx, sy) -> torch.Tensor:
    """Apply the measure epilogue. Pairs with <2 co-rated items get 0 (paper Alg. 2).

    The order of operations is the reference's; the CUDA kernel repeats it
    op for op, so on integer ratings (exact moments) the two agree bitwise.
    """
    valid = c > 1
    if measure == "cosine":
        sim = z / (_sqrt(x) * _sqrt(y)).clamp(min=EPS)
    elif measure == "pearson":
        cc = c.clamp(min=1.0)
        cov = z - sx * sy / cc
        var_a = (x - sx * sx / cc).clamp(min=0.0)
        var_b = (y - sy * sy / cc).clamp(min=0.0)
        sim = cov / (_sqrt(var_a) * _sqrt(var_b)).clamp(min=EPS)
    elif measure == "euclidean":
        # distance over the co-rated set; see similarity_from_distance for d2 use.
        sim = _sqrt((x - 2.0 * z + y).clamp(min=0.0))
    else:
        raise ValueError(f"unknown measure {measure!r}")
    return torch.where(valid, sim, torch.zeros_like(sim))


def masked_similarity(r_a: torch.Tensor, r_b: torch.Tensor,
                      measure: str = "cosine") -> torch.Tensor:
    """Pairwise similarity between rows of two rating blocks over co-rated
    items — d1 of the paper (Algorithm 2 for cosine), plain version.
    ``r_b`` is typically the landmark block ``(n, P)``. Returns ``(A, B)``."""
    return _finalize(measure, *corated_moments(r_a, r_b))


def similarity_from_distance(dist: torch.Tensor) -> torch.Tensor:
    """Decreasing positive transform so Euclidean can weight Eq. 1."""
    return 1.0 / (1.0 + dist)


def dense_similarity(u: torch.Tensor, v: torch.Tensor,
                     measure: str = "cosine") -> torch.Tensor:
    """Similarity between *dense* landmark-space vectors (paper Algorithm 4, d2).

    Unlike d1 there is no co-rated masking: every user has all ``n``
    landmark coordinates.
    """
    if measure == "cosine":
        z = u @ v.T
        nu = torch.sqrt(torch.sum(u * u, dim=-1, keepdim=True))
        nv = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        return z / (nu * nv.T).clamp(min=EPS)
    if measure == "pearson":
        uc = u - u.mean(dim=-1, keepdim=True)
        vc = v - v.mean(dim=-1, keepdim=True)
        z = uc @ vc.T
        nu = torch.sqrt(torch.sum(uc * uc, dim=-1, keepdim=True))
        nv = torch.sqrt(torch.sum(vc * vc, dim=-1, keepdim=True))
        return z / (nu * nv.T).clamp(min=EPS)
    if measure == "euclidean":
        sq_u = torch.sum(u * u, dim=-1, keepdim=True)
        sq_v = torch.sum(v * v, dim=-1, keepdim=True)
        d2 = sq_u - 2.0 * (u @ v.T) + sq_v.T
        return similarity_from_distance(torch.sqrt(d2.clamp(min=0.0)))
    raise ValueError(f"unknown measure {measure!r}")


def full_similarity_matrix(ratings: torch.Tensor,
                           measure: str = "cosine") -> torch.Tensor:
    """Baseline (paper Algorithm 1): all-pairs similarity over co-rated items.

    O(|U|²·|P|) — the cost the landmark method removes. Euclidean is
    converted to a similarity so it can weight Eq. 1 directly (validity
    tracked via the co-rated count: distance 0 is a perfect match).
    """
    z, x, y, c, sx, sy = corated_moments(ratings, ratings)
    s = _finalize(measure, z, x, y, c, sx, sy)
    if measure == "euclidean":
        s = torch.where(c > 1, similarity_from_distance(s), torch.zeros_like(s))
    return s


def blocked_masked_similarity(r: torch.Tensor, landmarks: torch.Tensor,
                              measure: str = "cosine", chunk: int = 4096
                              ) -> torch.Tensor:
    """d1 with the kernel's schedule in plain PyTorch: stream item chunks
    and carry the six (U, n) moment accumulators, so temporaries stay one
    (U, chunk) tile whatever |P| is. Zero-padded to a whole number of
    chunks (zero columns add nothing to any moment)."""
    u, p = r.shape
    n_chunks = -(-p // chunk)
    pad = n_chunks * chunk - p
    if pad:
        r = torch.nn.functional.pad(r, (0, pad))
        landmarks = torch.nn.functional.pad(landmarks, (0, pad))
    acc = [r.new_zeros((u, landmarks.shape[0])) for _ in range(6)]
    for c0 in range(0, n_chunks * chunk, chunk):
        moments = corated_moments(r[:, c0:c0 + chunk],
                                  landmarks[:, c0:c0 + chunk])
        acc = [a + m for a, m in zip(acc, moments)]
    return _finalize(measure, *acc)


def streaming_knn_graph(rep: torch.Tensor, measure: str = "cosine",
                        k: int = 14, chunk: int = 8192,
                        exclude_self: bool = False):
    """kNN graph over the landmark representation without the (U, U)
    matrix: scan candidate chunks carrying a running (U, k) top-k.

    Candidates are visited in ascending-id order and each merge puts the
    carried list before the new chunk, so a positional stable top-k is the
    canonical (value desc, id asc) order. ``exclude_self`` masks the
    diagonal so row u never lists itself. Empty slots are (-inf, 0).
    """
    u = rep.shape[0]
    chunk = max(min(chunk, u), min(k, u))
    rows = torch.arange(u, device=rep.device)
    best_v = torch.full((u, k), float("-inf"), dtype=torch.float32,
                        device=rep.device)
    best_i = torch.zeros((u, k), dtype=torch.int32, device=rep.device)
    for c0 in range(0, u, chunk):
        cand = rep[c0:c0 + chunk]
        sims = dense_similarity(rep, cand, measure)
        if exclude_self:
            cand_ids = c0 + torch.arange(cand.shape[0], device=rep.device)
            sims = sims.masked_fill(cand_ids[None, :] == rows[:, None],
                                    float("-inf"))
        v, i = canonical_topk(sims, min(k, cand.shape[0]))
        mv = torch.cat([best_v, v], dim=1)
        mi = torch.cat([best_i, (i + c0).to(torch.int32)], dim=1)
        best_v, sel = canonical_topk(mv, k)
        best_i = mi.gather(1, sel)
    return best_v, best_i
