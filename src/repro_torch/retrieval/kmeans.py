"""k-means coarse quantizer over the (U, n) landmark embedding.

The IVF index's first stage: Lloyd iterations partition the landmark-space
rows into ``n_clusters`` cells so a neighbor search can prune to the
``nprobe`` nearest cells. "Nearest" is measured with the same d2 measure
the neighbor graph uses (for euclidean, 1/(1+d) is decreasing in d, so the
arg-max similarity is the arg-min distance).

``auto`` resolves by the tensor's device. On the card (``kernel``) the
whole of k-means is one launch of the Lloyd kernel
(``kernels/assign_clusters.py::kmeans_lloyd``): the assignment with the
graph-build epilogue, cosine rows normalized once in the kernel, and each
cell's sum over its members in ascending row order. On the CPU
(``plain``) the assignment is the ``dense_similarity`` arg-max and the
sums ``index_add_``, which adds in that same order. Both are
deterministic; the reference's ``segment_sum`` adds in that order too, so
from the same initialization the centroids agree bit for bit wherever the
assignments agree (they may differ at a near tie, since the two score in
another order).

Initialization picks ``n_clusters`` distinct valid rows uniformly (top-k of
uniform keys drawn from a ``torch.Generator``, padded rows masked); the
update is the Euclidean mean of the member rows, with empty clusters
keeping their centroid and padded rows taking no part.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.graph import kernel_rows
from ..core.similarity import dense_similarity
from ..core.topk import canonical_topk
from ..kernels.assign_clusters import assign_clusters as assign_kernel
from ..kernels.assign_clusters import kmeans_lloyd

ASSIGN_BACKENDS = ("plain", "kernel", "auto")


def resolve_assign_backend(backend: str, device) -> str:
    """``auto`` → ``kernel`` for a CUDA ``device``, ``plain`` for a CPU one."""
    if backend == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "plain"
    if backend not in ASSIGN_BACKENDS:
        raise ValueError(f"unknown assignment backend {backend!r}; "
                         f"expected {ASSIGN_BACKENDS}")
    return backend


def assign_clusters(rep: torch.Tensor, centroids: torch.Tensor,
                    measure: str = "cosine", backend: str = "auto"
                    ) -> torch.Tensor:
    """(U,) int32 nearest-centroid id per row under the d2 ``measure``,
    ties to the lowest centroid id. Inputs are raw rows: the ``kernel``
    backend L2-normalizes them itself for cosine."""
    backend = resolve_assign_backend(backend, rep.device)
    if backend == "kernel":
        return assign_kernel(kernel_rows(rep, measure),
                             kernel_rows(centroids, measure), measure)
    sims = dense_similarity(rep.float(), centroids.float(), measure)
    return canonical_topk(sims, 1)[1][:, 0].to(torch.int32)


def init_centroids(generator: torch.Generator, rep: torch.Tensor,
                   n_clusters: int, n_valid: Optional[int] = None
                   ) -> torch.Tensor:
    """``n_clusters`` distinct valid rows, chosen uniformly (rows repeat only
    when there are fewer rows than clusters)."""
    u = rep.shape[0]
    keys = torch.rand(u, generator=generator).to(rep.device)
    if n_valid is not None:
        keys = torch.where(torch.arange(u, device=rep.device) < n_valid,
                           keys, torch.full_like(keys, -1.0))
    _, idx = canonical_topk(keys, min(n_clusters, u))
    cent = rep[idx]
    if n_clusters > u:  # degenerate tiny-U case: repeat the first row
        cent = torch.cat([cent, cent[:1].expand(n_clusters - u, -1)])
    return cent.to(torch.float32)


def kmeans(rep: torch.Tensor, n_clusters: int, measure: str = "cosine",
           iters: int = 8, n_valid: Optional[int] = None,
           backend: str = "auto", *,
           generator: Optional[torch.Generator] = None,
           init: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's algorithm: ``(centroids (C, n), assign (U,))``.

    ``init`` gives the starting centroids (else :func:`init_centroids`
    draws them from ``generator``, default seeded 0). ``assign`` is the
    final nearest-centroid id per row; rows ``>= n_valid`` are padding and
    get an arbitrary cluster that callers must mask.
    """
    u = rep.shape[0]
    dev = rep.device
    rep32 = rep.to(torch.float32).contiguous()
    if init is None:
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        init = init_centroids(gen, rep32, n_clusters, n_valid)
    cent = init.to(device=dev, dtype=torch.float32).contiguous()
    if resolve_assign_backend(backend, dev) == "kernel":
        return kmeans_lloyd(rep32, cent, iters, n_valid, measure)
    valid = (torch.arange(u, device=dev) < n_valid) if n_valid is not None \
        else torch.ones(u, dtype=torch.bool, device=dev)
    vrep = rep32 * valid[:, None]
    ones = valid.to(torch.float32)
    for _ in range(iters):
        a = assign_clusters(rep32, cent, measure, "plain")
        seg = torch.where(valid, a.long(), torch.full_like(a.long(),
                                                           n_clusters))
        sums = torch.zeros((n_clusters + 1, rep.shape[1]), device=dev
                           ).index_add_(0, seg, vrep)[:-1]
        cnt = torch.zeros(n_clusters + 1, device=dev).index_add_(
            0, seg, ones)[:-1]
        cent = torch.where(cnt[:, None] > 0,
                           sums / cnt.clamp(min=1.0)[:, None], cent)
    return cent, assign_clusters(rep32, cent, measure, "plain")
