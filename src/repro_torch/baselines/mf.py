"""Model-based CF baselines: RSVD, IRSVD, PMF, SVD++ (paper §4.1 list).

All are trained by minibatch SGD over the COO rating triples: each step
takes ``torch.autograd.grad`` of the loss on one batch of a per-epoch
permutation and moves every parameter by ``p - lr * g`` (the global mean
``mu`` included: it is a trained parameter, and it moves whenever biases
are on).

  RSVD   (Paterek 2007):        r̂ = p_u·q_v
  IRSVD  (Paterek 2007):        r̂ = μ + b_u + b_v + p_u·q_v
  PMF    (Salakhutdinov&Mnih):  MAP of the same model as RSVD with Gaussian priors
  SVD++  (Koren 2008):          r̂ = μ + b_u + b_v + q_v·(p_u + |N(u)|^-½ Σ_{j∈N(u)} y_j)

Randomness goes through ``torch.Generator``: the initial normals from
``cfg.seed`` and one permutation per epoch from ``cfg.seed + 1``, drawn on
the CPU so a seed gives the same run on every device. ``fit_mf(init=,
perms=)`` takes both from the caller instead (the tests feed the JAX
reference's, whose ``jax.random`` streams torch cannot reproduce).

The backward of a gather with repeated rows (``p[u]`` in a batch) sums
in another order on each device: on the card it sorts the row ids first
(bitwise reproducible run to run), on the CPU a large batch accumulates
with atomics across threads (not reproducible in the last bits).
``chip_smoke.py`` holds one epoch on the card to the CPU's within a
stated bound.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class MFParams(NamedTuple):
    p: torch.Tensor  # (U, d)
    q: torch.Tensor  # (P, d)
    bu: torch.Tensor  # (U,)
    bv: torch.Tensor  # (P,)
    y: torch.Tensor  # (P, d) SVD++ implicit item factors (zeros otherwise)
    mu: torch.Tensor  # ()


@dataclasses.dataclass(frozen=True)
class MFConfig:
    n_users: int
    n_items: int
    dim: int = 16
    lr: float = 0.01
    reg: float = 0.05
    epochs: int = 30
    batch: int = 8192
    use_bias: bool = False
    use_implicit: bool = False  # SVD++
    max_hist: int = 64  # padded |N(u)| for SVD++
    seed: int = 0


def mf_params_from_numpy(arrays, device="cuda") -> MFParams:
    """The port's :class:`MFParams` from the reference's, given as numpy
    arrays (any sequence or mapping in ``MFParams`` field order/names)."""
    if isinstance(arrays, dict):
        arrays = [arrays[f] for f in MFParams._fields]
    return MFParams(*(torch.tensor(np.asarray(a, np.float32), device=device)
                      for a in arrays))


def _ids(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def _init(cfg: MFConfig, mu: float, device) -> MFParams:
    g = torch.Generator().manual_seed(cfg.seed)
    s = 1.0 / np.sqrt(cfg.dim)
    # Paterek-style init: biasless models start with p·q ≈ global mean
    base = 0.0 if cfg.use_bias else float(np.sqrt(mu / cfg.dim))

    def normal(rows):
        return torch.randn((rows, cfg.dim), generator=g).to(device)

    return MFParams(
        p=base + normal(cfg.n_users) * 0.1 * s,
        q=base + normal(cfg.n_items) * 0.1 * s,
        bu=torch.zeros(cfg.n_users, device=device),
        bv=torch.zeros(cfg.n_items, device=device),
        y=normal(cfg.n_items) * (s if cfg.use_implicit else 0.0),
        mu=torch.tensor(mu, dtype=torch.float32, device=device),
    )


def _hist_table(users: torch.Tensor, items: torch.Tensor, cfg: MFConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded per-user rated-item lists for SVD++: each user's first
    ``max_hist`` items in input order (-1 pads), and the capped count as
    f32. A stable sort by user gives each rating its rank within its user."""
    users, items = users.long(), items.long()
    dev = users.device
    order = torch.sort(users, stable=True).indices
    su = users[order]
    counts = torch.bincount(users, minlength=cfg.n_users)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(su.shape[0], device=dev) - starts[su]
    keep = rank < cfg.max_hist
    hist = torch.full((cfg.n_users, cfg.max_hist), -1, dtype=torch.int32,
                      device=dev)
    hist[su[keep], rank[keep]] = items[order][keep].to(torch.int32)
    return hist, counts.clamp(max=cfg.max_hist).to(torch.float32)


def _predict_batch(params: MFParams, cfg: MFConfig, u, v, hist=None,
                   hist_len=None) -> torch.Tensor:
    pu = params.p[u]
    if cfg.use_implicit:
        h = hist[u]  # (B, H)
        m = (h >= 0).to(params.p.dtype)[..., None]
        yj = torch.where(m > 0, params.y[h.clamp(min=0).long()],
                         torch.zeros((), dtype=params.y.dtype,
                                     device=params.y.device))
        denom = torch.sqrt(hist_len[u].clamp(min=1.0))[..., None]
        pu = pu + yj.sum(dim=1) / denom
    pred = torch.sum(pu * params.q[v], dim=-1)
    if cfg.use_bias:
        pred = pred + params.mu + params.bu[u] + params.bv[v]
    return pred


def make_loss(cfg: MFConfig, hist=None, hist_len=None):
    def loss(params: MFParams, u, v, r):
        pred = _predict_batch(params, cfg, u, v, hist, hist_len)
        err = torch.mean((pred - r) ** 2)
        reg = (torch.mean(torch.sum(params.p[u] ** 2, -1))
               + torch.mean(torch.sum(params.q[v] ** 2, -1)))
        if cfg.use_bias:
            reg = reg + (torch.mean(params.bu[u] ** 2)
                         + torch.mean(params.bv[v] ** 2))
        if cfg.use_implicit:
            reg = reg + torch.mean(torch.sum(params.y[v] ** 2, -1))
        return err + cfg.reg * reg

    return loss


def fit_mf(users, items, ratings, cfg: MFConfig, *, device="cuda",
           init: Optional[MFParams] = None,
           perms: Optional[Sequence] = None):
    """Train; returns ``(params, aux)`` where aux carries the SVD++ history
    tables. ``init`` replaces the seeded initial parameters and ``perms``
    (``cfg.epochs`` permutations of the ratings) the seeded ones. Each
    epoch takes ``n // batch`` full batches of its permutation; the tail is
    dropped, as the reference drops it."""
    users, items = _ids(users, device), _ids(items, device)
    ratings = torch.as_tensor(ratings, dtype=torch.float32, device=device)
    hist = hist_len = None
    if cfg.use_implicit:
        hist, hist_len = _hist_table(users, items, cfg)
    if init is None:
        init = _init(cfg, float(ratings.mean()), device)
    params = [t.detach().to(device=device, dtype=torch.float32).clone()
              .requires_grad_(True) for t in init]
    loss_fn = make_loss(cfg, hist, hist_len)

    n = users.shape[0]
    steps = max(1, n // cfg.batch)
    g = torch.Generator().manual_seed(cfg.seed + 1)
    for e in range(cfg.epochs):
        perm = (torch.randperm(n, generator=g) if perms is None
                else torch.as_tensor(perms[e])).to(device).long()
        for i in range(steps):
            sl = perm[i * cfg.batch:(i + 1) * cfg.batch]
            loss = loss_fn(MFParams(*params), users[sl], items[sl],
                           ratings[sl])
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            with torch.no_grad():
                for p, gr in zip(params, grads):
                    if gr is not None:  # unused fields: a zero gradient
                        p.sub_(cfg.lr * gr)
    out = MFParams(*(p.detach() for p in params))
    return out, (hist, hist_len)


def predict_mf(params: MFParams, cfg: MFConfig, users, items,
               aux=(None, None)) -> torch.Tensor:
    hist, hist_len = aux
    dev = params.p.device
    with torch.no_grad():
        return _predict_batch(params, cfg, _ids(users, dev), _ids(items, dev),
                              hist, hist_len)


# Named constructors matching the paper's algorithm list ---------------------

def rsvd_config(n_users, n_items, **kw) -> MFConfig:
    return MFConfig(n_users, n_items, use_bias=False, use_implicit=False, **kw)


def irsvd_config(n_users, n_items, **kw) -> MFConfig:
    return MFConfig(n_users, n_items, use_bias=True, use_implicit=False, **kw)


def pmf_config(n_users, n_items, **kw) -> MFConfig:
    # PMF == RSVD objective under MAP; kept separate to mirror the paper's list
    return MFConfig(n_users, n_items, use_bias=False, use_implicit=False,
                    reg=0.02, **kw)


def svdpp_config(n_users, n_items, **kw) -> MFConfig:
    return MFConfig(n_users, n_items, use_bias=True, use_implicit=True, **kw)
