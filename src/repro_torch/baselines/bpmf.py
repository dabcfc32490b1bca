"""Bayesian PMF via Gibbs sampling (Salakhutdinov & Mnih 2008).

Normal-Wishart hyperpriors over user/item factor means+precisions; the factor
conditionals are Gaussian and sampled exactly. The per-user posterior precision

    Λ_u* = Λ_U + α · Σ_{v∈P_u} q_v q_vᵀ

is computed for *all* users at once as one masked product over the dense
rating block, ``M @ (q_v q_vᵀ)`` with the outer products flattened to
(P, d·d) (never an (N, P, d) temporary), then solved with batched Cholesky.
Wishart draws use the Bartlett decomposition. Everything runs in f32 on the
device of the ratings (TF32 off, as the rest of the port).

Every standard draw (the χ² values, the normals, the multivariate normal's
normal vector) comes from a :class:`Draws` source, in the reference's order
of use: :class:`TorchDraws` takes them from a CPU ``torch.Generator`` seeded
with ``cfg.seed`` (so a seed gives the same chain on every device), and the
tests replay the reference's ``jax.random`` draws through the same calls.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BPMFConfig:
    n_users: int
    n_items: int
    dim: int = 16
    alpha: float = 2.0  # observation precision
    beta0: float = 2.0
    n_samples: int = 24
    burnin: int = 8
    seed: int = 0


class Draws(Protocol):
    """Standard draws, returned as f32 tensors on the sampler's device."""

    def normal(self, shape: Sequence[int]) -> torch.Tensor: ...

    def chisquare(self, df: torch.Tensor) -> torch.Tensor: ...


class TorchDraws:
    """Draws from a CPU ``torch.Generator``, moved to ``device``."""

    def __init__(self, seed: int, device):
        self.generator = torch.Generator().manual_seed(seed)
        self.device = torch.device(device)

    def normal(self, shape):
        return torch.randn(tuple(shape), generator=self.generator).to(
            self.device)

    def chisquare(self, df):
        # χ²(k) = 2 · Gamma(k / 2)
        half = (df.to(torch.float32) / 2.0).cpu()
        return (2.0 * torch._standard_gamma(half, generator=self.generator)
                ).to(self.device)


def _wishart(draws: Draws, scale_chol: torch.Tensor, df: int, dim: int
             ) -> torch.Tensor:
    """Bartlett: W = L A Aᵀ Lᵀ with A lower-tri, diag²~χ², off-diag~N(0,1)."""
    dev = scale_chol.device
    chi2 = draws.chisquare(df - torch.arange(dim, device=dev))
    a = torch.diag(torch.sqrt(chi2))
    tril = torch.tril(draws.normal((dim, dim)), -1)
    la = scale_chol @ (a + tril)
    return la @ la.T


def _sample_hyper(draws: Draws, factors: torch.Tensor, cfg: BPMFConfig):
    """Normal-Wishart posterior for (mu, Lambda) given factor matrix (N, d)."""
    n, d = factors.shape
    dev = factors.device
    eye = torch.eye(d, device=dev)
    xbar = factors.mean(dim=0)
    xc = factors - xbar
    s = (xc.T @ xc) / float(n) + 1e-6 * eye  # np.cov(bias=True)
    beta_post = cfg.beta0 + n
    mu_post = n * xbar / beta_post
    df_post = d + n
    winv = eye + n * s + (cfg.beta0 * n / beta_post) * torch.outer(xbar, xbar)
    w = torch.linalg.inv(winv)
    lam = _wishart(draws, torch.linalg.cholesky(w), df_post, d)
    cov = torch.linalg.inv(beta_post * lam)
    mu = mu_post + torch.linalg.cholesky(cov) @ draws.normal((d,))
    return mu, lam


def _sample_factors(draws: Draws, r: torch.Tensor, m: torch.Tensor,
                    other: torch.Tensor, mu: torch.Tensor, lam: torch.Tensor,
                    alpha: float) -> torch.Tensor:
    """Sample all rows' factors given the other side's factors.

    ``r``: (N, P) centered ratings (0 = missing), oriented so rows are the
    side being sampled; ``m`` its mask; ``other``: (P, d).
    """
    n, p = r.shape
    d = other.shape[1]
    outer = (other[:, :, None] * other[:, None, :]).reshape(p, d * d)
    prec = lam[None] + alpha * (m @ outer).reshape(n, d, d)
    rhs = (lam @ mu)[None] + alpha * (r @ other)
    chol = torch.linalg.cholesky(prec)
    mean = torch.cholesky_solve(rhs[..., None], chol)[..., 0]
    eps = draws.normal((n, d))
    # x = mean + chol^-T eps  (since cov = prec^-1 = (L Lᵀ)^-1)
    delta = torch.linalg.solve_triangular(chol.mT, eps[..., None],
                                          upper=True)[..., 0]
    return mean + delta


def centered_block(users, items, ratings, cfg: BPMFConfig, device):
    """The dense (U, P) block of the COO ratings, centered on their mean
    where rated: ``(centered, mask, mean)``."""
    r = np.zeros((cfg.n_users, cfg.n_items), np.float32)
    r[np.asarray(users), np.asarray(items)] = np.asarray(ratings)
    r = torch.as_tensor(r, device=device)
    m = (r != 0).to(torch.float32)
    mu_r = float(torch.sum(r) / m.sum().clamp(min=1.0))
    return torch.where(m > 0, r - mu_r, torch.zeros_like(r)), m, mu_r


def gibbs_step(draws: Draws, p_f, q_f, rc, m, cfg: BPMFConfig):
    """One sweep: both hyperposteriors, then users, then items."""
    mu_u, lam_u = _sample_hyper(draws, p_f, cfg)
    mu_i, lam_i = _sample_hyper(draws, q_f, cfg)
    p_f = _sample_factors(draws, rc, m, q_f, mu_u, lam_u, cfg.alpha)
    q_f = _sample_factors(draws, rc.T, m.T, p_f, mu_i, lam_i, cfg.alpha)
    return p_f, q_f


def fit_predict_bpmf(users, items, ratings, test_users, test_items,
                     cfg: BPMFConfig, *, device="cuda",
                     draws: Optional[Draws] = None) -> torch.Tensor:
    """Gibbs chain; returns posterior-mean predictions for the test pairs
    (``cfg.burnin`` sweeps dropped, ``cfg.n_samples`` averaged, clipped to
    [1, 5])."""
    draws = draws if draws is not None else TorchDraws(cfg.seed, device)
    rc, m, mu_r = centered_block(users, items, ratings, cfg, device)
    tu = torch.as_tensor(np.asarray(test_users), device=device).long()
    ti = torch.as_tensor(np.asarray(test_items), device=device).long()

    p_f = draws.normal((cfg.n_users, cfg.dim)) * 0.1
    q_f = draws.normal((cfg.n_items, cfg.dim)) * 0.1
    for _ in range(cfg.burnin):  # burn-in: not accumulated
        p_f, q_f = gibbs_step(draws, p_f, q_f, rc, m, cfg)
    acc = torch.zeros(tu.shape, device=device)
    for _ in range(cfg.n_samples):
        p_f, q_f = gibbs_step(draws, p_f, q_f, rc, m, cfg)
        acc = acc + (torch.sum(p_f[tu] * q_f[ti], dim=-1) + mu_r)
    return torch.clamp(acc / max(cfg.n_samples, 1), 1.0, 5.0)
