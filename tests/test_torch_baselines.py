"""The port's model-based baselines (``repro_torch.baselines``: RSVD, IRSVD,
PMF, SVD++ and BPMF) against the JAX reference on the CPU.

``jax.random`` cannot be reproduced in torch, so the reference's random
values are fed in: MF's initial parameters and per-epoch permutations
through ``fit_mf(init=, perms=)``, BPMF's standard draws through a
:class:`Replay` of the reference's keys. The port's own random paths are
held to their contracts.

Tolerances: the parity rule, rtol=1e-5, atol=1e-6 (:data:`RTOL`,
:data:`ATOL`), for MF's parameters and predictions after 3 epochs of 9
steps (f32 sums in other orders; the gradient of a gather with repeated
rows accumulates in another order), for BPMF's samplers and for a
2 + 2-sweep chain (batched Cholesky solves and inverses of LAPACK builds of
their own); ``_hist_table``: equal arrays.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import bpmf as jbpmf
from repro.baselines import mf as jmf
from repro_torch.baselines import bpmf, mf

RTOL, ATOL = 1e-5, 1e-6
U, P, N = 60, 40, 600
CONFIGS = {"rsvd": (mf.rsvd_config, jmf.rsvd_config),
           "irsvd": (mf.irsvd_config, jmf.irsvd_config),
           "pmf": (mf.pmf_config, jmf.pmf_config),
           "svdpp": (mf.svdpp_config, jmf.svdpp_config)}


@pytest.fixture(scope="module")
def coo():
    """~600 distinct (user, item) cells with skewed users (so some exceed
    a small ``max_hist``), ratings 1..5, and 100 test pairs."""
    rng = np.random.default_rng(0)
    u_p = 1.0 / np.arange(1, U + 1) ** 0.7
    flat = rng.choice(U * P, N, replace=False,
                      p=np.repeat(u_p / u_p.sum() / P, P))
    users, items = (flat // P).astype(np.int32), (flat % P).astype(np.int32)
    ratings = rng.integers(1, 6, N).astype(np.float32)
    tu = rng.integers(0, U, 100).astype(np.int32)
    ti = rng.integers(0, P, 100).astype(np.int32)
    return users, items, ratings, tu, ti


def _ref_init_and_perms(jcfg, users, ratings):
    """The reference's initial parameters and per-epoch permutations, as
    ``fit_mf`` draws them."""
    mu = float(jnp.asarray(ratings, jnp.float32).mean())
    init = [np.asarray(a) for a in jmf._init(jcfg, mu)]
    keys = jax.random.split(jax.random.PRNGKey(jcfg.seed + 1), jcfg.epochs)
    perms = [np.array(jax.random.permutation(k, len(users))) for k in keys]
    return init, perms


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fit_mf_matches_reference(coo, name):
    users, items, ratings, tu, ti = coo
    port_cfg, ref_cfg = CONFIGS[name]
    kw = dict(dim=4, batch=64, epochs=3, max_hist=8)
    jcfg, cfg = ref_cfg(U, P, **kw), port_cfg(U, P, **kw)
    jparams, jaux = jmf.fit_mf(users, items, ratings, jcfg)
    init, perms = _ref_init_and_perms(jcfg, users, ratings)
    params, aux = mf.fit_mf(users, items, ratings, cfg, device="cpu",
                            init=mf.mf_params_from_numpy(init, "cpu"),
                            perms=perms)
    for field, got, want in zip(mf.MFParams._fields, params, jparams):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL, err_msg=field)
    # every field trained where the reference trains it (mu under biases)
    moved = {f: not np.array_equal(a, np.asarray(b))
             for f, a, b in zip(mf.MFParams._fields, init, jparams)}
    assert moved["mu"] == cfg.use_bias and moved["y"] == cfg.use_implicit
    np.testing.assert_allclose(
        mf.predict_mf(params, cfg, tu, ti, aux).numpy(),
        np.asarray(jmf.predict_mf(jparams, jcfg, tu, ti, jaux)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("max_hist", [1, 5, 64])
def test_hist_table_equals_reference(coo, max_hist):
    users, items, *_ = coo
    jcfg = jmf.svdpp_config(U, P, max_hist=max_hist)
    jh, jl = jmf._hist_table(users, items, jcfg)
    h, ln = mf._hist_table(torch.as_tensor(users), torch.as_tensor(items),
                           mf.svdpp_config(U, P, max_hist=max_hist))
    if max_hist == 5:  # the cap binds for some users, not for all
        counts = np.bincount(users, minlength=U)
        assert (counts > 5).any() and (counts < 5).any()
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(jl))
    assert h.dtype == torch.int32 and ln.dtype == torch.float32


def test_fit_mf_seeded_contracts(coo):
    """The port's own random path: the seed fixes the draws (two runs
    agree at the parity rule: on large batches the CPU's gather backward
    accumulates with atomics across threads), every field is finite and
    shaped, the tail batch of each epoch is dropped."""
    users, items, ratings, tu, ti = coo
    cfg = mf.svdpp_config(U, P, dim=4, batch=64, epochs=2)
    a, aux = mf.fit_mf(users, items, ratings, cfg, device="cpu")
    b, _ = mf.fit_mf(users, items, ratings, cfg, device="cpu")
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)
        assert torch.isfinite(x).all()
    assert a.p.shape == (U, 4) and a.q.shape == (P, 4) and a.mu.shape == ()
    preds = mf.predict_mf(a, cfg, tu, ti, aux)
    assert preds.shape == (100,) and torch.isfinite(preds).all()
    # one step of a batch bigger than the data: max(1, n // batch) steps
    # over a slice that the permutation cannot fill
    one, _ = mf.fit_mf(users, items, ratings,
                       mf.rsvd_config(U, P, dim=4, batch=4096, epochs=1),
                       device="cpu")
    assert torch.isfinite(one.p).all()


# -------------------------------------------------------------------- BPMF
class Replay:
    """The draws interface, replaying values computed from reference keys
    (each checked against the shape the port asks for)."""

    def __init__(self, values):
        self.values = list(values)

    def _next(self, shape):
        v = np.asarray(self.values.pop(0), np.float32)
        assert v.shape == tuple(shape), (v.shape, shape)
        return torch.as_tensor(v)

    def normal(self, shape):
        return self._next(shape)

    def chisquare(self, df):
        return self._next(tuple(df.shape))


def _hyper_draws(key, n, d):
    """What ``_sample_hyper(key, (n, d) factors)`` draws, in order."""
    k1, k2 = jax.random.split(key)
    kw1, kw2 = jax.random.split(k1)
    return [jax.random.chisquare(kw1, (d + n) - jnp.arange(d), shape=(d,)),
            jax.random.normal(kw2, (d, d)), jax.random.normal(k2, (d,))]


def _step_draws(key, cfg):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    d = cfg.dim
    return (_hyper_draws(k1, cfg.n_users, d) + _hyper_draws(k2, cfg.n_items, d)
            + [jax.random.normal(k3, (cfg.n_users, d)),
               jax.random.normal(k4, (cfg.n_items, d))])


def _factors(seed, n, d):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_wishart_matches_reference():
    d, df = 4, 64
    key = jax.random.PRNGKey(3)
    a = np.random.default_rng(1).normal(size=(d, d)).astype(np.float32)
    chol = np.linalg.cholesky(a @ a.T + d * np.eye(d, dtype=np.float32))
    want = jbpmf._wishart(key, jnp.asarray(chol), df, d)
    k1, k2 = jax.random.split(key)
    draws = Replay([jax.random.chisquare(k1, df - jnp.arange(d), shape=(d,)),
                    jax.random.normal(k2, (d, d))])
    _close(bpmf._wishart(draws, torch.as_tensor(chol), df, d), want)


@pytest.mark.parametrize("n", [60, 7])
def test_sample_hyper_matches_reference(n):
    cfg = jbpmf.BPMFConfig(U, P, dim=4)
    key = jax.random.PRNGKey(n)
    f = _factors(n, n, 4)
    mu, lam = jbpmf._sample_hyper(key, jnp.asarray(f), cfg)
    tmu, tlam = bpmf._sample_hyper(Replay(_hyper_draws(key, n, 4)),
                                   torch.as_tensor(f),
                                   bpmf.BPMFConfig(U, P, dim=4))
    _close(tmu, mu)
    _close(tlam, lam)


def test_sample_factors_matches_reference(coo):
    users, items, ratings, *_ = coo
    r = np.zeros((U, P), np.float32)
    r[users, items] = ratings - 3.5
    m = (np.zeros((U, P)) != 0).astype(np.float32)
    m[users, items] = 1.0
    other = _factors(2, P, 4) * 0.3
    mu = np.linspace(-0.2, 0.2, 4).astype(np.float32)
    lam = np.diag([1.5, 2.0, 2.5, 3.0]).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jbpmf._sample_factors(key, jnp.asarray(r), jnp.asarray(m),
                                 jnp.asarray(other), jnp.asarray(mu),
                                 jnp.asarray(lam), 2.0, 4)
    got = bpmf._sample_factors(
        Replay([jax.random.normal(key, (U, 4))]), torch.as_tensor(r),
        torch.as_tensor(m), torch.as_tensor(other), torch.as_tensor(mu),
        torch.as_tensor(lam), 2.0)
    _close(got, want)


def test_fit_predict_bpmf_matches_reference(coo):
    users, items, ratings, tu, ti = coo
    jcfg = jbpmf.BPMFConfig(U, P, dim=4, burnin=2, n_samples=2, seed=7)
    want = jbpmf.fit_predict_bpmf(users, items, ratings, tu, ti, jcfg)
    key = jax.random.PRNGKey(jcfg.seed)
    k1, k2, key = jax.random.split(key, 3)
    values = [jax.random.normal(k1, (U, 4)), jax.random.normal(k2, (P, 4))]
    for k in jax.random.split(key, jcfg.burnin + jcfg.n_samples):
        values += _step_draws(k, jcfg)
    draws = Replay(values)
    got = bpmf.fit_predict_bpmf(
        users, items, ratings, tu, ti,
        bpmf.BPMFConfig(U, P, dim=4, burnin=2, n_samples=2, seed=7),
        device="cpu", draws=draws)
    assert not draws.values  # every draw consumed, in the reference's order
    _close(got, want)


def test_fit_predict_bpmf_seeded_contracts(coo):
    """The port's own draws: fixed by the seed, predictions finite and in
    [1, 5] for every test pair."""
    users, items, ratings, tu, ti = coo
    cfg = bpmf.BPMFConfig(U, P, dim=4, burnin=1, n_samples=3, seed=1)
    a = bpmf.fit_predict_bpmf(users, items, ratings, tu, ti, cfg,
                              device="cpu")
    b = bpmf.fit_predict_bpmf(users, items, ratings, tu, ti, cfg,
                              device="cpu")
    assert torch.equal(a, b) and a.shape == (100,)
    assert torch.isfinite(a).all() and (a >= 1).all() and (a <= 5).all()
    chi2 = bpmf.TorchDraws(0, "cpu").chisquare(torch.tensor([64, 63, 62]))
    assert chi2.shape == (3,) and (chi2 > 0).all()
