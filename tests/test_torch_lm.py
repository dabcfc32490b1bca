"""The port's LM, dense and MoE, against the JAX reference, on the CPU.

The models: the smoke models of the three dense archs (``gemma-7b``
covers GeGLU and the embedding scale, ``smollm-360m`` tied embeddings and
G = 3 grouped queries, ``llama3-405b`` untied embeddings), SmolLM-360M at
its full widths (d_model 960, 15/5 heads, d_ff 2560, vocab 49152) cut to
two layers, and the smoke models of the two MoE archs
(``deepseek-moe-16b``: 8 routed experts, top 2, 2 shared, G = 1;
``dbrx-132b``: 4 experts, top 2, no shared, G = 2; groups of 16 tokens,
so capacity drops occur). The reference's ``init_lm`` makes the
parameters; both packages run them (``models.convert``). The landmark
backend uses n_landmarks = 8 at S = 32 (the reference takes it only when
S > n_landmarks). Landmark decode starts from the reference's own random
landmark keys and queries, as its serve CLI makes them.

Tolerances:
- f32 (``dtype=float32`` on both sides): atol=rtol=1e-4 on logits, the loss,
  caches and landmark state — the same algorithm in f32 with sums in
  another order (the largest difference seen is ~1e-5);
- f32 with the int8 cache (``kv_quant``): codes within one step of the
  reference's, at most 0.1% of them off, and logits within 5e-3. A code
  flips where x/scale lands within an f32 ulp of a half after sums in
  another order (1 of 20480 codes at full width), and one int8 step
  (max|x|/127) then moves logits by ~1e-3. In bf16 the keys themselves
  differ by bf16 ulps, so the dequantized cache is held to the bf16 bound
  below;
- bf16, the configs' own dtype: logits within 0.15, the reference's own
  bound between a bf16 decode step and the forward pass
  (``tests/test_archs_smoke.py``). bf16 rounds after every product, and
  torch and XLA round elementwise ops (silu, the residual adds) at
  different points; differences seen: up to 0.055;
- the bf16 loss: rtol 1e-2 — a mean of B·S cross-entropies, so the logit
  differences above average out (seen: up to 5.6e-4);
- bf16 with the landmark backend: logits within 5% of the largest logit.
  The reference rounds the B̃ scores and probabilities to bf16 before PV;
  the summary (kernel and plain version alike) keeps them in f32, as the
  reference's Pallas kernel does. Differences seen: up to 2.8%;
- the MoE aux loss (summed over layers): f32 within 1e-4; bf16 rtol 1e-2,
  as the loss: the router runs in f32, but on bf16 inputs that round at
  other points (seen: up to 0.22%).

MoE routing (the ROADMAP tie rule, for expert ids): the reference's run
logs each MoE call's router probabilities and expert ids
(``_RoutingLog``), and the port's router replays them (``_Replay``): in
f32 the port's own ids must equal the reference's; in bf16 an id may
differ only at a near-tie, where the reference's own probabilities of the
two experts differ by at most 2^-5 of its probability at its own expert
(the gap of ``repro_torch.models.layers.route_flips``, which
``chip_smoke.py`` holds to its own limit; ``TIE_REL``; with the landmark
backend, whose attention differs from the reference's by up to
``BF16_LANDMARK_REL``, by at most that). The outputs are then compared
under the bounds above on the reference's routing. The bf16 MoE cases do
show it: up to 8 ids a test differ, at relative gaps of 0.0005–0.017
(full attention) and up to 0.031 (landmark); without the replay such a
flip moves logits by up to 0.56. f32 shows none.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import collections
import contextlib
import dataclasses
import functools
import itertools
import re
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import registry as jregistry
from repro.data import synthetic as jsynthetic
from repro.distributed.sharding import DEFAULT_RULES
from repro.models import transformer as J

from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import (lm_from_numpy, lm_to_numpy,
                                        tensor_from_numpy)

F32_TOL = 1e-4
QUANT_TOL, QUANT_FLIPS = 5e-3, 1e-3
BF16_ATOL = 0.15
BF16_LANDMARK_REL = 0.05
TIE_REL = 2 ** -5
AUX_BF16_RTOL = 1e-2
B, S, PROMPT, STEPS = 2, 32, 8, 8  # batch, forward length, prompt, steps

# (arch, full widths cut to two layers)
MODELS = [("smollm-360m", False), ("gemma-7b", False), ("llama3-405b", False),
          ("smollm-360m", True), ("deepseek-moe-16b", False),
          ("dbrx-132b", False)]
IDS = ["smollm-smoke", "gemma-smoke", "llama3-smoke", "smollm-full-2L",
       "deepseek-smoke", "dbrx-smoke"]


def _configs(name, full, f32):
    jc = jregistry.get(name).model if full else jregistry.get(name).smoke_model
    tc = registry.get(name).model if full else registry.get(name).smoke_model
    over = dict(n_landmarks=8)
    if full:
        over["n_layers"] = 2
    jc = dataclasses.replace(jc, **over,
                             **({"dtype": jnp.float32} if f32 else {}))
    tc = dataclasses.replace(tc, **over,
                             **({"dtype": torch.float32} if f32 else {}))
    return jc, tc


class _RoutingLog:
    """The reference's ``moe_ffn`` calls, logged: its routing steps again
    beside the call, and their router probabilities and expert ids passed
    to the host. ``stage`` names the part being traced; each call site
    takes a number in trace order, and its callbacks append in run order
    (a layer scan's in layer order)."""

    def __init__(self):
        self.stage, self.sites, self.calls = None, itertools.count(), []

    def wrap(self, moe_ffn):
        def wrapped(x, router_w, w1, w3, w2, top_k, capacity_factor=1.25,
                    group_size=512, act="silu", rules=None):
            b, s, d = x.shape
            n_sub = max(1, s // group_size)
            xg = x.reshape(b * n_sub, s // n_sub, d)
            probs = jax.nn.softmax(jnp.einsum(
                "gsd,de->gse", xg.astype(jnp.float32),
                router_w.astype(jnp.float32)), axis=-1)
            ids = jax.lax.top_k(probs, top_k)[1]
            site = (self.stage, next(self.sites))
            jax.debug.callback(lambda p, i: self.calls.append(
                (site, np.asarray(p), np.asarray(i))), probs, ids)
            return moe_ffn(x, router_w, w1, w3, w2, top_k,
                           capacity_factor=capacity_factor,
                           group_size=group_size, act=act, rules=rules)

        return wrapped

    def by_stage(self):
        out = collections.defaultdict(list)
        for (stage, _), p, i in sorted(self.calls, key=lambda c: c[0][1]):
            out[stage].append((p, i))
        return dict(out)


@functools.lru_cache(maxsize=None)
def reference(name, full, f32):
    """Everything the tests compare, from the reference, as numpy: one jit
    per model, so each compiles once. For an MoE model also its routing:
    per stage, each MoE call's (router probabilities, expert ids) in
    order."""
    jc, _ = _configs(name, full, f32)
    jl = dataclasses.replace(jc, attn_backend="landmark")
    jq = dataclasses.replace(jc, kv_quant=True)
    params = J.init_lm(jax.random.PRNGKey(0), jc)
    batch = {k: jnp.asarray(v) for k, v in
             jsynthetic.lm_batch(0, 0, B, S, jc.vocab).items()}
    lm_cache = J.make_landmark_cache(jc, B)
    lm_cache["k_lm"] = jax.random.normal(jax.random.PRNGKey(1),
                                         lm_cache["k_lm"].shape, jc.dtype)
    lm_cache["q_lm"] = jax.random.normal(jax.random.PRNGKey(2),
                                         lm_cache["q_lm"].shape, jc.dtype)

    log = _RoutingLog()

    @jax.jit
    def run(params, batch, lm_cache):
        toks = batch["tokens"]
        out = {}
        log.stage = "logits"
        out["logits"], out["aux"] = J.lm_forward(params, toks, jc,
                                                 DEFAULT_RULES)
        log.stage = "logits_landmark"
        out["logits_landmark"], out["aux_landmark"] = J.lm_forward(
            params, toks, jl, DEFAULT_RULES)
        log.stage = "loss"
        out["loss"] = J.lm_loss(params, batch, jc, DEFAULT_RULES)
        log.stage = "loss_landmark"
        out["loss_landmark"] = J.lm_loss(params, batch, jl, DEFAULT_RULES)
        log.stage = "decode_exact"
        logits, cache = J.lm_prefill(params, toks[:, :PROMPT], jc,
                                     DEFAULT_RULES, max_seq=PROMPT + STEPS)
        steps = [logits]
        for t in range(PROMPT, PROMPT + STEPS):
            logits, cache = J.lm_decode_step(params, cache, toks[:, t:t + 1],
                                             jc, DEFAULT_RULES)
            steps.append(logits)
        out["decode_exact"] = jnp.concatenate(steps, 1)
        out["cache_exact"] = cache
        # int8 cache: from empty, as test_int8_kv_cache_decode_close_to_exact
        log.stage = "decode_quant"
        steps, cache = [], J.make_cache(jq, B, STEPS)
        for t in range(STEPS):
            logits, cache = J.lm_decode_step(params, cache, toks[:, t:t + 1],
                                             jq, DEFAULT_RULES)
            steps.append(logits)
        out["decode_quant"] = jnp.concatenate(steps, 1)
        out["cache_quant"] = cache
        log.stage = "decode_landmark"
        steps, cache = [], lm_cache
        for t in range(STEPS):
            logits, cache = J.lm_landmark_decode_step(
                params, cache, toks[:, t:t + 1], jc, DEFAULT_RULES)
            steps.append(logits)
        out["decode_landmark"] = jnp.concatenate(steps, 1)
        out["cache_landmark"] = cache
        return out

    with mock.patch.object(J, "moe_ffn", log.wrap(J.moe_ffn)):
        out = run(params, batch, lm_cache)
        jax.effects_barrier()
    to_np = functools.partial(jax.tree.map, lambda a: np.asarray(a,
                                                                 np.float32))
    return (jax.tree.map(np.asarray, params), to_np(out),
            to_np({"k_lm": lm_cache["k_lm"], "q_lm": lm_cache["q_lm"]}),
            jax.tree.map(np.asarray, batch), log.by_stage())


class _Replay:
    """Route the port's MoE calls as the reference routed them (the ROADMAP
    tie rule, for routing). Each call of the port's router takes the next
    reference call of the current ``stage`` and checks its own expert ids
    against the reference's: in f32 they must be equal; in bf16 an id may
    differ only where the reference's own probabilities of the two experts
    lie within ``tie_rel`` of each other (a near-tie that bf16 rounding of
    the router's input decides). Then the reference's ids and the port's
    probabilities at them, renormalized, go on, so the model's outputs are
    compared on one routing. ``flips`` lists the differing ids seen:
    (stage, call, token, k, reference id, port id, relative gap)."""

    def __init__(self, routes, f32, tie_rel):
        self.routes, self.f32, self.tie_rel = routes, f32, tie_rel
        self.queue, self.flips, self.stage = [], [], None

    def set_stage(self, stage):
        assert not self.queue, f"{len(self.queue)} reference calls left"
        self.stage, self.queue = stage, list(self.routes.get(stage, []))

    def router(self, xt, router_w, top_k):
        probs, _, idx = self.port_router(xt, router_w, top_k)
        ref_p, ref_i = self.queue.pop(0)
        call = len(self.routes[self.stage]) - len(self.queue) - 1
        ref_p = torch.from_numpy(ref_p.reshape(-1, ref_p.shape[-1]))
        ref_i = torch.from_numpy(ref_i.reshape(-1, top_k)).long()
        at, gaps = L.route_flips(idx, ref_p, ref_i)
        for (t, k), gap in zip(at.tolist(), gaps.tolist()):
            self.flips.append((self.stage, call, t, k, int(ref_i[t, k]),
                               int(idx[t, k]), gap))
        return probs, L.replayed_gates(probs, ref_i), ref_i

    def check(self):
        assert not self.queue, f"{len(self.queue)} reference calls left"
        if self.f32:
            assert not self.flips, self.flips
        for flip in self.flips:
            assert flip[-1] <= self.tie_rel, flip


@contextlib.contextmanager
def _replaying(routes, f32, tie_rel=TIE_REL):
    rep = _Replay(routes, f32, tie_rel)
    rep.port_router = L._router
    with mock.patch.object(L, "_router", rep.router):
        yield rep
    rep.check()


def _port(name, full, f32):
    params, want, lm_keys, batch, routes = reference(name, full, f32)
    _, tc = _configs(name, full, f32)
    return lm_from_numpy(params, tc, "cpu"), want, lm_keys, batch, routes


def _close(got, want, f32, landmark=False, atol=F32_TOL):
    got = got.detach().float().numpy()
    if f32:
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=atol)
    elif landmark:
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert rel < BF16_LANDMARK_REL, rel
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)


@pytest.fixture(params=[True, False], ids=["f32", "bf16"])
def f32(request):
    return request.param


@pytest.mark.parametrize("name,full", MODELS, ids=IDS)
@pytest.mark.parametrize("backend", ["full", "landmark"])
def test_forward_and_loss_match_reference(name, full, f32, backend):
    model, want, _, batch, routes = _port(name, full, f32)
    model.cfg = dataclasses.replace(model.cfg, attn_backend=backend)
    tag = "" if backend == "full" else "_landmark"
    tokens = torch.from_numpy(batch["tokens"].copy())
    tie = BF16_LANDMARK_REL if tag else TIE_REL
    with torch.no_grad(), _replaying(routes, f32, tie) as rep:
        rep.set_stage("logits" + tag)
        logits, aux = T.lm_forward(model, tokens)
        rep.set_stage("loss" + tag)
        loss = T.lm_loss(model, {k: torch.from_numpy(v.copy())
                                 for k, v in batch.items()})
    assert logits.shape == (B, S, model.cfg.vocab)
    if model.cfg.moe is None:
        assert aux == 0.0
    else:  # the GShard aux summed over layers, from the f32 router
        np.testing.assert_allclose(float(aux), want["aux" + tag],
                                   rtol=F32_TOL if f32 else AUX_BF16_RTOL)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    _close(logits, want["logits" + tag], f32, landmark=bool(tag))
    # the loss is a mean over B·S positions: bf16 logit differences average
    np.testing.assert_allclose(float(loss), want["loss" + tag],
                               rtol=F32_TOL if f32 else 1e-2)


@pytest.mark.parametrize("name,full", MODELS, ids=IDS)
@pytest.mark.parametrize("quant", [False, True], ids=["exact", "kv_quant"])
def test_prefill_and_decode_match_reference(name, full, f32, quant):
    """Exact cache: prefill 8 tokens, then 8 decode steps. int8 cache
    (``kv_quant``): 8 steps from an empty cache. Logits of each step, and
    the cache after the last (int8 codes within one step of the
    reference's, scales within the f32 tolerance)."""
    model, want, _, batch, routes = _port(name, full, f32)
    cfg = dataclasses.replace(model.cfg, kv_quant=quant)
    model.cfg = cfg
    toks = torch.from_numpy(batch["tokens"].copy())
    tag = "quant" if quant else "exact"
    with torch.no_grad(), _replaying(routes, f32) as rep:
        rep.set_stage(f"decode_{tag}")
        if quant:
            steps, cache, t0 = [], T.make_cache(cfg, B, STEPS, "cpu"), 0
            assert cache["k"].dtype == torch.int8
        else:
            logits, cache = T.lm_prefill(model, toks[:, :PROMPT],
                                         max_seq=PROMPT + STEPS)
            steps, t0 = [logits], PROMPT
        assert cache["k"].shape == (cfg.n_layers, B, t0 + STEPS,
                                    cfg.n_kv_heads, cfg.head_dim)
        for t in range(t0, t0 + STEPS):
            logits, cache = T.lm_decode_step(model, cache, toks[:, t:t + 1])
            steps.append(logits)
    _close(torch.cat(steps, 1), want[f"decode_{tag}"], f32,
           atol=QUANT_TOL if quant else F32_TOL)
    ref_cache = want[f"cache_{tag}"]
    assert int(cache["length"]) == int(ref_cache["length"]) == t0 + STEPS
    for key in ("k", "v"):
        if quant and f32:
            off = np.abs(cache[key].float().numpy() - ref_cache[key])
            assert off.max() <= 1 and (off > 0).mean() <= QUANT_FLIPS
            _close(cache[f"{key}_scale"], ref_cache[f"{key}_scale"], True)
        elif quant:  # bf16 keys differ by bf16 ulps: compare what is read
            _close(T._kv_dequantize(cache[key], cache[f"{key}_scale"],
                                    torch.float32),
                   ref_cache[key] * ref_cache[f"{key}_scale"][..., None],
                   False)
        else:
            _close(cache[key], ref_cache[key], f32)


@pytest.mark.parametrize("name,full", MODELS, ids=IDS)
def test_landmark_decode_matches_reference(name, full, f32):
    """8 steps of O(n) landmark decode from the reference's random landmark
    keys/queries: logits of each step and the final m/z/s state."""
    model, want, lm_keys, batch, routes = _port(name, full, f32)
    cfg = model.cfg
    cache = T.make_landmark_cache(cfg, B, "cpu")
    for key in ("k_lm", "q_lm"):
        cache[key] = tensor_from_numpy(lm_keys[key], cfg.dtype, "cpu")
    toks = torch.from_numpy(batch["tokens"].copy())
    steps = []
    with torch.no_grad(), _replaying(routes, f32) as rep:
        rep.set_stage("decode_landmark")
        for t in range(STEPS):
            logits, cache = T.lm_landmark_decode_step(model, cache,
                                                      toks[:, t:t + 1])
            steps.append(logits)
    _close(torch.cat(steps, 1), want["decode_landmark"], f32)
    ref_cache = want["cache_landmark"]
    assert int(cache["length"]) == STEPS
    if f32:
        for key in ("m", "z", "s"):
            _close(cache[key], ref_cache[key], True)


def test_param_counts_match_reference_and_published():
    """The published totals (±6%, as ``test_published_param_counts``), and
    the reference's own total and active counts for each arch."""
    for name, expect in [("llama3-405b", 405e9), ("smollm-360m", 360e6),
                         ("gemma-7b", 8.5e9), ("deepseek-moe-16b", 16.4e9),
                         ("dbrx-132b", 132e9)]:
        got, want = registry.get(name).model, jregistry.get(name).model
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert abs(got.param_count() - expect) / expect < 0.06, (name, got,
                                                                 expect)
    assert registry.get("deepseek-moe-16b").model.param_count() == (
        16_879_568_896)
    assert registry.get("deepseek-moe-16b").model.active_param_count() == (
        2_830_747_648)
    assert registry.get("dbrx-132b").model.param_count() == 131_596_523_520
    for name in ("smollm-360m", "deepseek-moe-16b", "dbrx-132b"):
        cfg = registry.get(name).smoke_model
        model = T.init_lm(cfg, device="cpu")
        assert sum(p.numel() for p in model.parameters()) == (
            cfg.param_count())


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "dbrx-132b"])
def test_moe_configs_match_reference_field_for_field(name):
    for which in ("model", "smoke_model"):
        got = getattr(registry.get(name), which)
        want = getattr(jregistry.get(name), which)
        assert dataclasses.asdict(got.moe) == dataclasses.asdict(want.moe)
        for f in dataclasses.fields(got):
            if f.name not in ("moe", "dtype"):
                assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert registry.get(name).source == jregistry.get(name).source


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "dbrx-132b"],
                         ids=["deepseek-smoke", "dbrx-smoke"])
def test_moe_parameters_round_trip_exactly(name):
    """``lm_from_numpy`` / ``lm_to_numpy`` carry the router, the routed
    experts and the shared experts across, bit for bit, in the reference's
    key order and shapes."""
    jc = jregistry.get(name).smoke_model
    params = jax.tree.map(np.asarray, J.init_lm(jax.random.PRNGKey(5), jc))
    model = lm_from_numpy(params, registry.get(name).smoke_model, "cpu")
    keys = [n for n, _ in model.layers[0].named_parameters()]
    assert keys == list(J._layer_shapes(jc))
    assert {"router", "ew1", "ew3", "ew2"} <= set(keys)
    assert ({"sw1", "sw3", "sw2"} <= set(keys)) == bool(jc.moe.n_shared)
    back = lm_to_numpy(model)
    assert jax.tree.map(np.shape, back) == jax.tree.map(np.shape, params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b.astype(np.float32))


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "dbrx-132b"],
                         ids=["deepseek-smoke", "dbrx-smoke"])
def test_moe_decode_step_tracks_the_forward(name):
    """The reference's decode-vs-forward check for MoE
    (``tests/test_archs_smoke.py::test_lm_smoke_decode``), on the port in
    bf16: at the config's capacity the single-token decode group
    (capacity 1, never dropped) legitimately differs from the packed
    forward group (the known GShard train/serve gap), so only a
    correlation > 0.8; at a capacity where no group drops a token, within
    the dense archs' 0.15."""
    cfg = registry.get(name).smoke_model
    model = T.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.as_tensor(synthetic.lm_batch(0, 0, 2, 16, cfg.vocab)[
        "tokens"])
    ample = dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.n_experts
                                / cfg.moe.top_k)
    for moe in (cfg.moe, ample):
        model.cfg = dataclasses.replace(cfg, moe=moe)
        with torch.no_grad():
            logits_pre, cache = T.lm_prefill(model, toks[:, :8], max_seq=16)
            dec, cache = T.lm_decode_step(model, cache, toks[:, 8:9])
            full, _ = T.lm_forward(model, toks[:, :9])
        assert logits_pre.shape == (2, 1, cfg.vocab)
        assert int(cache["length"]) == 9
        a, b = dec[:, 0].float().numpy(), full[:, -1].float().numpy()
        if moe is ample:
            np.testing.assert_allclose(a, b, rtol=0, atol=BF16_ATOL)
        else:
            assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.8


def test_init_lm_layout_round_trips_to_the_reference():
    """``init_lm`` draws from its generator (same seed, same weights), in
    the reference's layout: its weights, carried back with
    ``lm_to_numpy``, give the reference the port's logits."""
    _, tc = _configs("gemma-7b", False, True)
    jc, _ = _configs("gemma-7b", False, True)
    a = T.init_lm(tc, torch.Generator().manual_seed(3), "cpu")
    b = T.init_lm(tc, torch.Generator().manual_seed(3), "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    tree = lm_to_numpy(a)
    shapes = jax.tree.map(np.shape, J.init_lm(jax.random.PRNGKey(0), jc))
    assert jax.tree.map(np.shape, tree) == shapes
    toks = synthetic.lm_batch(0, 1, B, S, tc.vocab)["tokens"]
    want, _ = J.lm_forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks),
                           jc, DEFAULT_RULES)
    with torch.no_grad():
        got, _ = T.lm_forward(a, torch.as_tensor(toks))
    _close(got, np.asarray(want), True)


def test_lm_batch_is_byte_identical_to_the_reference():
    for args in [(0, 0, 2, 4096, 49152), (3, 7, 5, 33, 512)]:
        a, b = synthetic.lm_batch(*args), jsynthetic.lm_batch(*args)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype
            assert np.array_equal(a[key], b[key])


# the dense default arch keeps its ids (False, True); the MoE archs' smoke
# models, exact KV and landmark decode
@pytest.mark.parametrize("arch,landmark", [
    ("smollm-360m", False), ("smollm-360m", True),
    ("deepseek-moe-16b", False), ("deepseek-moe-16b", True),
    ("dbrx-132b", False), ("dbrx-132b", True)], ids=[
    "False", "True", "deepseek-exact", "deepseek-landmark", "dbrx-exact",
    "dbrx-landmark"])
def test_serve_cli_lm_on_cpu(capsys, arch, landmark):
    """The reference's three lines; no kernel launches on the CPU."""
    ops.reset_launches()
    serve.main(["--workload", "lm", "--arch", arch, "--smoke", "--device",
                "cpu"] + (["--landmark"] if landmark else []))
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"prefill 4x32: \d+ms", lines[-3]), lines
    mode = "landmark O\\(n\\)" if landmark else "exact KV"
    assert re.fullmatch(rf"decode 16 tokens \({mode}\): [\d.]+ ms/token",
                        lines[-2]), lines
    ids = re.fullmatch(r"sample ids: \[([\d\s]+)\]", lines[-1])
    assert ids and len(ids.group(1).split()) == 12, lines
    assert all(v == 0 for v in ops.launch_counts().values())


def test_serve_cli_lm_is_the_default_and_needs_a_card():
    """No ``--workload``: the lm path; without ``--device cpu`` and no card
    it raises (the port never falls back)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError):
        serve.main(["--smoke", "--tokens", "1"])
