"""The port's dense LM against the JAX reference, on the CPU.

The models: the smoke models of the three dense archs (``gemma-7b``
covers GeGLU and the embedding scale, ``smollm-360m`` tied embeddings and
G = 3 grouped queries, ``llama3-405b`` untied embeddings), and
SmolLM-360M at its full widths (d_model 960, 15/5 heads, d_ff 2560,
vocab 49152) cut to two layers. The reference's ``init_lm`` makes the
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
  reference's Pallas kernel does. Differences seen: up to 2.8%.
"""
import dataclasses
import functools
import re

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
from repro_torch.models import transformer as T
from repro_torch.models.convert import (lm_from_numpy, lm_to_numpy,
                                        tensor_from_numpy)

F32_TOL = 1e-4
QUANT_TOL, QUANT_FLIPS = 5e-3, 1e-3
BF16_ATOL = 0.15
BF16_LANDMARK_REL = 0.05
B, S, PROMPT, STEPS = 2, 32, 8, 8  # batch, forward length, prompt, steps

# (arch, full widths cut to two layers)
MODELS = [("smollm-360m", False), ("gemma-7b", False), ("llama3-405b", False),
          ("smollm-360m", True)]
IDS = ["smollm-smoke", "gemma-smoke", "llama3-smoke", "smollm-full-2L"]


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


@functools.lru_cache(maxsize=None)
def reference(name, full, f32):
    """Everything the tests compare, from the reference, as numpy: one jit
    per model, so each compiles once."""
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

    @jax.jit
    def run(params, batch, lm_cache):
        toks = batch["tokens"]
        out = {
            "logits": J.lm_forward(params, toks, jc, DEFAULT_RULES)[0],
            "logits_landmark": J.lm_forward(params, toks, jl,
                                            DEFAULT_RULES)[0],
            "loss": J.lm_loss(params, batch, jc, DEFAULT_RULES),
            "loss_landmark": J.lm_loss(params, batch, jl, DEFAULT_RULES),
        }
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
        steps, cache = [], J.make_cache(jq, B, STEPS)
        for t in range(STEPS):
            logits, cache = J.lm_decode_step(params, cache, toks[:, t:t + 1],
                                             jq, DEFAULT_RULES)
            steps.append(logits)
        out["decode_quant"] = jnp.concatenate(steps, 1)
        out["cache_quant"] = cache
        steps, cache = [], lm_cache
        for t in range(STEPS):
            logits, cache = J.lm_landmark_decode_step(
                params, cache, toks[:, t:t + 1], jc, DEFAULT_RULES)
            steps.append(logits)
        out["decode_landmark"] = jnp.concatenate(steps, 1)
        out["cache_landmark"] = cache
        return out

    out = run(params, batch, lm_cache)
    to_np = functools.partial(jax.tree.map, lambda a: np.asarray(a,
                                                                 np.float32))
    return (jax.tree.map(np.asarray, params), to_np(out),
            to_np({"k_lm": lm_cache["k_lm"], "q_lm": lm_cache["q_lm"]}),
            jax.tree.map(np.asarray, batch))


def _port(name, full, f32):
    params, want, lm_keys, batch = reference(name, full, f32)
    _, tc = _configs(name, full, f32)
    return lm_from_numpy(params, tc, "cpu"), want, lm_keys, batch


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
    model, want, _, batch = _port(name, full, f32)
    model.cfg = dataclasses.replace(model.cfg, attn_backend=backend)
    tag = "" if backend == "full" else "_landmark"
    tokens = torch.from_numpy(batch["tokens"].copy())
    with torch.no_grad():
        logits, aux = T.lm_forward(model, tokens)
        loss = T.lm_loss(model, {k: torch.from_numpy(v.copy())
                                 for k, v in batch.items()})
    assert logits.shape == (B, S, model.cfg.vocab) and aux == 0.0
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
    model, want, _, batch = _port(name, full, f32)
    cfg = dataclasses.replace(model.cfg, kv_quant=quant)
    model.cfg = cfg
    toks = torch.from_numpy(batch["tokens"].copy())
    tag = "quant" if quant else "exact"
    with torch.no_grad():
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
    model, want, lm_keys, batch = _port(name, full, f32)
    cfg = model.cfg
    cache = T.make_landmark_cache(cfg, B, "cpu")
    for key in ("k_lm", "q_lm"):
        cache[key] = tensor_from_numpy(lm_keys[key], cfg.dtype, "cpu")
    toks = torch.from_numpy(batch["tokens"].copy())
    steps = []
    with torch.no_grad():
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
    the reference's own count for each dense arch."""
    for name, expect in [("llama3-405b", 405e9), ("smollm-360m", 360e6),
                         ("gemma-7b", 8.5e9)]:
        got = registry.get(name).model.param_count()
        assert got == jregistry.get(name).model.param_count()
        assert abs(got - expect) / expect < 0.06, (name, got, expect)
    cfg = registry.get("smollm-360m").smoke_model
    model = T.init_lm(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()


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


def test_moe_configs_raise_until_ported():
    cfg = dataclasses.replace(registry.get("smollm-360m").smoke_model,
                              moe=jregistry.get("dbrx-132b").smoke_model.moe)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.LM(cfg, "cpu")
    with pytest.raises(KeyError, match="deepseek-moe-16b"):
        registry.get("deepseek-moe-16b")


@pytest.mark.parametrize("landmark", [False, True])
def test_serve_cli_lm_on_cpu(capsys, landmark):
    """The reference's three lines; no kernel launches on the CPU."""
    ops.reset_launches()
    serve.main(["--workload", "lm", "--smoke", "--device", "cpu"]
               + (["--landmark"] if landmark else []))
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
