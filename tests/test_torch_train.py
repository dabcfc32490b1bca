"""The port's training path against the JAX reference, on the CPU: the
optimizer, gradient accumulation, the trainer (resume, SIGTERM), training
checkpoints across packages, the train CLI and the example.

Both packages get the same numpy inputs: the reference's ``init_lm`` makes
the parameters, numpy seeds the gradients, and ``models.convert`` carries
parameters and optimizer state across.

Tolerances:
- two optimizer updates from the same parameters, gradients and state
  (f32 parameters): the only differences are the order of the
  global-norm sum and of the means, and f32 ``pow`` (ulps), so the
  clipped gradients differ by an ulp. The second step's first moment
  b1·m + (1 − b1)·g cancels where g turns, so the state is held within
  rtol 1e-5 and 1e-5 of the leaf's largest value (seen: 7e-11 against
  values ~1e-4), a bf16 state within one bf16 step of the value and of
  the leaf's largest value (a rounding flipped at the first step, carried
  through the second's cancellation; rtol and atol 2^-7); Adam's
  update m̂/√v̂ is sign-like where m̂ is that small, so the parameters are
  held within rtol 1e-6 and 0.01 · lr (seen: 0.0036 · lr);
- gradient accumulation (accum = 2, the reference's bf16 accumulators):
  the accumulated gradients differ from the reference's by bf16 roundings
  of f32 gradients a few ulps apart, and Adam's first step is ≈ sign(g)
  · lr, so the updated parameters are held in units of the step's lr:
  within 2.01 · lr everywhere (an element whose gradient rounds to 0 on
  one side only moves by up to lr there), within 0.01 · lr where
  |g| ≥ 1e-3 · max |g|; the loss within 1e-5;
- the trainer in bf16 (the smoke model's own dtype): losses within rtol
  1e-2 of the reference's, the bf16 loss bound of ``test_torch_lm.py``.
"""
import dataclasses
import importlib.util
import os
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import registry as jregistry
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data import synthetic as jsynthetic
from repro.distributed.sharding import DEFAULT_RULES
from repro.launch.steps import build_cell as jbuild_cell
from repro.models import transformer as J
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro.train.trainer import train_loop as jtrain_loop

from repro_torch.configs import registry
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.data import synthetic
from repro_torch.kernels import ops
from repro_torch.launch import steps, train
from repro_torch.models import transformer as T
from repro_torch.models.convert import (lm_from_numpy, lm_to_numpy, lm_tree,
                                        load_lm_tree, opt_state_from_numpy,
                                        opt_state_to_numpy)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import (Prefetcher, TrainerConfig, to_device,
                                       train_loop)

ROOT = Path(__file__).resolve().parents[1]
P_RTOL, P_ATOL_LR = 1e-6, 1e-2
S_RTOL, S_ATOL_REL = 1e-5, 1e-5
BF16_STEP = 2 ** -7
LOSS_BF16_RTOL = 1e-2


def _pair(name, **over):
    """(reference config, port config) of ``name``'s smoke model."""
    jc = dataclasses.replace(jregistry.get(name).smoke_model, **over)
    over = {k: (torch.float32 if v is jnp.float32 else v)
            for k, v in over.items()}
    tc = dataclasses.replace(registry.get(name).smoke_model, **over)
    return jc, tc


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: rng.normal(
        scale=0.05, size=p.shape).astype(np.float32), params)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _port_grads(model, tree):
    """A reference-layout gradient tree as the port's {name: tensor}."""
    out = {}
    for name, p in model.named_parameters():
        if name.startswith("layers."):
            _, i, key = name.split(".", 2)
            g = tree["layers"][key][int(i)]
        else:
            g = tree[name]
        out[name] = torch.as_tensor(np.array(g), dtype=p.dtype)
    return out


def _assert_state(got, want, state_dtype):
    rel = S_ATOL_REL if state_dtype == torch.float32 else BF16_STEP
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=max(rel, S_RTOL),
                                   atol=rel * np.abs(b).max())


# (optimizer, state dtype, layers): L = 2 (whole-stack RMS) and L = 8 (the
# reference's per-layer lax.map), f32 and bf16 state, Adafactor with
# momentum
OPT_CASES = [("adamw", "f32", 2), ("adamw", "bf16", 8),
             ("adafactor", "f32", 2), ("adafactor", "f32", 8),
             ("adafactor", "bf16", 2), ("adafactor-momentum", "f32", 8)]


@pytest.mark.parametrize("opt,state,layers", OPT_CASES)
def test_opt_update_matches_reference(opt, state, layers):
    """Two updates from zero state with seeded gradients (clipping active):
    parameters and state after each against the reference's."""
    name = opt.split("-")[0]
    jcfg = jopt.OptConfig(name=name, momentum=opt.endswith("momentum"),
                          warmup_steps=3, state_dtype=(
                              jnp.float32 if state == "f32" else jnp.bfloat16))
    tcfg = topt.OptConfig(name=name, momentum=jcfg.momentum, warmup_steps=3,
                          state_dtype=(torch.float32 if state == "f32"
                                       else torch.bfloat16))
    jc, tc = _pair("smollm-360m", n_layers=layers, dtype=jnp.float32)
    params = J.init_lm(jax.random.PRNGKey(1), jc)
    model = lm_from_numpy(_np(params), tc, "cpu")
    jstate = jopt.opt_init(params, jcfg)
    tstate = topt.opt_init(model, tcfg)
    assert jax.tree.structure(opt_state_to_numpy(tstate)) == (
        jax.tree.structure(_np(jstate)))
    for seed in (0, 1):
        g = _grads(params, seed)
        params, jstate = jax.jit(lambda p, gg, s: jopt.opt_update(
            p, gg, s, jcfg))(params, jax.tree.map(jnp.asarray, g), jstate)
        topt.opt_update(model, _port_grads(model, g), tstate, tcfg)
        lr = float(jopt._schedule(jcfg, jstate["step"]))
        for a, b in zip(jax.tree.leaves(lm_to_numpy(model)),
                        jax.tree.leaves(_np(params))):
            np.testing.assert_allclose(a, b, rtol=P_RTOL,
                                       atol=P_ATOL_LR * lr)
        got = opt_state_to_numpy(tstate)
        assert int(got["step"]) == int(jstate["step"]) == seed + 1
        _assert_state(got["leaves"], _np(jstate["leaves"]), tcfg.state_dtype)


def test_adafactor_factors_stacked_norms_across_layers():
    """The reference's rank rule on the stacked tree: norm scales (L, d)
    are factored across layers, (L, d, f) weights per layer."""
    _, tc = _pair("smollm-360m", n_layers=3)
    model = T.init_lm(tc, device="cpu")
    st = topt.opt_init(model, topt.OptConfig(name="adafactor"))["leaves"]
    assert st["layers"]["attn_norm"]["vr"].shape == (3,)
    assert st["layers"]["attn_norm"]["vc"].shape == (tc.d_model,)
    assert st["layers"]["w1"]["vr"].shape == (3, tc.d_model)
    assert st["layers"]["w1"]["vc"].shape == (3, tc.d_ff)
    assert set(st["final_norm"]) == {"v"}
    assert st["embed"]["vr"].shape == (tc.vocab,)


def test_opt_state_round_trips_exactly():
    """``opt_state_from_numpy`` / ``opt_state_to_numpy`` carry a state tree
    across bit for bit (bf16 through f32), and reject a tree of another
    layout."""
    jc, tc = _pair("deepseek-moe-16b")
    params = J.init_lm(jax.random.PRNGKey(2), jc)
    jcfg = jopt.OptConfig(name="adafactor", state_dtype=jnp.bfloat16)
    jstate = jax.jit(lambda p, g, st: jopt.opt_update(p, g, st, jcfg))(
        params, jax.tree.map(jnp.asarray, _grads(params, 3)),
        jopt.opt_init(params, jcfg))[1]
    model = lm_from_numpy(_np(params), tc, "cpu")
    tcfg = topt.OptConfig(name="adafactor", state_dtype=torch.bfloat16)
    state = opt_state_from_numpy(jax.tree.map(np.asarray, jstate), model,
                                 tcfg)
    assert state["leaves"]["layers"]["ew1"]["vr"].dtype == torch.bfloat16
    back = opt_state_to_numpy(state)
    assert int(back["step"]) == 1
    for a, b in zip(jax.tree.leaves(back["leaves"]),
                    jax.tree.leaves(_np(jstate["leaves"]))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="keys differ"):
        opt_state_from_numpy(jax.tree.map(np.asarray, jstate), model,
                             topt.OptConfig(name="adamw"))


def _accum_archs():
    shape = dict(batch=4, seq=32)
    jc, tc = _pair("smollm-360m", dtype=jnp.float32)
    ja = dataclasses.replace(
        jregistry.get("smollm-360m"), model=jc, grad_accum={"train_4k": 2},
        shapes=(JShapeSpec("train_4k", "train", shape),))
    ta = dataclasses.replace(
        registry.get("smollm-360m"), model=tc, grad_accum={"train_4k": 2},
        shapes=(ShapeSpec("train_4k", "train", shape),))
    return ja, ta


def test_grad_accumulation_matches_reference_cell():
    """accum = 2 with bf16 accumulators over f32 parameters, one step of
    the reference's ``_lm_train_cell`` on a one-device host mesh against
    the port's cell."""
    ja, ta = _accum_archs()
    # one device, every axis of size 1; Auto axes, which the cell's
    # sharding constraints need (the reference's make_host_mesh gives
    # Explicit ones under this JAX)
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    jcell = jbuild_cell(ja, "train_4k", mesh)
    assert jcell.args[2]["tokens"].shape == (2, 2, 32)
    params = J.init_lm(jax.random.PRNGKey(0), ja.model)
    jstate = jopt.opt_init(params, ja.opt)
    raw = jsynthetic.lm_batch(0, 0, 4, 32, ja.model.vocab)
    jbatch = {k: jnp.asarray(v.reshape(2, 2, 32)) for k, v in raw.items()}
    # the reference's gradients alone, for the |g| split of the bound
    loss_fn = lambda p, mb: J.lm_loss(p, mb, ja.model, DEFAULT_RULES)
    g_ref = jax.tree.map(lambda a, b: (a.astype(jnp.bfloat16)
                                       + b.astype(jnp.bfloat16)) / 2,
                         *(jax.grad(loss_fn)(params, jax.tree.map(
                             lambda x: x[i], jbatch)) for i in (0, 1)))
    host_params = _np(params)  # the cell donates its inputs
    with mesh:
        new_params, new_state, metrics = jcell.jit()(params, jstate, jbatch)
    lr = float(jopt._schedule(ja.opt, new_state["step"]))

    tcell = steps.build_cell(ta, "train_4k")
    meta_model, meta_state, meta_batch = tcell.args
    assert meta_batch["tokens"].shape == (2, 2, 32)
    assert meta_batch["tokens"].device.type == "meta"
    assert all(p.device.type == "meta" for p in meta_model.parameters())
    model = lm_from_numpy(host_params, ta.model, "cpu")
    state = topt.opt_init(model, ta.opt)
    before = lm_to_numpy(model)
    _, _, out = tcell.fn(model, state, {k: torch.as_tensor(v) for k, v in
                                        raw.items()})
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]),
                               rtol=1e-5)
    after = lm_to_numpy(model)
    leaves = zip(jax.tree.leaves(after), jax.tree.leaves(before),
                 jax.tree.leaves(_np(new_params)), jax.tree.leaves(
                     _np(g_ref)))
    for a, b0, w, g in leaves:
        off = np.abs((a - b0) - (w - b0))
        assert off.max() <= 2.01 * lr, off.max() / lr
        big = np.abs(g) >= 1e-3 * np.abs(g).max()
        assert off[big].max() <= 0.01 * lr, off[big].max() / lr
    assert int(state["step"]) == 1


def _smoke_batches(vocab, b=2, s=16, device="cpu"):
    step = 0
    while True:
        yield to_device(synthetic.lm_batch(0, step, b, s, vocab), device)
        step += 1


def _port_step(arch):
    def step_fn(model, opt_state, batch):
        loss, grads = steps.value_and_grad(model, batch)
        topt.opt_update(model, grads, opt_state, arch.opt)
        return model, opt_state, {"loss": loss}
    return step_fn


def test_trainer_checkpoints_and_resumes_as_the_reference(tmp_path):
    """The reference's ``test_trainer_checkpoints_and_resumes`` on the port,
    from the reference's init, beside the reference's own run: 6 steps with
    checkpoints every 3, then a resume to 10 that runs steps 6..9; losses
    within the bf16 bound of the reference's."""
    jarch = jregistry.get("smollm-360m")
    jc = jarch.smoke_model
    params = J.init_lm(jax.random.PRNGKey(0), jc)
    jopt_state = jopt.opt_init(params, jarch.opt)

    def jbatches():
        step = 0
        while True:
            yield {k: jnp.asarray(v) for k, v in
                   jsynthetic.lm_batch(0, step, 2, 16, jc.vocab).items()}
            step += 1

    @jax.jit
    def jstep(params, opt, batch):
        loss, grads = jax.value_and_grad(
            lambda p: J.lm_loss(p, batch, jc, DEFAULT_RULES))(params)
        params, opt = jopt.opt_update(params, grads, opt, jarch.opt)
        return params, opt, {"loss": loss}

    quiet = lambda *_: None
    jdir = tmp_path / "ref"
    want = jtrain_loop(jstep, params, jopt_state, jbatches(), JTrainerConfig(
        total_steps=6, ckpt_dir=str(jdir), ckpt_every=3, log_every=100),
        log=quiet)["losses"]
    want += jtrain_loop(jstep, params, jopt_state, jbatches(), JTrainerConfig(
        total_steps=10, ckpt_dir=str(jdir), ckpt_every=100, log_every=100),
        log=quiet)["losses"]

    arch = registry.get("smollm-360m")
    model = lm_from_numpy(_np(params), arch.smoke_model, "cpu")
    state = topt.opt_init(model, arch.opt)
    tc = TrainerConfig(total_steps=6, ckpt_dir=str(tmp_path / "port"),
                       ckpt_every=3, log_every=100)
    out1 = train_loop(_port_step(arch), model, state,
                      _smoke_batches(arch.smoke_model.vocab), tc, log=quiet)
    assert len(out1["losses"]) == 6
    assert all(np.isfinite(l) for l in out1["losses"])
    assert ckpt.latest_step(tmp_path / "port") == 6
    # resume into a fresh model: the trainer must pick up from step 6
    model = lm_from_numpy(_np(params), arch.smoke_model, "cpu")
    state = topt.opt_init(model, arch.opt)
    tc2 = TrainerConfig(total_steps=10, ckpt_dir=str(tmp_path / "port"),
                        ckpt_every=100, log_every=100)
    logs = []
    out2 = train_loop(_port_step(arch), model, state,
                      _smoke_batches(arch.smoke_model.vocab), tc2,
                      log=logs.append)
    assert logs[0] == "resumed from step 6"
    assert out2["last_step"] == 9
    assert len(out2["losses"]) == 4  # only steps 6..9 ran
    assert int(state["step"]) == 10
    np.testing.assert_allclose(out1["losses"] + out2["losses"], want,
                               rtol=LOSS_BF16_RTOL)


def test_sigterm_writes_the_emergency_checkpoint(tmp_path):
    """A SIGTERM that arrives during step 2 lets the step finish, then the
    loop saves step 3 and stops; the handler is restored after."""
    arch = registry.get("smollm-360m")
    model = T.init_lm(arch.smoke_model, device="cpu")
    state = topt.opt_init(model, arch.opt)
    inner = _port_step(arch)
    calls = []

    def step_fn(model, opt_state, batch):
        calls.append(len(calls))
        if len(calls) == 3:  # step 2
            os.kill(os.getpid(), signal.SIGTERM)
        return inner(model, opt_state, batch)

    before = signal.getsignal(signal.SIGTERM)
    logs = []
    out = train_loop(step_fn, model, state,
                     _smoke_batches(arch.smoke_model.vocab),
                     TrainerConfig(total_steps=10, ckpt_dir=str(tmp_path),
                                   ckpt_every=100, log_every=100),
                     log=logs.append)
    assert logs[-1] == "SIGTERM at step 2: emergency checkpoint"
    assert out["last_step"] == 2 and len(out["losses"]) == 3
    assert ckpt.latest_step(tmp_path) == 3
    assert signal.getsignal(signal.SIGTERM) == before
    params, opt = ckpt.restore_checkpoint(tmp_path, (lm_tree(model), state),
                                          device="cpu")
    assert int(opt["step"]) == 3
    for a, b in zip(ckpt._flatten(params), ckpt._flatten(lm_tree(model))):
        assert torch.equal(a, b)


def test_training_checkpoints_restore_across_packages(tmp_path):
    """A port checkpoint of (params, AdamW state) after one step restores in
    the reference's ``restore_checkpoint`` into ``(init_lm, opt_init)``'s
    tree, and the reference's restores in the port's, bit for bit (bf16
    parameters, f32 and bf16 state)."""
    for name in ("smollm-360m", "dbrx-132b"):
        arch, jarch = registry.get(name), jregistry.get(name)
        jc = jarch.smoke_model
        params = J.init_lm(jax.random.PRNGKey(4), jc)
        g = _grads(params, 5)
        jparams, jstate = jax.jit(lambda p, gg, st: jopt.opt_update(
            p, gg, st, jarch.opt))(params, jax.tree.map(jnp.asarray, g),
                                   jopt.opt_init(params, jarch.opt))
        like = (J.init_lm(jax.random.PRNGKey(9), jc),
                jopt.opt_init(params, jarch.opt))
        # port → reference
        model = lm_from_numpy(_np(params), arch.smoke_model, "cpu")
        state = topt.opt_init(model, arch.opt)
        topt.opt_update(model, _port_grads(model, g), state, arch.opt)
        writer = ckpt.AsyncCheckpointer(str(tmp_path / name / "port"))
        writer.save(1, (lm_tree(model), state))
        writer.wait()
        rp, rs = jckpt.restore_checkpoint(str(tmp_path / name / "port"), like)
        assert jax.tree.structure((rp, rs)) == jax.tree.structure(like)
        for a, b in zip(jax.tree.leaves((rp, rs)),
                        jax.tree.leaves((lm_tree(model), state))):
            assert a.dtype.name == str(b.dtype).removeprefix("torch.")
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          b.float().numpy())
        # reference → port
        jckpt.save_checkpoint(str(tmp_path / name / "ref"), 1,
                              (jparams, jstate))
        fresh = T.init_lm(arch.smoke_model, device="cpu")
        fstate = topt.opt_init(fresh, arch.opt)
        tp, ts = ckpt.restore_checkpoint(str(tmp_path / name / "ref"),
                                         (lm_tree(fresh), fstate),
                                         device="cpu")
        load_lm_tree(fresh, tp)
        for a, b in zip(jax.tree.leaves(lm_to_numpy(fresh)),
                        jax.tree.leaves(_np(jparams))):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jax.tree.leaves(opt_state_to_numpy(ts)),
                        jax.tree.leaves(_np(jstate))):
            np.testing.assert_array_equal(a, b)


def test_async_checkpointer_copies_before_returning(tmp_path):
    """``save`` holds a host copy: an in-place update right after it does
    not reach the file."""
    t = torch.ones(4, 8)
    writer = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    writer.save(1, {"w": t})
    t.add_(1.0)
    writer.save(2, {"w": t})
    writer.wait()
    for step, val in ((1, 1.0), (2, 2.0)):
        got = ckpt.restore_checkpoint(str(tmp_path), {"w": 0}, step=step,
                                      device="cpu")["w"]
        assert torch.equal(got, torch.full((4, 8), val))


def test_prefetcher_and_to_device():
    it = Prefetcher(iter([{"a": np.arange(3)}, {"a": np.arange(2)}]),
                    lambda b: to_device(b, "cpu"))
    got = [b["a"].tolist() for b in it]
    assert got == [[0, 1, 2], [0, 1]]


def test_build_cell_cells_and_waiting_families():
    arch = registry.get("smollm-360m")
    cell = steps.build_cell(arch, "train_4k")
    model, state, batch = cell.args
    assert batch["tokens"].shape == (256, 4096)  # grad_accum 1
    assert state["leaves"]["layers"]["w1"]["m"].shape == (32, 960, 2560)
    assert steps.build_cell(registry.get("gemma-7b"), "train_4k").args[2][
        "tokens"].shape == (2, 128, 4096)
    assert steps.build_cell(arch, "prefill_32k").args[1].shape == (32, 32768)
    dec = steps.build_cell(arch, "decode_32k")
    assert dec.args[1]["k"].shape == (32, 128, 32768, 5, 64)
    assert steps.build_cell(arch, "decode_32k", "kv_int8").args[1][
        "k"].dtype == torch.int8
    assert "q_lm" in steps.build_cell(arch, "long_500k", "landmark").args[1]
    for family, item in (("gnn", "2.3"), ("recsys", "2.3"), ("cf", "2.5")):
        other = ArchConfig(name="x", family=family, model=None,
                           smoke_model=None, shapes=arch.shapes)
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            steps.build_cell(other, "train_4k")
    with pytest.raises(KeyError):
        steps.build_cell(arch, "train_8k")


def test_prefill_and_decode_cells_run_on_cpu():
    arch = dataclasses.replace(registry.get("smollm-360m"),
                               model=registry.get("smollm-360m").smoke_model)
    arch = dataclasses.replace(arch, shapes=(
        ShapeSpec("p", "prefill", dict(batch=2, seq=16)),
        ShapeSpec("d", "decode", dict(batch=2, cache_len=16))))
    model = T.init_lm(arch.model, device="cpu")
    toks = torch.as_tensor(synthetic.lm_batch(0, 0, 2, 16, 512)["tokens"])
    logits, cache = steps.build_cell(arch, "p").fn(model, toks)
    assert logits.shape == (2, 1, 512)
    cache = T.make_cache(arch.model, 2, 16, "cpu")
    logits, cache = steps.build_cell(arch, "d").fn(model, cache, toks[:, :1])
    assert logits.shape == (2, 1, 512) and int(cache["length"]) == 1


def test_remat_only_while_grad_is_enabled():
    """Serving forwards (no grad) never checkpoint; a training forward
    checkpoints each block and gives the same loss and gradients as one
    that calls each block directly."""
    cfg = dataclasses.replace(registry.get("smollm-360m").smoke_model,
                              dtype=torch.float32)
    model = T.init_lm(cfg, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in
             synthetic.lm_batch(0, 0, 2, 16, 512).items()}
    calls = []
    real = T.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    def direct(fn, *a, **kw):
        calls.append(1)
        return fn(*a)

    T.checkpoint = counted
    try:
        with torch.inference_mode():
            T.lm_forward(model, batch["tokens"])
        assert not calls
        a = steps.value_and_grad(model, batch)
        assert len(calls) == cfg.n_layers
        T.checkpoint = direct
        b = steps.value_and_grad(model, batch)
        assert len(calls) == 2 * cfg.n_layers
    finally:
        T.checkpoint = real
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    for name in a[1]:
        torch.testing.assert_close(a[1][name], b[1][name], rtol=0, atol=0)


def test_train_cli_on_cpu(tmp_path, capsys):
    """``--smoke --device cpu``, then a resume with more steps; no kernel
    launches on the CPU."""
    ops.reset_launches()
    args = ["--arch", "smollm-360m", "--smoke", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    out = train.main(args + ["--steps", "2"])
    assert len(out["losses"]) == 2
    assert ckpt.latest_step(tmp_path) == 2
    out = train.main(args + ["--steps", "3"])
    assert out["last_step"] == 2 and len(out["losses"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert "resumed from step 2" in lines
    assert lines[-1].startswith("final loss ") and "after 3 steps" in (
        lines[-1])
    assert all(v == 0 for v in ops.launch_counts().values())
    first = float(lines[0].split()[3])
    assert abs(first - np.log(512)) < 2.0


def test_train_cli_needs_a_card_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "smollm-360m", "--smoke", "--steps", "1"])


def test_train_lm_example_on_cpu(tmp_path, capsys, monkeypatch):
    """``examples/train_lm_torch.py --device cpu`` at two layers, a few
    steps, then a resume."""
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    monkeypatch.setattr(ex, "CFG", dataclasses.replace(ex.CFG, n_layers=2))
    monkeypatch.setattr(ex, "CKPT_EVERY", 3)
    args = ["--device", "cpu", "--batch", "2", "--seq", "32", "--ckpt-dir",
            str(tmp_path)]
    out = ex.main(args + ["--steps", "3"])
    assert len(out["losses"]) == 3
    assert abs(out["losses"][0] - np.log(32768)) < 2.0
    out = ex.main(args + ["--steps", "4"])
    assert len(out["losses"]) == 1 and out["last_step"] == 3
    assert "loss " in capsys.readouterr().out
