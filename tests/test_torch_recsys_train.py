"""The recsys cells, trainer and CLI against the JAX reference, on the CPU:
``launch/steps.py``'s recsys cells (inputs, train step), the train CLI
(``--arch {fm,bert4rec,mind,dien} --smoke``), a checkpoint and its resume.

Tolerances:
- cell inputs: the reference's ``_rec_batch_sds`` shapes and dtypes,
  equal (a one-device mesh with Auto axes, ROADMAP B8);
- one train step of the cell against the reference's jitted cell from the
  same weights and batch: the loss within rtol 1e-5 (FM) or 1e-4 (the
  sequence models, their softmaxes and scans in another order); Adam's
  first step is ≈ sign(g)·lr, so each parameter within 2.01·lr of the
  reference's (a gradient near 0 may take the other sign) and within
  0.01·lr where |g| ≥ 1e-3·max|g| (``tests/test_torch_gnn.py``'s rule);
- checkpoints across packages: bitwise;
- ``examples/landmark_retrieval_torch.py`` at the MovieLens-100k shape:
  top-10 overlap and neighbor quality within 1e-5 of the reference
  example's, its attention errors within rtol 1e-4.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import registry as jregistry
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.launch.steps import _rec_batch_sds
from repro.launch.steps import build_cell as jbuild_cell
from repro.models import recsys as J
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt

from repro_torch.configs import registry
from repro_torch.configs.base import RECSYS_SHAPES, ShapeSpec
from repro_torch.kernels import ops
from repro_torch.launch import steps, train
from repro_torch.models import recsys as R
from repro_torch.models.convert import (param_tree, recsys_from_numpy,
                                        recsys_to_numpy)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("fm", "bert4rec", "mind", "dien")
LOSS_RTOL = {"fm": 1e-5, "bert4rec": 1e-4, "mind": 1e-4, "dien": 1e-4}
J_INIT = {"fm": J.init_fm, "bert4rec": J.init_bert4rec,
          "mind": J.init_mind, "dien": J.init_dien}
J_LOSS = {"fm": J.fm_loss, "bert4rec": J.bert4rec_loss,
          "mind": J.mind_loss, "dien": J.dien_loss}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)


def test_recsys_shapes_equal_reference():
    want = jregistry.get("fm").shapes
    assert [(s.name, s.kind, s.dims) for s in RECSYS_SHAPES] == \
        [(s.name, s.kind, s.dims) for s in want]
    for name in ARCHS:
        arch, jarch = registry.get(name), jregistry.get(name)
        assert arch.family == jarch.family == "recsys"
        assert arch.source == jarch.source
        assert arch.opt.name == jarch.opt.name and arch.opt.lr == jarch.opt.lr
        for tc, jc in ((arch.model, jarch.model),
                       (arch.smoke_model, jarch.smoke_model)):
            got = {f.name: getattr(tc, f.name)
                   for f in dataclasses.fields(tc) if f.name != "dtype"}
            assert got == {k: getattr(jc, k) for k in got}
            assert tc.table_rows == jc.table_rows
    fm = registry.get("fm").model
    assert fm.total_rows == 41_688_900 and fm.table_rows == 41_689_088


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("shape", [s.name for s in RECSYS_SHAPES])
def test_build_cell_inputs_equal_reference_sds(name, shape):
    """Every (arch, shape) cell builds on the meta device, its inputs in
    the reference's shapes and dtypes, its model in the reference's
    parameter tree (the train cell's optimizer state too)."""
    arch, jarch = registry.get(name), jregistry.get(name)
    cell = steps.build_cell(arch, shape)
    kind = arch.shape(shape).kind
    batch = cell.args[-1]
    want = _rec_batch_sds(jarch, jarch.shape(shape), _auto_mesh(), kind)
    assert sorted(batch) == sorted(want)
    for key, sds in want.items():
        assert tuple(batch[key].shape) == tuple(sds.shape), key
        assert batch[key].dtype == torch.int32 and sds.dtype == jnp.int32
        assert batch[key].device.type == "meta"
    model = cell.args[0]
    jshape = jax.eval_shape(lambda: J_INIT[name](jax.random.PRNGKey(0),
                                                 jarch.model))
    got = jax.tree.map(lambda t: tuple(t.shape), param_tree(model))
    assert got == jax.tree.map(lambda s: tuple(s.shape), jshape)
    if kind == "train":
        jopt_shape = jax.eval_shape(lambda: jopt.opt_init(jshape, jarch.opt))
        assert jax.tree.structure(jax.tree.map(
            lambda t: 0, cell.args[1]["leaves"])) == jax.tree.structure(
            jax.tree.map(lambda s: 0, jopt_shape["leaves"]))


def _small(name, rows=8):
    """(port arch, reference arch) at the smoke model with a train shape
    of ``rows`` rows."""
    arch = dataclasses.replace(registry.get(name),
                               model=registry.get(name).smoke_model)
    jarch = dataclasses.replace(jregistry.get(name),
                                model=jregistry.get(name).smoke_model)
    dims = dict(batch=rows)
    return (dataclasses.replace(arch, shapes=(ShapeSpec("t", "train", dims),)),
            dataclasses.replace(jarch,
                                shapes=(JShapeSpec("t", "train", dims),)))


@pytest.mark.parametrize("name", ARCHS)
def test_train_cell_step_matches_reference_cell(name):
    """One step of the reference's ``_rec_cell`` on a one-device Auto mesh
    against the port's cell, from the same weights and batch."""
    arch, jarch = _small(name)
    raw = {k: v if k == "negatives" else v[:8]
           for k, v in next(train._rec_batches(arch.model)).items()}
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    params = J_INIT[name](jax.random.PRNGKey(0), jarch.model)
    host = _np(params)
    g_ref = _np(jax.grad(lambda p: J_LOSS[name](p, jb, jarch.model))(params))
    mesh = _auto_mesh()
    jcell = jbuild_cell(jarch, "t", mesh)
    with mesh:
        new_params, new_state, metrics = jcell.jit()(
            params, jopt.opt_init(params, jarch.opt), jb)
    lr = float(jopt._schedule(jarch.opt, new_state["step"]))

    cell = steps.build_cell(arch, "t")
    model = recsys_from_numpy(host, arch.model, "cpu")
    state = topt.opt_init(model, arch.opt)
    ops.reset_launches()
    _, _, out = cell.fn(model, state, {k: torch.as_tensor(v)
                                       for k, v in raw.items()})
    assert ops.launch_counts()["segment_sum"] == 0  # the CPU: plain sums
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]),
                               rtol=LOSS_RTOL[name])
    for a, b0, w, g in zip(jax.tree.leaves(recsys_to_numpy(model)),
                           jax.tree.leaves(host),
                           jax.tree.leaves(_np(new_params)),
                           jax.tree.leaves(g_ref)):
        off = np.abs((a - b0) - (w - b0))
        assert off.max() <= 2.01 * lr, off.max() / lr
        big = np.abs(g) >= 1e-3 * np.abs(g).max()
        if big.any():
            assert off[big].max() <= 0.01 * lr, off[big].max() / lr
    assert int(state["step"]) == 1


@pytest.mark.parametrize("name", ARCHS)
def test_scores_and_retrieval_cells_run_on_cpu(name):
    """The scores and retrieval cells at the smoke model: finite scores of
    the cell's shape, 100 canonical ids below n_items (FM: table rows)."""
    arch = dataclasses.replace(registry.get(name),
                               model=registry.get(name).smoke_model)
    cfg = arch.model
    arch = dataclasses.replace(arch, shapes=(
        ShapeSpec("s", "scores", dict(batch=6, n_candidates=9)),
        ShapeSpec("r", "retrieval",
                  dict(batch=1, n_candidates=cfg.table_rows))))
    model = R.init_recsys(cfg, torch.Generator().manual_seed(1), "cpu")
    rng = np.random.default_rng(0)
    for shape in ("s", "r"):
        cell = steps.build_cell(arch, shape)
        hi = cfg.table_rows if name == "fm" else cfg.n_items
        batch = {k: torch.as_tensor(rng.integers(0, hi, tuple(v.shape)
                                                 ).astype(np.int32))
                 for k, v in cell.args[1].items()}
        out = cell.fn(model, batch)
        if shape == "s":
            want = (6, 9) if name in ("bert4rec", "mind") else (6,)
            assert tuple(out.shape) == want
            assert torch.isfinite(out).all()
        else:
            vals, ids = out
            assert tuple(ids.shape) == (1, 100)
            assert (vals[:, :-1] >= vals[:, 1:]).all()
            assert int(ids.max()) < (cfg.table_rows if name == "fm"
                                     else cfg.n_items)


@pytest.mark.parametrize("name", ARCHS)
def test_train_cli_recsys_smoke_trains(name, capsys):
    out = train.main(["--arch", name, "--smoke", "--steps", "2",
                      "--device", "cpu"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert isinstance(out["params"], R.MODELS)
    assert "final loss" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["bert4rec", "dien"])
def test_recsys_checkpoint_resumes_and_restores_in_the_reference(
        name, tmp_path, capsys):
    """``--steps 2`` then ``--steps 3`` resumes from step 2; the checkpoint
    is the reference's (params, opt_state) tree (BERT4Rec's blocks
    stacked, DIEN's GRUs nested), restored there bit for bit."""
    args = ["--arch", name, "--smoke", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    first = train.main(args + ["--steps", "2"])
    assert ckpt.latest_step(str(tmp_path)) == 2
    jarch = jregistry.get(name)
    params = J_INIT[name](jax.random.PRNGKey(9), jarch.smoke_model)
    like = (params, jopt.opt_init(params, jarch.opt))
    rp, rs = jckpt.restore_checkpoint(str(tmp_path), like)
    assert jax.tree.structure((rp, rs)) == jax.tree.structure(like)
    for a, b in zip(jax.tree.leaves((rp, rs)),
                    jax.tree.leaves((param_tree(first["params"]),
                                     first["opt_state"]))):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())
    second = train.main(args + ["--steps", "3"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert second["last_step"] == 2 and len(second["losses"]) == 1


def test_train_cli_recsys_refuses_a_serving_shape_and_a_missing_card():
    with pytest.raises(ValueError, match="trains on train_batch"):
        train.main(["--arch", "fm", "--shape", "serve_p99", "--steps", "1",
                    "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--arch", "mind", "--smoke", "--steps", "1"])


def test_landmark_retrieval_example_matches_reference_on_cpu(capsys):
    """``examples/landmark_retrieval_torch.py --device cpu`` at the
    MovieLens-100k shape against the reference example's computation:
    overlap and neighbor quality within 1e-5, the attention errors within
    rtol 1e-4 (landmark attention's softmaxes and pinv in another order),
    the graph's shape."""
    from repro.core.similarity import dense_similarity, masked_similarity
    from repro.data.ratings import synthesize
    from repro.models.layers import landmark_attention

    spec = importlib.util.spec_from_file_location(
        "landmark_retrieval_torch",
        ROOT / "examples" / "landmark_retrieval_torch.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    got = ex.main(["--device", "cpu", "--dataset", "movielens100k"])
    assert "neighbor quality" in capsys.readouterr().out

    inter = jnp.asarray(synthesize("movielens100k", seed=0).to_matrix(
        slice(None)).ratings.T)
    n_items = inter.shape[0]
    full = masked_similarity(inter, inter, "pearson")
    counts = (inter != 0).sum(axis=1)
    rep = masked_similarity(inter, inter[jnp.argsort(-counts)[:64]],
                            "pearson")
    approx = dense_similarity(rep, rep, "pearson")
    hot = np.where(np.asarray(counts) > 100)[0][:400]
    eye = jnp.eye(n_items)[hot] * 10
    top_full = np.asarray(jax.lax.top_k(full[hot] - eye, 10)[1])
    top_lm = np.asarray(jax.lax.top_k(approx[hot] - eye, 10)[1])
    overlap = np.mean([len(set(a) & set(b)) / 10
                       for a, b in zip(top_full, top_lm)])
    f_np = np.asarray(full[hot])
    quality = np.mean([f_np[i, top_lm[i]].mean()
                       / max(f_np[i, top_full[i]].mean(), 1e-9)
                       for i in range(len(hot))])
    assert abs(got["overlap"] - overlap) <= 1e-5
    assert abs(got["quality"] - quality) <= 1e-5
    assert got["graph"] == (n_items, 10)
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.normal(size=ex.ATTN_SHAPE).astype(np.float32))
               for _ in range(3))
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(ex.ATTN_SHAPE[-1])
    dense = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, -1), v)
    for n in ex.ATTN_LANDMARKS:
        want = float(jnp.abs(landmark_attention(q, k, v, n_landmarks=n)
                             - dense).mean())
        np.testing.assert_allclose(got["attn_err"][n], want, rtol=1e-4)
