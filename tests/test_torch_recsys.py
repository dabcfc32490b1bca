"""The port's recsys models (FM, BERT4Rec, MIND, DIEN) against the JAX
reference, on the CPU, at the registry's smoke models.

The reference's ``init_*(PRNGKey(0))`` makes the parameters and
``models.convert.recsys_from_numpy`` loads them; both packages get the
same numpy batches (the generators, with some history ids set to -1
padding).

Tolerances:
- FM (one gather and sums): loss, gradients and scores within rtol 1e-5
  and atol 1e-6 (f32);
- BERT4Rec, MIND, DIEN: within rtol 1e-4 and atol 1e-6, the parity rule
  where a softmax or a scan runs in another order (BERT4Rec's streamed
  attention, MIND's routing, DIEN's GRU scans); each gradient leaf's
  atol is 1e-6 of its largest |value| at the least;
- retrieval: the top-100 lists equal under the tie rule
  (``core/topk.py::list_mismatches``, rtol 1e-5, atol 1e-6);
- one AdamW step from the same parameters and gradients: parameters
  within rtol 1e-6 and 0.01 · lr, the state within rtol 1e-5 and 1e-5
  of the leaf's largest value (``tests/test_torch_train.py``'s bounds);
- the mesh form (model = 4) against the plain form: bitwise, loss and
  gradients;
- FM's sum-square trick against the pairwise sum in the port: rtol 1e-5,
  atol 1e-6.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import registry as jregistry
from repro.data import synthetic as JS
from repro.models import recsys as J
from repro.train import optimizer as jopt

from repro_torch.configs import registry
from repro_torch.core.topk import list_mismatches
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import recsys as R
from repro_torch.models.convert import (opt_state_to_numpy,
                                        recsys_from_numpy, recsys_to_numpy)
from repro_torch.train import optimizer as topt

ARCHS = ("fm", "bert4rec", "mind", "dien")
TOL = {"fm": 1e-5, "bert4rec": 1e-4, "mind": 1e-4, "dien": 1e-4}
ATOL = 1e-6
P_RTOL, P_ATOL_LR = 1e-6, 1e-2
S_RTOL, S_ATOL_REL = 1e-5, 1e-5
J_INIT = {"fm": J.init_fm, "bert4rec": J.init_bert4rec,
          "mind": J.init_mind, "dien": J.init_dien}
J_LOSS = {"fm": J.fm_loss, "bert4rec": J.bert4rec_loss,
          "mind": J.mind_loss, "dien": J.dien_loss}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _models(name):
    """(reference config, reference params, port model) of the smoke
    model, from the reference's PRNGKey(0) weights."""
    jc = jregistry.get(name).smoke_model
    params = J_INIT[name](jax.random.PRNGKey(0), jc)
    model = recsys_from_numpy(_np(params), registry.get(name).smoke_model,
                              "cpu")
    return jc, params, model


def _batch(name, jc, rows=None, kind="train", step=0):
    """A numpy batch of ``kind`` for the smoke model: the reference
    generators, history ids padded (-1) at the start of some rows."""
    if name == "fm":
        b = JS.fm_train_batch(0, step, rows or 16, jc.field_vocabs)
        if kind == "retrieval":
            b = {"field_ids": b["field_ids"][:1],
                 "cand_ids": np.arange(jc.table_rows, dtype=np.int32)}
        return b
    rows = rows or 8
    if name == "bert4rec":
        b = JS.seq_rec_batch(0, step, rows, jc.seq_len, jc.n_items,
                             n_mask=max(1, jc.seq_len // 5),
                             n_negatives=jc.n_negatives)
    elif name == "mind":
        b = JS.seq_rec_batch(0, step, rows, jc.seq_len, jc.n_items,
                             n_negatives=jc.n_negatives)
    else:
        b = JS.seq_rec_batch(0, step, rows, jc.seq_len, jc.n_items)
    b["item_ids"][: rows // 2, :3] = -1
    b["item_ids"][0, :] = -1  # an empty history
    if kind == "scores":
        rng = np.random.default_rng(step)
        b["candidates"] = rng.integers(0, jc.n_items, (rows, 12)
                                       ).astype(np.int32)
        b["candidates"][1, :2] = -1
    return b


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _ref_leaf(tree, name):
    """The reference-layout leaf of a port parameter name."""
    parts = name.split(".")
    if parts[0] == "layers":
        return tree["layers"][parts[2]][int(parts[1])]
    for key in parts:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("name", ARCHS)
def test_init_tree_matches_reference(name):
    jc, params, model = _models(name)
    fresh = R.init_recsys(registry.get(name).smoke_model,
                          torch.Generator().manual_seed(0), "cpu")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), _np(params))
    for tree in (recsys_to_numpy(model), recsys_to_numpy(fresh)):
        assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), tree) == want
    for a, b in zip(jax.tree.leaves(recsys_to_numpy(model)),
                    jax.tree.leaves(_np(params))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(name):
    jc, params, model = _models(name)
    b = _batch(name, jc)
    loss, g = jax.value_and_grad(lambda p: J_LOSS[name](p, _j(b), jc))(params)
    tl, tg = value_and_grad(model, _t(b), R.family(model.cfg).loss)
    np.testing.assert_allclose(float(tl), float(loss), rtol=TOL[name],
                               atol=ATOL)
    g = _np(g)
    assert sum(t.numel() for t in tg.values()) == sum(
        a.size for a in jax.tree.leaves(g))
    for pname, grad in tg.items():
        want = _ref_leaf(g, pname)
        np.testing.assert_allclose(
            grad.numpy(), want, rtol=TOL[name],
            atol=max(ATOL, 1e-6 * float(np.abs(want).max())),
            err_msg=pname)


def _ref_scores(name, params, b, jc):
    if name == "fm":
        return J.fm_scores(params, b["field_ids"], jc)
    return {"bert4rec": J.bert4rec_scores, "mind": J.mind_scores,
            "dien": J.dien_logits}[name](params, b, jc)


@pytest.mark.parametrize("name", ARCHS)
def test_scores_match_reference(name):
    jc, params, model = _models(name)
    b = _batch(name, jc, kind="scores", step=1)
    want = np.asarray(_ref_scores(name, params, _j(b), jc))
    with torch.inference_mode():
        got = R.family(model.cfg).scores(model, _t(b))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[name], atol=ATOL)


def _ref_retrieval(name, params, b, jc):
    if name == "fm":
        return J.fm_retrieval(params, b["field_ids"], b["cand_ids"], jc,
                              k=100)
    return {"bert4rec": J.bert4rec_retrieval, "mind": J.mind_retrieval,
            "dien": J.dien_retrieval}[name](params, b, jc, k=100)


@pytest.mark.parametrize("name", ARCHS)
def test_retrieval_top100_equal_under_the_tie_rule(name):
    jc, params, model = _models(name)
    b = _batch(name, jc, rows=2, kind="retrieval", step=2)
    if name != "fm":
        b = {"item_ids": b["item_ids"][1:]}
    wv, wi = _ref_retrieval(name, params, _j(b), jc)
    with torch.inference_mode():
        gv, gi = R.family(model.cfg).retrieval(model, _t(b), k=100)
    assert gi.shape == (1, 100)
    if name != "fm":
        assert int(gi.max()) < jc.n_items  # padding rows scored -inf
    bad = list_mismatches(np.asarray(wv), np.asarray(wi), gv, gi)
    assert bad.size == 0, (np.asarray(wi)[0, :10], gi[0, :10])


@pytest.mark.parametrize("name", ARCHS)
def test_one_adamw_step_matches_reference_opt_update(name):
    """The arch's AdamW (lr 1e-3) from zero state with the reference's
    gradients: parameters and state against the reference's update."""
    jc, params, model = _models(name)
    arch, jarch = registry.get(name), jregistry.get(name)
    b = _batch(name, jc)
    g = jax.grad(lambda p: J_LOSS[name](p, _j(b), jc))(params)
    jstate = jopt.opt_init(params, jarch.opt)
    jparams, jstate = jopt.opt_update(params, g, jstate, jarch.opt)
    state = topt.opt_init(model, arch.opt)
    assert jax.tree.structure(opt_state_to_numpy(state)) == \
        jax.tree.structure(_np(jstate))
    gn = _np(g)
    grads = {n: torch.as_tensor(np.array(_ref_leaf(gn, n)))
             for n, _ in model.named_parameters()}
    topt.opt_update(model, grads, state, arch.opt)
    lr = float(jopt._schedule(jarch.opt, jstate["step"]))
    for a, w in zip(jax.tree.leaves(recsys_to_numpy(model)),
                    jax.tree.leaves(_np(jparams))):
        np.testing.assert_allclose(a, w, rtol=P_RTOL, atol=P_ATOL_LR * lr)
    got = opt_state_to_numpy(state)
    assert int(got["step"]) == 1
    for a, w in zip(jax.tree.leaves(got["leaves"]),
                    jax.tree.leaves(_np(jstate["leaves"]))):
        np.testing.assert_allclose(a, w, rtol=S_RTOL,
                                   atol=S_ATOL_REL * np.abs(w).max())


@pytest.mark.parametrize("name", ARCHS)
def test_mesh_form_is_bitwise_the_plain_form(name):
    """Every lookup on the row-sharded table (model = 4): the loss and each
    gradient leaf bit for bit the one-device model's."""
    jc, _, model = _models(name)
    b = _t(_batch(name, jc))
    loss_fn = R.family(model.cfg).loss
    mesh = make_mesh(("model",), (4,), "cpu")
    lp, gp = value_and_grad(model, b, loss_fn)
    lm, gm = value_and_grad(model, b, lambda m, x: loss_fn(m, x, mesh))
    assert torch.equal(lm, lp)
    for key in gp:
        assert torch.equal(gm[key], gp[key]), key


def test_fm_sum_square_trick_equals_pairwise():
    """Rendle's O(nk) form against Σ_{i<j} ⟨v_i, v_j⟩ + Σ w_i + b."""
    _, _, model = _models("fm")
    ids = torch.as_tensor(JS.fm_train_batch(
        0, 0, 16, jregistry.get("fm").smoke_model.field_vocabs)["field_ids"])
    n_fields = ids.shape[1]
    with torch.no_grad():
        fast = R.fm_scores(model, ids)
        v, w = model.v[ids.long()], model.w[ids.long()]
        pair = sum((v[:, i] * v[:, j]).sum(-1) for i in range(n_fields)
                   for j in range(i + 1, n_fields))
        slow = model.b + w.sum(1) + pair
    np.testing.assert_allclose(fast.numpy(), slow.numpy(), rtol=1e-5,
                               atol=1e-6)
