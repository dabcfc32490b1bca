"""The port's GNN family (GatedGCN) against the JAX reference, on the CPU:
the fixed-order segment sum and its autograd Functions, the forward, loss
and gradients, the ``comm_dtype`` path, the mesh form, the generators, one
AdamW step of the train cell, training checkpoints and the train CLI.

Both packages get the same numpy inputs; the reference's ``init_gnn``
makes the parameters and ``models.convert.gnn_from_numpy`` loads them.

Tolerances:
- ``segment_sum_ref`` against ``jax.ops.segment_sum`` on the CPU: bitwise,
  f32 and bf16 (both add in index order from 0, a bf16 sum rounded after
  every add); against CPU ``index_add_``: bitwise in f32; in bf16 this
  torch adds in f32 and rounds once, so the two differ by the roundings
  of the running sum: within 2^-5 of the largest |sum| (seen: 2^-7);
- the autograd Functions against autograd of plain ``index_select`` /
  ``index_add_`` in f64: within 1e-12 (the same sums in another order);
- the f32 forward, loss and gradients against the reference: logits and
  loss within rtol 1e-5 and 1e-5 of the largest |value|, each gradient
  leaf within 2e-5 of its largest |value| (f32 products and layer norms
  summed in other orders through 3 layers; seen: 3e-7 and 1e-6);
- ``comm_dtype=bfloat16``: the same bounds at 1e-2 (an f32 value an ulp
  apart can round to a neighbouring bf16 value before a gather or a sum);
- the mesh form against the reference's one-device ``gnn_forward`` and the
  port's own: within 2e-2, the reference's bf16-wire bound
  (``tests/test_distributed.py``); one train step's loss within 2e-2 of
  the one-device step's;
- the generators: equal arrays;
- one AdamW step of the train cell against the reference's cell: the loss
  within rtol 1e-5; Adam's first step is ≈ sign(g)·lr, so each parameter
  within 2.01·lr of the reference's (a gradient near 0 may take the other
  sign) and within 0.01·lr where |g| ≥ 1e-3·max|g|;
- checkpoints across packages: bitwise.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import registry as jregistry
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data import synthetic as JS
from repro.distributed.sharding import DEFAULT_RULES
from repro.launch.steps import build_cell as jbuild_cell
from repro.models import gnn as J
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt

from repro_torch.configs import registry
from repro_torch.configs.base import GNN_SHAPES, ShapeSpec
from repro_torch.data import synthetic as S
from repro_torch.kernels import ops
from repro_torch.kernels import segment_sum as ss
from repro_torch.launch import steps, train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import gnn as G
from repro_torch.models.convert import (gnn_from_numpy, gnn_to_numpy,
                                        gnn_tree, load_gnn_tree)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt

F32_RTOL, F32_ATOL_REL, GRAD_REL = 1e-5, 1e-5, 2e-5
BF16_SUM_REL = 2 ** -5
BF16_REL = 1e-2
WIRE_ATOL = 2e-2


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _leaf(tree, name):
    """The reference-layout leaf of a port parameter name."""
    if name.startswith("layers."):
        _, i, key = name.split(".", 2)
        return tree["layers"][key][int(i)]
    return tree[name]


def _close(got, want, rtol, atol_rel):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol_rel * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------- segment sum
def _index(kind, e, n, rng):
    """(index, mask) of one of the segment sums' input kinds."""
    mask = np.ones(e, np.float32)
    if kind == "random":
        idx = rng.integers(0, n, e)
    elif kind == "power_law":
        w = 1.0 / np.arange(1, n + 1) ** 0.7
        idx = rng.choice(n, size=e, p=w / w.sum())
    elif kind == "padded":  # the reference's padding: node 0, mask 0
        idx = rng.integers(0, n, e)
        idx[e // 2:] = 0
        mask[e // 2:] = 0
    else:  # "empty": every other segment has no member
        idx = 2 * rng.integers(0, n // 2, e)
    return idx.astype(np.int32), mask


KINDS = ("random", "power_law", "padded", "empty")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_segment_sum_ref_is_jax_segment_sum_and_index_add(kind, dtype):
    rng = np.random.default_rng(KINDS.index(kind))
    e, n, h = 700, 60, 70
    idx, mask = _index(kind, e, n, rng)
    x = rng.normal(size=(e, h)).astype(np.float32)
    xt = torch.as_tensor(x).to(DTYPES[dtype])
    csr = ss.build_csr(torch.as_tensor(idx), n, torch.as_tensor(mask))
    got = ss.segment_sum(xt, csr)
    assert got.dtype == xt.dtype
    live = torch.as_tensor(mask) != 0
    # a padded edge's row, zeroed as the GNN zeroes its messages, adds +0:
    # leaving it out of the CSR changes no bit
    zeroed = torch.where(live[:, None], xt, torch.zeros((), dtype=xt.dtype))
    j = np.asarray(jax.ops.segment_sum(
        jnp.asarray(zeroed.float().numpy()).astype(
            jnp.bfloat16 if dtype == "bf16" else jnp.float32),
        jnp.asarray(idx), num_segments=n).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), j)
    if kind == "empty":
        assert not got[1::2].any()
    for rows, index in ((xt[live], torch.as_tensor(idx)[live].long()),
                        (zeroed, torch.as_tensor(idx).long())):
        want = torch.zeros((n, h), dtype=torch.float32).index_add_(
            0, index, rows.float())
        if dtype == "f32":
            assert torch.equal(got, want)
        else:  # CPU bf16 index_add_ adds in f32 and rounds once
            assert torch.equal(torch.zeros_like(got).index_add_(
                0, index, rows), want.bfloat16())
            _close(got.float().numpy(), want.numpy(), 0, BF16_SUM_REL)


def test_build_csr_is_a_stable_argsort_of_the_live_edges():
    idx = torch.tensor([3, 1, 3, 0, 1, 3, 0], dtype=torch.int32)
    mask = torch.tensor([1, 1, 0, 1, 1, 1, 0], dtype=torch.float32)
    csr = ss.build_csr(idx, 5, mask)
    assert csr.perm.tolist() == [3, 1, 4, 0, 5]
    assert csr.indptr.tolist() == [0, 1, 3, 3, 5, 5]
    assert csr.perm.dtype == csr.indptr.dtype == torch.int32
    assert csr.live.tolist() == [bool(m) for m in mask]
    assert ss.build_csr(idx, 5, torch.ones(7)).live is None
    assert ss.build_csr(idx, 5).n_edges == 7


@pytest.mark.parametrize("masked", [False, True])
def test_segment_sum_and_gather_functions_match_autograd_in_f64(masked):
    """SegmentSum against autograd of index_add_ over the live edges, and
    Gather (used as the GNN uses it: its rows times the mask) against
    autograd of index_select times the mask."""
    rng = np.random.default_rng(3)
    e, n, h = 300, 40, 7
    idx, mask = _index("padded" if masked else "power_law", e, n, rng)
    it, mt = torch.as_tensor(idx).long(), torch.as_tensor(mask).double()
    csr = ss.build_csr(it, n, mt)
    x = torch.as_tensor(rng.normal(size=(e, h))).requires_grad_()
    y = torch.as_tensor(rng.normal(size=(n, h))).requires_grad_()
    up_n = torch.as_tensor(rng.normal(size=(n, h)))
    up_e = torch.as_tensor(rng.normal(size=(e, h)))

    (gx,) = torch.autograd.grad(ss.seg_sum(x, csr), x, up_n)
    plain = torch.zeros(n, h, dtype=x.dtype).index_add(0, it, x * mt[:, None])
    (wx,) = torch.autograd.grad(plain, x, up_n)
    torch.testing.assert_close(ss.seg_sum(x, csr), plain, rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(gx, wx, rtol=1e-12, atol=1e-12)

    got = ss.gather(y, csr) * mt[:, None]
    want = y.index_select(0, it) * mt[:, None]
    assert torch.equal(got, want)
    (gy,) = torch.autograd.grad(got, y, up_e)
    (wy,) = torch.autograd.grad(want, y, up_e)
    torch.testing.assert_close(gy, wy, rtol=1e-12, atol=1e-12)


def test_segment_sum_counts_no_launch_on_the_cpu():
    ops.reset_launches()
    csr = ss.build_csr(torch.tensor([0, 1, 1]), 2)
    ss.segment_sum(torch.ones(3, 4), csr)
    assert ops.launch_counts()["segment_sum"] == 0
    assert ss.segment_sum in ops.WRAPPERS


# ------------------------------------------------------------- the model
SMOKE_GRAPH = (0, 100, 400, 32, 5, 512)  # tests/test_archs_smoke.py
SMOKE_MOLECULE = (0, 0, 4, 10, 20, 8)


def _node_inputs():
    seed, n, e, f, c, pad = SMOKE_GRAPH
    return JS.random_graph(seed, n, e, f, c, pad_edges_to=pad)


def _molecule_inputs():
    return JS.molecule_batch(*SMOKE_MOLECULE)


def _configs(task, comm=None):
    jc = jregistry.get("gatedgcn").smoke_model
    tc = registry.get("gatedgcn").smoke_model
    if task == "graph":
        over = dict(d_feat=8, n_classes=1, task="graph")
        jc, tc = (dataclasses.replace(jc, **over),
                  dataclasses.replace(tc, **over))
    if comm:
        jc = dataclasses.replace(jc, comm_dtype=jnp.bfloat16)
        tc = dataclasses.replace(tc, comm_dtype=torch.bfloat16)
    return jc, tc


def _jbatch(raw):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in raw.items()}


def _tbatch(raw):
    return {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
            for k, v in raw.items()}


def _forward_both(task, comm=None):
    jc, tc = _configs(task, comm)
    params = J.init_gnn(jax.random.PRNGKey(0 if task == "node" else 1), jc)
    raw = _node_inputs() if task == "node" else _molecule_inputs()
    jb, tb = _jbatch(raw), _tbatch(raw)
    model = gnn_from_numpy(_np(params), tc, "cpu")
    want = J.gnn_forward(params, jb["node_feats"], jb["edge_src"],
                         jb["edge_dst"], jb["edge_mask"], jc, DEFAULT_RULES,
                         graph_ids=jb.get("graph_ids"),
                         n_graphs=jb.get("n_graphs", 0))
    with torch.no_grad():
        got = G.gnn_forward(model, tb["node_feats"], tb["edge_src"],
                            tb["edge_dst"], tb["edge_mask"],
                            graph_ids=tb.get("graph_ids"),
                            n_graphs=tb.get("n_graphs", 0))
    return jc, params, jb, model, tb, want, got


CASES = [("node", None), ("graph", None), ("node", "bf16"), ("graph", "bf16")]


@pytest.mark.parametrize("task,comm", CASES)
def test_forward_and_loss_match_reference(task, comm):
    jc, params, jb, model, tb, want, got = _forward_both(task, comm)
    rel = BF16_REL if comm else F32_ATOL_REL
    assert got.shape == want.shape
    _close(got.numpy(), np.asarray(want), F32_RTOL, rel)
    jl = J.gnn_loss(params, jb, jc, DEFAULT_RULES)
    with torch.no_grad():
        tl = G.gnn_loss(model, tb)
    _close(float(tl), float(jl), F32_RTOL if not comm else BF16_REL, 0)


@pytest.mark.parametrize("task,comm", CASES)
def test_gradients_of_every_leaf_match_jax(task, comm):
    jc, params, jb, model, tb, _, _ = _forward_both(task, comm)
    jl, jg = jax.value_and_grad(
        lambda p: J.gnn_loss(p, jb, jc, DEFAULT_RULES))(params)
    tl, tg = steps.value_and_grad(model, tb, G.gnn_loss)
    jg = _np(jg)
    assert len(tg) == 4 + 7 * model.cfg.n_layers
    for name, g in tg.items():
        want = _leaf(jg, name)
        assert g.shape == want.shape, name
        bound = (BF16_REL if comm else GRAD_REL) * max(np.abs(want).max(),
                                                       1e-30)
        assert np.abs(g.numpy() - want).max() <= bound, name
    # the last layer's ln_e reaches no output: a zero gradient, as JAX's
    last = f"layers.{model.cfg.n_layers - 1}.ln_e"
    assert not tg[last].any() and not _leaf(jg, last).any()


def test_forward_runs_the_segment_sum_functions(monkeypatch):
    """Every gather and segment sum of a layer goes through the kernel's
    Functions: 4 gathers and 2 sums a layer, 2 more sums for the
    molecule readout."""
    calls = {"gather": 0, "seg_sum": 0}
    for name in calls:
        real = getattr(G, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(G, name, counted)
    _, _, _, model, tb, _, _ = _forward_both("graph")
    layers = model.cfg.n_layers
    assert calls == {"gather": 4 * layers, "seg_sum": 2 * layers + 2}


def _dst_partitioned(n=64, e=256):
    """tests/test_distributed.py::test_gnn_shardmap_matches_gspmd_reference's
    input: edges dst-partitioned over 2 node shards, each group padded to a
    multiple of 4 with (0 → the shard's first node, mask 0)."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(n, 8)).astype(np.float32)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    srcs, dsts, masks = [], [], []
    per = -(-max((dst // (n // 2) == i).sum() for i in range(2)) // 4) * 4
    for i in range(2):
        sel = dst // (n // 2) == i
        s_, d_ = src[sel], dst[sel]
        pad = per - len(s_)
        srcs.append(np.pad(s_, (0, pad)))
        dsts.append(np.pad(d_, (0, pad), constant_values=i * (n // 2)))
        m = np.zeros(per, np.float32)
        m[: len(s_)] = 1
        masks.append(m)
    raw = {"node_feats": feats, "edge_src": src, "edge_dst": dst,
           "edge_mask": np.ones(e, np.float32)}
    return raw, tuple(map(np.concatenate, (srcs, dsts, masks)))


def test_dst_partition_is_the_reference_tests_layout():
    raw, want = _dst_partitioned()
    got = G.dst_partition(raw, 2, 4)
    for key, w in zip(("edge_src", "edge_dst", "edge_mask"), want):
        np.testing.assert_array_equal(got[key], w)
    np.testing.assert_array_equal(got["node_feats"], raw["node_feats"])


def _mesh_model():
    jc = J.GNNConfig("g", n_layers=3, d_hidden=16, d_feat=8, n_classes=5)
    tc = G.GNNConfig("g", n_layers=3, d_hidden=16, d_feat=8, n_classes=5)
    params = J.init_gnn(jax.random.PRNGKey(0), jc)
    return jc, params, gnn_from_numpy(_np(params), tc, "cpu")


@pytest.mark.parametrize("axes", [(("data", "model"), (2, 4)),
                                  (("pod", "data", "model"), (1, 2, 2))])
def test_mesh_form_matches_reference_and_one_device(axes):
    jc, params, model = _mesh_model()
    raw, (src, dst, mask) = _dst_partitioned()
    want = J.gnn_forward(params, jnp.asarray(raw["node_feats"]),
                         jnp.asarray(src), jnp.asarray(dst),
                         jnp.asarray(mask), jc, DEFAULT_RULES)
    mesh = make_mesh(*axes, device="cpu")
    args = [torch.as_tensor(a) for a in (raw["node_feats"], src, dst, mask)]
    with torch.no_grad():
        got = G.gnn_forward_sharded(model, *args, mesh)
        one = G.gnn_forward(model, *args)
    assert got.shape == (64, 5)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < WIRE_ATOL
    assert float((got - one).abs().max()) < WIRE_ATOL
    # an edge on a shard that does not own its destination is masked:
    # shifting every edge block one node shard over drops them all
    rolled = [torch.roll(a, src.shape[0] // 2) for a in args[1:]]
    with torch.no_grad():
        off = G.gnn_forward_sharded(model, args[0], *rolled, mesh)
        none = G.gnn_forward(model, args[0], *rolled[:2],
                             torch.zeros_like(args[3]))
    assert float((off - none).abs().max()) < WIRE_ATOL


def test_comm_cell_trains_on_the_single_process_mesh():
    """One step of the comm variant (the reference's debug mesh, data=2,
    model=4) against the one-device cell from the same weights."""
    dims = dict(n_nodes=64, n_edges=256, d_feat=8, n_classes=5)
    tc = G.GNNConfig("g", n_layers=3, d_hidden=16, d_feat=8, n_classes=5)
    arch = dataclasses.replace(registry.get("gatedgcn"), model=tc, shapes=(
        ShapeSpec("full_graph_sm", "train_graph", dims),))
    comm = steps.build_cell(arch, "full_graph_sm", "comm")
    base = steps.build_cell(arch, "full_graph_sm")
    assert comm.args[2]["edge_src"].shape == (256,)
    raw, (src, dst, mask) = _dst_partitioned()
    labels = np.random.default_rng(1).integers(0, 5, 64).astype(np.int32)
    batch = {"node_feats": torch.as_tensor(raw["node_feats"]),
             "edge_src": torch.as_tensor(src), "edge_dst": torch.as_tensor(
                 dst), "edge_mask": torch.as_tensor(mask),
             "labels": torch.as_tensor(labels)}
    _, params, _ = _mesh_model()
    losses = []
    for cell in (comm, base):
        model = gnn_from_numpy(_np(params), tc, "cpu")
        state = topt.opt_init(model, arch.opt)
        _, _, out = cell.fn(model, state, batch)
        losses.append(float(out["loss"]))
        assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    assert np.isfinite(losses[0]) and abs(losses[0] - losses[1]) < WIRE_ATOL
    with pytest.raises(ValueError):
        steps.build_cell(registry.get("gatedgcn"), "molecule", "comm")


# ------------------------------------------------------------ generators
def _equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype


@pytest.mark.parametrize("args", [(0, 100, 400, 32, 5, 512),
                                  (3, 2708, 10556, 16, 7, None)])
def test_random_graph_equals_reference(args):
    *a, pad = args
    _equal(S.random_graph(*a, pad_edges_to=pad),
           JS.random_graph(*a, pad_edges_to=pad))


def test_sampled_block_and_molecule_batch_equal_reference():
    args = (0, 2, 50000, 64, (15, 10), 16, 41, 12000, 11000)
    _equal(S.sampled_block(*args), JS.sampled_block(*args))
    small = (1, 0, 5000, 32, (4, 3), 8, 5, 600, 300)  # cut at pad_edges
    _equal(S.sampled_block(*small), JS.sampled_block(*small))
    _equal(S.molecule_batch(0, 1, 4, 10, 20, 8),
           JS.molecule_batch(0, 1, 4, 10, 20, 8))


def test_neighbor_sampler_equals_reference_and_respects_fanout():
    g = S.random_graph(0, 500, 3000, 8, 5, pad_edges_to=3000)
    sampler = S.NeighborSampler(g["edge_src"], g["edge_dst"], 500)
    jsampler = JS.NeighborSampler(g["edge_src"], g["edge_dst"], 500)
    block = sampler.sample(np.arange(16), (5, 3), np.random.default_rng(0))
    _equal(block, jsampler.sample(np.arange(16), (5, 3),
                                  np.random.default_rng(0)))
    assert block["edge_src"].max() < len(block["global_ids"])
    assert (block["edge_dst"] < 16).sum() <= 16 * 5  # hop-1 ≤ fanout


def test_gnn_shapes_equal_reference():
    from repro.configs.base import GNN_SHAPES as JGNN_SHAPES

    assert [(s.name, s.kind, s.dims) for s in GNN_SHAPES] == [
        (s.name, s.kind, s.dims) for s in JGNN_SHAPES]
    arch, jarch = registry.get("gatedgcn"), jregistry.get("gatedgcn")
    for a, b in ((arch.model, jarch.model),
                 (arch.smoke_model, jarch.smoke_model)):
        assert (a.name, a.n_layers, a.d_hidden, a.d_feat, a.n_classes,
                a.task) == (b.name, b.n_layers, b.d_hidden, b.d_feat,
                            b.n_classes, b.task)
    assert (arch.opt.name, arch.opt.lr, arch.source) == (
        jarch.opt.name, jarch.opt.lr, jarch.source)


# ---------------------------------------------------- train cell and CLI
def test_build_cell_full_size_shapes():
    arch = registry.get("gatedgcn")
    want = {"full_graph_sm": ((2708, 1433), (10556,), "labels", 7),
            "minibatch_lg": ((170496, 602), (169984,), "labels", 41),
            "ogb_products": ((2449029, 100), (61859140,), "labels", 47),
            "molecule": ((3840, 28), (8192,), "graph_ids", 1)}
    for name, (feats, edges, key, classes) in want.items():
        cell = steps.build_cell(arch, name)
        model, state, batch = cell.args
        assert batch["node_feats"].shape == feats
        assert batch["edge_src"].shape == batch["edge_mask"].shape == edges
        assert key in batch and batch["node_feats"].device.type == "meta"
        assert model.head_w.shape == (70, classes)
        assert cell.arch.model.task == ("graph" if name == "molecule"
                                        else "node")
        assert state["leaves"]["layers"]["U"]["m"].shape == (16, 70, 70)
    comm = steps.build_cell(arch, "full_graph_sm", "comm")
    assert comm.args[2]["node_feats"].shape == (2708, 1433)
    assert comm.args[2]["edge_src"].shape == (10560,)  # 8 edge shards


def test_init_and_optimizer_tree_match_reference():
    tc = registry.get("gatedgcn").smoke_model
    jc = jregistry.get("gatedgcn").smoke_model
    model = G.init_gnn(tc, torch.Generator().manual_seed(0), "cpu")
    params = J.init_gnn(jax.random.PRNGKey(0), jc)
    shapes = jax.tree.map(lambda a: a.shape, _np(params))
    assert jax.tree.map(lambda a: a.shape, gnn_to_numpy(model)) == shapes
    tree = gnn_to_numpy(model)
    assert not tree["embed_b"].any() and (tree["layers"]["ln_h"] == 1).all()
    # N(0, 1/fan_in): the (L, H, H) stacks' std near 1/√H
    assert abs(tree["layers"]["U"].std() * np.sqrt(16) - 1) < 0.1
    state = topt.opt_init(model, topt.OptConfig(name="adamw"))
    jstate = jopt.opt_init(params, jregistry.get("gatedgcn").opt)
    assert jax.tree.map(lambda a: tuple(a.shape), _np(jstate["leaves"])) == \
        jax.tree.map(lambda a: tuple(a.shape), state["leaves"])
    # the round trip is exact
    again = load_gnn_tree(G.GatedGCN(tc, "cpu"), _np(params))
    for a, b in zip(jax.tree.leaves(gnn_to_numpy(again)),
                    jax.tree.leaves(_np(params))):
        np.testing.assert_array_equal(a, b)


def test_train_cell_adamw_step_matches_reference_cell():
    """One step of the reference's ``_gnn_train_cell`` on a one-device mesh
    with Auto axes against the port's cell, from the same weights and
    batch."""
    dims = dict(n_nodes=100, n_edges=512, d_feat=32, n_classes=5)
    jarch = dataclasses.replace(
        jregistry.get("gatedgcn"), model=jregistry.get("gatedgcn").smoke_model,
        shapes=(JShapeSpec("full_graph_sm", "train_graph", dims),))
    arch = dataclasses.replace(
        registry.get("gatedgcn"), model=registry.get("gatedgcn").smoke_model,
        shapes=(ShapeSpec("full_graph_sm", "train_graph", dims),))
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    jcell = jbuild_cell(jarch, "full_graph_sm", mesh)
    params = J.init_gnn(jax.random.PRNGKey(0), jarch.model)
    host = _np(params)
    raw = _node_inputs()
    jb = _jbatch(raw)
    g_ref = _np(jax.grad(lambda p: J.gnn_loss(p, jb, jarch.model,
                                              DEFAULT_RULES))(params))
    with mesh:
        new_params, new_state, metrics = jcell.jit()(
            params, jopt.opt_init(params, jarch.opt), jb)
    lr = float(jopt._schedule(jarch.opt, new_state["step"]))

    cell = steps.build_cell(arch, "full_graph_sm")
    assert cell.args[2]["edge_src"].shape == (512,)
    model = gnn_from_numpy(host, arch.model, "cpu")
    state = topt.opt_init(model, arch.opt)
    _, _, out = cell.fn(model, state, _tbatch(raw))
    np.testing.assert_allclose(float(out["loss"]), float(metrics["loss"]),
                               rtol=1e-5)
    after = gnn_to_numpy(model)
    for a, b0, w, g in zip(jax.tree.leaves(after), jax.tree.leaves(host),
                           jax.tree.leaves(_np(new_params)),
                           jax.tree.leaves(g_ref)):
        off = np.abs((a - b0) - (w - b0))
        assert off.max() <= 2.01 * lr, off.max() / lr
        big = np.abs(g) >= 1e-3 * np.abs(g).max()
        if big.any():
            assert off[big].max() <= 0.01 * lr, off[big].max() / lr
    assert int(state["step"]) == 1


def test_gnn_training_checkpoint_restores_in_the_reference(tmp_path):
    """The trainer's checkpoint of a GNN is the reference's (params,
    opt_state) tree: the reference restores it bit for bit."""
    jc = jregistry.get("gatedgcn").smoke_model
    out = train.main(["--arch", "gatedgcn", "--smoke", "--steps", "2",
                      "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    model, state = out["params"], out["opt_state"]
    params = J.init_gnn(jax.random.PRNGKey(9), jc)
    like = (params, jopt.opt_init(params, jregistry.get("gatedgcn").opt))
    rp, rs = jckpt.restore_checkpoint(str(tmp_path), like)
    assert jax.tree.structure((rp, rs)) == jax.tree.structure(like)
    for a, b in zip(jax.tree.leaves((rp, rs)),
                    jax.tree.leaves((gnn_tree(model), state))):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      b.float().numpy())


def test_train_cli_gnn_smoke_trains_and_resumes(tmp_path, capsys):
    args = ["--arch", "gatedgcn", "--smoke", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    first = train.main(args + ["--steps", "3"])
    assert len(first["losses"]) == 3 and np.isfinite(first["losses"]).all()
    assert ckpt.latest_step(str(tmp_path)) == 3
    second = train.main(args + ["--steps", "5"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert second["last_step"] == 4 and len(second["losses"]) == 2
    assert np.isfinite(second["losses"]).all()
    mol = train.main(["--arch", "gatedgcn", "--smoke", "--shape", "molecule",
                      "--steps", "2", "--device", "cpu"])
    assert mol["params"].cfg.task == "graph"
    assert np.isfinite(mol["losses"]).all()


def test_train_cli_ogb_products_waits_for_the_launcher():
    """In one process ogb_products raises, naming its per-device bytes on
    the 16x16 mesh it trains on (the dry run's), and that one card's 8
    ranks share its memory."""
    with pytest.raises(NotImplementedError,
                       match=r"17\.3 GB.*16x16 mesh \(launch\.dryrun\) a "
                       r"device holds \d+\.\d{3} GB of arguments \+ temps "
                       r"\(\d+ \+ \d+ bytes\).*--production-mesh.*8 ranks "
                       r"of one card share that card's memory"):
        train.main(["--arch", "gatedgcn", "--shape", "ogb_products",
                    "--device", "cpu"])


def test_full_size_batches_fit_their_cells():
    """Each full-size shape's generator yields the batch its cell
    describes (the reference feeds its 200-node smoke graph at every
    shape: ROADMAP B10)."""
    arch = registry.get("gatedgcn")
    for name in ("full_graph_sm", "molecule"):
        cell = steps.build_cell(arch, name)
        batch = next(train._gnn_batches(cell.shape))
        for key, meta in cell.args[2].items():
            assert np.asarray(batch[key]).shape == tuple(meta.shape), key
