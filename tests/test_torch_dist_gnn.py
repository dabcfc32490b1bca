"""GatedGCN over a mesh of ranks (``torch.distributed``, gloo on the CPU):
the base form (nodes over ``data``, edges over every axis, the
reference's GSPMD step) against the port's one-process step, and the
``comm`` form (the reference's ``shard_map`` message passing: one bf16
all-gather of h a layer, dst-partitioned edges, bf16 partial sums over
``model``) against the single-process mesh form
(``gnn.gnn_forward_sharded``), which ``tests/test_torch_gnn.py`` holds to
the reference.

One spawn of 4 ranks on ``data=2, model=2`` runs every 4-rank case; one
spawn of 1 rank the 1×1 mesh.

- The smoke model's base step (node task, the train CLI's smoke graph;
  and the graph task on its molecules): the loss, the step-1 gradients
  gathered whole and the updated parameters within 1e-5 of the
  one-process step (of each gradient's largest value; absolute on
  parameters and loss); two mesh runs bitwise equal; every rank's loss
  equal.
- The comm step against the single-process mesh form's on the same
  dst-partitioned batch: the loss and each updated parameter (of its
  largest value) within phase 17c's bound, 2^-7; each gradient
  (Frobenius, relative) within :data:`COMM_GRAD_REL`, set from this
  comparison's own readings. The two add the bf16 partials in another
  order: the forward's two partials per node block (model = 2) give the
  same bits, the backward's reduce-scatter of h's bf16 gradient rounds
  each rank's part before the sum (read: up to 8.59e-3 of a leaf's norm,
  ``layers.1.D``; 0 on some leaves).
- The bound sees a fault the loss and parameter checks miss: with one
  model shard's partial sums dropped on a quarter of its owner's node
  block (planted in the ranks, :func:`_dropped_partial`), the loss moves
  by 7.7e-3 (inside 2^-7) and the parameters by no more than the real
  run's, but gradients move by up to 0.57 of their norm.
- Row 8 counts no launch on the CPU (its plain version runs), and each
  rank's collectives (count and bytes by kind) equal the dry run's count
  of the same cell on a fake group of the same mesh, base and comm.
- A 1×1 mesh step is bitwise the plain step; a checkpoint saved on 2×2
  restores on 1×1 bitwise; the train CLI on ``--mesh data=2,model=2``
  trains and resumes.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)

import numpy as np
import pytest
import torch

from repro_torch.launch import dist, dryrun, mesh_run, train
from repro_torch.launch.mesh import device_mesh
from repro_torch.models import gnn as gnn_mod

F32_TOL = 1e-5
MESH_REL = 2 ** -7  # chip_smoke.py's phase 17c bound
# each comm gradient against the single-process form's (Frobenius,
# relative): about 2.3 times the largest reading, 8.59e-3
COMM_GRAD_REL = 2e-2
MESH = (("data", "model"), (2, 2))
ONE = (("data", "model"), (1, 1))
RUNS = {"base": ("full_graph_sm", "base"), "comm": ("full_graph_sm", "comm"),
        "molecule": ("molecule", "base")}


def _dropped_partial(m, csr, ed, out_pl):
    """``gnn._to_nodes`` with a planted fault: the comm form's partial sums
    of the ranks at model coordinate 1 dropped on the first quarter of
    their owner's node block."""
    dim = ed.mesh.mesh_dim_names.index("model")
    drop = ed.mesh.get_coordinate()[dim] == 1 and out_pl == ed.owner_pl

    def fn(t):
        s = gnn_mod.seg_sum(t, csr)
        if drop:
            keep = torch.ones(s.shape[0], 1, dtype=s.dtype, device=s.device)
            keep[: s.shape[0] // 4] = 0
            s = s * keep
        return s

    return gnn_mod._on_ranks(fn, m, ed.edge_pl, out_pl, ed.edge_pl, ed.mesh)


def _ranks(launch, ckpt, cli):
    out = {}
    for key, (shape, variant) in RUNS.items():
        runs = 2 if key == "base" else 1
        out[key] = [mesh_run.train(
            launch, mesh_run.gnn_arch(shape), variant=variant,
            mesh_axes=MESH, want_grads=True, want_params=True)
            for _ in range(runs)]
    real = gnn_mod._to_nodes
    gnn_mod._to_nodes = _dropped_partial
    try:
        out["planted"] = mesh_run.train(
            launch, mesh_run.gnn_arch(RUNS["comm"][0]), variant="comm",
            mesh_axes=MESH, want_grads=True, want_params=True)
    finally:
        gnn_mod._to_nodes = real
    out["ckpt"] = mesh_run.train_checkpoint(launch, mesh_run.gnn_arch(),
                                            ckpt, save_axes=MESH)
    torch.distributed.barrier()
    args = ["--arch", "gatedgcn", "--smoke", "--mesh", "data=2,model=2",
            "--device", "cpu", "--ckpt-dir", cli]
    first = train.main(args + ["--steps", "2"])
    second = train.main(args + ["--steps", "3"])
    out["cli"] = [(r["last_step"], r["losses"]) for r in (first, second)]
    return out


def _one(key):
    shape, variant = RUNS[key]
    return mesh_run.train("cpu", mesh_run.gnn_arch(shape), variant=variant,
                          comm_axes=MESH, want_grads=True, want_params=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("gnn_ckpt")
    cli = tmp_path_factory.mktemp("gnn_cli")
    mesh = dist.spawn(_ranks, 4, str(ckpt), str(cli), timeout=600)
    return mesh, {key: _one(key) for key in RUNS}, ckpt


@pytest.mark.parametrize("key", ["base", "molecule"])
def test_base_step_matches_the_one_process_step(runs, key):
    mesh, one, _ = runs
    want = one[key]
    for r in mesh:
        got = r[key][0]
        assert got["losses"] == mesh[0][key][0]["losses"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                                   atol=F32_TOL)
        assert sorted(got["grads"]) == sorted(want["grads"])
        for leaf, g in want["grads"].items():
            err = (got["grads"][leaf] - g).abs().max() / max(
                float(g.abs().max()), 1e-30)
            assert err <= F32_TOL, (key, leaf, float(err))
        for leaf, p in want["params"].items():
            np.testing.assert_allclose(got["params"][leaf], p, rtol=0,
                                       atol=F32_TOL, err_msg=leaf)
        assert got["collectives"] == mesh[0][key][0]["collectives"]
        assert all(v == 0 for v in got["launches"][0].values())


def test_two_mesh_runs_are_bitwise_equal(runs):
    mesh, _, _ = runs
    for r in mesh:
        got, again = r["base"]
        assert again["losses"] == got["losses"]
        for key in ("grads", "params"):
            for leaf, t in got[key].items():
                assert torch.equal(again[key][leaf], t), (key, leaf)


def _rel(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


def test_comm_step_within_the_mesh_form_bound(runs):
    mesh, one, _ = runs
    want = one["comm"]
    for r in mesh:
        got = r["comm"][0]
        assert got["losses"] == mesh[0]["comm"][0]["losses"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=MESH_REL)
        assert sorted(got["grads"]) == sorted(want["grads"])
        for leaf, g in want["grads"].items():
            err = _rel(got["grads"][leaf], g)
            assert err <= COMM_GRAD_REL, (leaf, err)
        for leaf, p in want["params"].items():
            err = float((got["params"][leaf] - p).abs().max())
            assert err <= MESH_REL * float(p.abs().max()), (leaf, err)


def test_comm_gradient_bound_catches_a_dropped_partial(runs):
    """A partial sum over ``model`` dropped on part of the nodes passes the
    loss bound but not the gradients' (the planted run of
    :func:`_dropped_partial`)."""
    mesh, one, _ = runs
    want = one["comm"]["grads"]
    for r in mesh:
        got = r["planted"]["grads"]
        errs = {leaf: _rel(got[leaf], g) for leaf, g in want.items()}
        assert max(errs.values()) > 10 * COMM_GRAD_REL, errs


@pytest.mark.parametrize("key", sorted(RUNS))
def test_ranks_collectives_equal_the_dry_run(runs, key):
    mesh, _, _ = runs
    shape, variant = RUNS[key]
    arch = mesh_run.gnn_arch(shape)
    with dist.fake_group(4):
        costs, _, _ = dryrun.count_cell(arch, shape, variant,
                                        mesh=device_mesh(*MESH, "cpu"))
    counts = costs.collectives["_counts"]
    got = mesh[0][key][0]["collectives"][0]
    assert counts["all-gather"] > 0
    for kind, c in counts.items():
        assert got.get(kind, {"count": 0})["count"] == c, (key, kind)
        assert got.get(kind, {"bytes": 0})["bytes"] == \
            costs.collectives[kind], (key, kind)


def _one_by_one(launch, ckpt):
    out = {key: mesh_run.train(launch, mesh_run.gnn_arch(RUNS[key][0]),
                               mesh_axes=ONE, want_grads=True,
                               want_params=True)
           for key in ("base", "molecule")}
    out["restored"] = mesh_run.train_checkpoint(
        launch, mesh_run.gnn_arch(), ckpt, restore_axes=ONE)
    return out


def test_one_by_one_mesh_is_bitwise_the_plain_step_and_restores(runs):
    mesh, one, ckpt = runs
    # the rank's torch threads as this process's: a product's bits depend
    # on how many threads split it
    (got,) = dist.spawn(_one_by_one, 1, str(ckpt), timeout=300,
                        threads=torch.get_num_threads())
    for key in ("base", "molecule"):
        assert got[key]["losses"] == one[key]["losses"], key
        for part in ("grads", "params"):
            for leaf, t in one[key][part].items():
                assert torch.equal(got[key][part][leaf], t), (key, leaf)
    saved = mesh[0]["ckpt"]["saved"]
    restored = got["restored"]["restored"]
    assert len(saved) == len(restored)
    assert all(torch.equal(a, b) for a, b in zip(saved, restored))


def test_train_cli_trains_gatedgcn_on_the_mesh_and_resumes(runs):
    mesh, _, _ = runs
    for r in mesh:
        (last1, losses1), (last2, losses2) = r["cli"]
        assert last1 == 1 and len(losses1) == 2
        assert last2 == 2 and len(losses2) == 1  # resumed from step 2
        assert np.isfinite(losses1 + losses2).all()
    assert all(r["cli"] == mesh[0]["cli"] for r in mesh)
