"""The recsys family sharded over a mesh of ranks (``torch.distributed``,
gloo on the CPU): the DTensor lookup against the reference's plain
lookup, and the four smoke models' steps against the port's one-process
run, which ``tests/test_torch_recsys_train.py`` holds to the reference.

One spawn of 4 ranks on ``data=2, model=2`` (``launch/dist.py::spawn``)
runs every 4-rank case; one spawn of 1 rank the 1×1 mesh.

- The lookup of a DTensor table (rows over ``model``) at ids split over
  ``data`` (and at a ragged batch, whose ids are replicated, and at ids
  split over every axis) is bitwise the reference's plain ``jnp.take``
  lookup, and its f32 table gradient within 1e-6 of the reference's
  (relative to the largest entry; seen: 0).
- FM, BERT4Rec, MIND and DIEN (smoke models, the train CLI's batches)
  train one step on the mesh: the loss, the step-1 gradients gathered
  whole and the updated parameters within 1e-5 of the one-process step
  (of each gradient's largest value; absolute on parameters and loss),
  every rank's loss equal, two mesh runs bitwise equal, and each rank's
  collectives (count and bytes by kind) equal to the dry run's count of
  the same cell on a fake group of the same mesh.
- Their scores and top-10 retrieval over every item (FM over its
  candidate rows) on the mesh equal the one-process outputs: scores
  within 1e-5, ids equal (the two-stage top k).
- Held in the ranks (``mesh_run.train(against=...)``, what
  ``chip_smoke.py``'s phases 20 and 21 do at full width): each rank's
  blocks of the step-1 gradients, the parameters and the updates against
  the one-process run's leaves saved whole give, summed over each copy
  of a leaf (``mesh_run.held``), the distance of the whole leaves; each
  rank's block of a whole parameter (``mesh_run._rank_block``) is the
  DTensor's own local block, for every placement the LM's and the recsys
  models' rules give on the mesh.
- A 1×1 mesh step is bitwise the plain step (its rank runs as many torch
  threads as the pytest process: a CPU product's bits depend on how many
  threads split it); a checkpoint saved on 2×2
  restores on 1×1 bitwise; the train CLI on ``--mesh data=2,model=2``
  trains FM and resumes.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.embedding import embedding_lookup as jlookup
from repro_torch.distributed.embedding import embedding_lookup
from repro_torch.distributed.sharding import distribute
from repro_torch.launch import dist, dryrun, mesh_run, steps, train
from repro_torch.launch.mesh import device_mesh

F32_TOL = 1e-5
LOOKUP_TOL = 1e-6
MESH = (("data", "model"), (2, 2))
ONE = (("data", "model"), (1, 1))
RECS = ("fm", "bert4rec", "mind", "dien")
# (rows of ids, the ids' spec): split over data, ragged (replicated),
# split over every axis
LOOKUPS = {"data": (16, (("data",), None)), "ragged": (6, (None, None)),
           "every": (16, (("data", "model"), None))}


def _lookup_inputs(rows):
    rng = np.random.default_rng(7)
    table = rng.normal(size=(512, 8)).astype(np.float32)
    ids = rng.integers(-1, 512, (rows, 5)).astype(np.int32)
    ids[0, :3] = 0  # a repeated row
    cot = rng.normal(size=(rows, 5, 8)).astype(np.float32)
    return table, ids, cot


def _mesh_lookups(launch):
    mesh = device_mesh(*MESH, "cpu")
    out = {}
    for case, (rows, spec) in LOOKUPS.items():
        table, ids, cot = _lookup_inputs(rows)
        t = torch.nn.Parameter(distribute(torch.as_tensor(table), mesh,
                                          ("model", None)))
        i = distribute(torch.as_tensor(ids), mesh, spec)
        emb = embedding_lookup(t, i)
        (emb * distribute(torch.as_tensor(cot), mesh, spec
                          + (None,))).sum().backward()
        out[case] = (emb.full_tensor().detach(), t.grad.full_tensor())
    return out


def _archs():
    return {n: mesh_run.rec_arch(n) for n in RECS}


def _rank_blocks(launch):
    """Whether each rank's block of each whole parameter is the DTensor's
    own block, for the smoke LM's and the recsys models' placements."""
    mesh = device_mesh(*MESH, "cpu")
    out = {}
    for arch in [mesh_run.smoke_arch("smollm-360m")] + list(
            _archs().values()):
        model = mesh_run._init(arch, launch.device, 0)
        steps.place_params(model, mesh_run._logical(arch), arch.rules, mesh)
        for n, p in model.named_parameters():
            block = mesh_run._rank_block(p.full_tensor(), mesh, p.placements)
            out[f"{arch.name} {n} {p.placements}"] = torch.equal(
                block, p.to_local())
    return out


def _ranks(launch, archs, refs, ckpt, cli):
    out = {"lookup": _mesh_lookups(launch), "blocks": _rank_blocks(launch)}
    for n, a in archs.items():
        out[n] = [mesh_run.train(launch, a, mesh_axes=MESH, want_grads=True,
                                 want_params=True, **kw)
                  for kw in (dict(want_updates=True, against=refs[n]), {})]
        out[n + " serve"] = mesh_run.rec_serve(launch, a, mesh_axes=MESH)
    out["ckpt"] = mesh_run.train_checkpoint(launch, archs["bert4rec"], ckpt,
                                            save_axes=MESH)
    torch.distributed.barrier()
    args = ["--arch", "fm", "--smoke", "--mesh", "data=2,model=2",
            "--device", "cpu", "--ckpt-dir", cli]
    first = train.main(args + ["--steps", "2"])
    second = train.main(args + ["--steps", "3"])
    out["cli"] = [(r["last_step"], r["losses"]) for r in (first, second)]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    archs = _archs()
    ckpt = tmp_path_factory.mktemp("rec_ckpt")
    cli = tmp_path_factory.mktemp("rec_cli")
    saved = tmp_path_factory.mktemp("rec_leaves")
    one = {n: mesh_run.train("cpu", a, want_grads=True, want_params=True,
                             want_updates=True)
           for n, a in archs.items()}
    refs = {}
    for n, r in one.items():
        refs[n] = str(saved / f"{n}.pt")
        torch.save({k: r[k] for k in ("grads", "params", "updates")},
                   refs[n])
    mesh = dist.spawn(_ranks, 4, archs, refs, str(ckpt), str(cli),
                      timeout=600)
    return mesh, one, ckpt


@pytest.mark.parametrize("case", sorted(LOOKUPS))
def test_mesh_lookup_is_the_reference_plain_lookup(runs, case):
    mesh, _, _ = runs
    table, ids, cot = _lookup_inputs(LOOKUPS[case][0])
    want, vjp = jax.vjp(lambda t: jlookup(t, jnp.asarray(ids)),
                        jnp.asarray(table))
    (gwant,) = vjp(jnp.asarray(cot))
    want, gwant = np.asarray(want), np.asarray(gwant)
    for r in mesh:
        emb, grad = r["lookup"][case]
        np.testing.assert_array_equal(emb.numpy(), want)
        err = np.abs(grad.numpy() - gwant).max() / np.abs(gwant).max()
        assert err <= LOOKUP_TOL, (case, err)


@pytest.mark.parametrize("name", RECS)
def test_mesh_step_matches_the_one_process_step(runs, name):
    mesh, one, _ = runs
    want = one[name]
    first = mesh[0][name][0]
    for r in mesh:
        got, again = r[name]
        assert got["losses"] == first["losses"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                                   atol=F32_TOL)
        assert sorted(got["grads"]) == sorted(want["grads"])
        for leaf, g in want["grads"].items():
            err = (got["grads"][leaf] - g).abs().max() / g.abs().max()
            assert err <= F32_TOL, (name, leaf, float(err))
        for leaf, p in want["params"].items():
            np.testing.assert_allclose(got["params"][leaf], p, rtol=0,
                                       atol=F32_TOL, err_msg=leaf)
        # two mesh runs: the same bits
        assert again["losses"] == got["losses"]
        for key in ("grads", "params"):
            for leaf, t in got[key].items():
                assert torch.equal(again[key][leaf], t), (name, key, leaf)
        assert got["collectives"] == first["collectives"]
        assert all(v == 0 for v in got["launches"][0].values())


def _rel64(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm()) if b.norm() else float(
        (a - b).norm())


@pytest.mark.parametrize("name", RECS)
def test_held_in_the_ranks_is_the_distance_of_the_whole_leaves(runs, name):
    mesh, one, _ = runs
    reports = [r[name][0] for r in mesh]
    for key in ("grads", "params", "updates"):
        assert sorted(reports[0]["held"][key]) == sorted(one[name][key])
        for leaf, want in one[name][key].items():
            whole = max(_rel64(r[key][leaf], want) for r in reports)
            got = mesh_run.held(reports, key, leaf)
            assert got == pytest.approx(whole, rel=1e-6, abs=1e-12), (
                key, leaf, got, whole)


def test_rank_block_is_the_dtensor_block(runs):
    mesh, _, _ = runs
    for r in mesh:
        assert r["blocks"] and all(r["blocks"].values()), [
            k for k, ok in r["blocks"].items() if not ok]
    placements = {k.split(" ", 2)[2] for k in mesh[0]["blocks"]}
    assert "(Shard(dim=0), Shard(dim=1))" in placements, placements


@pytest.mark.parametrize("name", RECS)
def test_ranks_collectives_equal_the_dry_run(runs, name):
    mesh, _, _ = runs
    arch = _archs()[name]
    with dist.fake_group(4):
        costs, _, _ = dryrun.count_cell(arch, "train_batch",
                                        mesh=device_mesh(*MESH, "cpu"))
    counts = costs.collectives["_counts"]
    got = mesh[0][name][0]["collectives"][0]
    assert sum(counts.values()) > 0
    for kind, c in counts.items():
        assert got.get(kind, {"count": 0})["count"] == c, (name, kind)
        assert got.get(kind, {"bytes": 0})["bytes"] == \
            costs.collectives[kind], (name, kind)


@pytest.mark.parametrize("name", RECS)
def test_mesh_serving_matches_the_one_process_run(runs, name):
    mesh, _, _ = runs
    want = mesh_run.rec_serve("cpu", _archs()[name])
    for r in mesh:
        got = r[name + " serve"]
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                                   atol=F32_TOL)
        np.testing.assert_allclose(got["values"], want["values"], rtol=0,
                                   atol=F32_TOL)
        assert torch.equal(got["ids"], want["ids"]), name


def _one_by_one(launch, archs, ckpt):
    out = {n: mesh_run.train(launch, a, mesh_axes=ONE, want_grads=True,
                             want_params=True)
           for n, a in archs.items()}
    out["restored"] = mesh_run.train_checkpoint(
        launch, archs["bert4rec"], ckpt, restore_axes=ONE)
    return out


def test_one_by_one_mesh_is_bitwise_the_plain_step_and_restores(runs):
    mesh, one, ckpt = runs
    archs = _archs()
    # the rank's torch threads as this process's: a product's bits depend
    # on how many threads split it
    (got,) = dist.spawn(_one_by_one, 1, archs, str(ckpt), timeout=300,
                        threads=torch.get_num_threads())
    for n in RECS:
        assert got[n]["losses"] == one[n]["losses"], n
        for key in ("grads", "params"):
            for leaf, t in one[n][key].items():
                assert torch.equal(got[n][key][leaf], t), (n, key, leaf)
    saved = mesh[0]["ckpt"]["saved"]
    restored = got["restored"]["restored"]
    assert len(saved) == len(restored)
    assert all(torch.equal(a, b) for a, b in zip(saved, restored))
    assert "Shard(dim=0)" in " ".join(got["restored"]["placements"])


def test_train_cli_trains_fm_on_the_mesh_and_resumes(runs):
    mesh, _, _ = runs
    for r in mesh:
        (last1, losses1), (last2, losses2) = r["cli"]
        assert last1 == 1 and len(losses1) == 2
        assert last2 == 2 and len(losses2) == 1  # resumed from step 2
        assert np.isfinite(losses1 + losses2).all()
    assert all(r["cli"] == mesh[0]["cli"] for r in mesh)


def test_table_gradient_is_reduced_once():
    """ROADMAP A11: a gradient that is a partial sum over the batch axes
    is all-reduced once (``steps.value_and_grad``), not at each of the
    optimizer's three reads of it. FM's step all-reduces its table
    shards' gradient over ``data`` and its lookups' partial rows over
    ``model``, and a few scalars (the loss's mean, the global norm)."""
    arch = _archs()["fm"]
    cfg, b = arch.model, arch.shapes[0].dims["batch"]
    sizes = dict(zip(*MESH))
    with dist.fake_group(4):
        costs, _, _ = dryrun.count_cell(arch, "train_batch",
                                        mesh=device_mesh(*MESH, "cpu"))
    width = (cfg.embed_dim + 1) * 4  # v's row and w's, f32
    table = cfg.table_rows // sizes["model"] * width
    psum = b // sizes["data"] * cfg.n_fields * width
    got = costs.collectives["all-reduce"]
    assert table + psum <= got < table + psum + 64
    assert costs.collectives["_counts"]["all-reduce"] <= 10
    assert costs.collectives.get("reduce-scatter", 0) == 0
