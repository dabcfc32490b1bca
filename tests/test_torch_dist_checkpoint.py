"""Training checkpoints of a model sharded over a mesh of ranks
(``train/checkpoint.py``), on the CPU with gloo ranks in processes of
their own (``launch/dist.py::spawn``, one spawn of 4 ranks).

- The smoke SmolLM (f32, one AdamW step) saved from ``data=2, model=2``:
  each block is on disk once with its global index range, and the
  restore is bitwise the saved tree on one rank (the pytest process, no
  group) and re-placed on ``data=4`` (every leaf a DTensor of that mesh's
  placements).
- The reference's ``restore_checkpoint`` reads the port's manifest and
  gets the same bits.
- The train CLI on ``--mesh data=2,model=2`` saves at its last step and a
  second run resumes from it, on every rank.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import json

import jax
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt
from repro_torch.launch import dist, mesh_run, train
from repro_torch.models import transformer as T
from repro_torch.models.convert import param_tree
from repro_torch.train.checkpoint import _flatten, restore_checkpoint
from repro_torch.train.optimizer import opt_init


def _arch():
    return mesh_run.smoke_arch("smollm-360m", dtype=torch.float32,
                               backend="full", batch=4, seq=32)


def _ranks(launch, arch, ckpt, cli):
    out = mesh_run.train_checkpoint(
        launch, arch, ckpt, save_axes=(("data", "model"), (2, 2)),
        restore_axes=(("data", "model"), (4, 1)))
    torch.distributed.barrier()
    args = ["--arch", "smollm-360m", "--smoke", "--mesh", "data=2,model=2",
            "--device", "cpu", "--ckpt-dir", cli]
    first = train.main(args + ["--steps", "2"])
    second = train.main(args + ["--steps", "3"])
    out["cli"] = [(r["last_step"], r["losses"]) for r in (first, second)]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("mesh_ckpt")
    cli = tmp_path_factory.mktemp("mesh_cli")
    res = dist.spawn(_ranks, 4, _arch(), str(ckpt), str(cli), timeout=600)
    return res, ckpt


def test_saved_blocks_carry_their_ranges_once(runs):
    res, ckpt = runs
    manifest = json.loads((ckpt / "step_00000001" / "manifest.json")
                          .read_text())
    assert manifest["n_leaves"] == len(res[0]["saved"])
    for meta, whole in zip(manifest["leaves"], res[0]["saved"]):
        assert meta["shape"] == list(whole.shape)
        covered = np.zeros(whole.shape, dtype=np.int32)
        for shard in meta["shards"]:
            idx = tuple(slice(a, b) for a, b in shard["index"]) or ...
            covered[idx] += 1
        assert (covered == 1).all()  # every element once


def test_restore_on_one_rank_and_on_another_mesh_is_bitwise(runs):
    res, ckpt = runs
    saved = res[0]["saved"]
    for r in res:
        assert all(torch.equal(a, b) for a, b in zip(r["saved"], saved))
        assert all(torch.equal(a, b) for a, b in zip(r["restored"], saved))
        assert "Shard(dim=0)" in " ".join(r["placements"])
    arch = _arch()
    model = T.LM(arch.model, "cpu")
    tree = restore_checkpoint(str(ckpt), (param_tree(model),
                                          opt_init(model, arch.opt)),
                              device="cpu")
    one = [x.float() for x in _flatten(tree)]
    assert all(torch.equal(a, b) for a, b in zip(one, saved))


def test_reference_restores_the_port_manifest(runs):
    res, ckpt = runs
    saved = res[0]["saved"]
    like = [np.zeros(tuple(x.shape), np.float32) for x in saved]
    got = jckpt.restore_checkpoint(str(ckpt), like)
    for a, b in zip(jax.tree_util.tree_leaves(got), saved):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.numpy())


def test_train_cli_resumes_on_the_mesh(runs):
    res, _ = runs
    for r in res:
        (last1, losses1), (last2, losses2) = r["cli"]
        assert last1 == 1 and len(losses1) == 2
        assert last2 == 2 and len(losses2) == 1  # resumed from step 2
        assert np.isfinite(losses1 + losses2).all()
    assert all(r["cli"] == res[0]["cli"] for r in res)


def test_train_cli_mesh_needs_a_world_of_its_size():
    with pytest.raises(ValueError, match=r"needs 256 ranks, the world has 1"):
        train.main(["--arch", "smollm-360m", "--smoke", "--production-mesh",
                    "--device", "cpu", "--steps", "1"])
    # the recsys and GNN families too: a world of 1 is not the debug mesh
    with pytest.raises(ValueError, match=r"needs 8 ranks, the world has 1"):
        train.main(["--arch", "fm", "--smoke", "--debug-mesh", "--device",
                    "cpu"])
