"""The dry run (``launch/dryrun.py``) lays the GNN and recsys cells over
the reference's meshes, on the CPU: each cell placed over an in-process
``fake`` group and counted per device.

- ``--debug-mesh`` (2×4) and ``--multi-pod`` (2×16×16) run all 20 GNN and
  recsys cells (the smoke models at the cells' shapes) and exit 0, every
  record with its mesh's ``n_devices`` (8, 512), per-device argument and
  temp bytes and collectives, and no family but CF left on one device;
  the fake group is gone after the run. At 16×16 (256) the full-width
  cells are counted by ``tests/test_torch_dryrun.py``, which holds their
  per-device argument bytes to the reference's shard shapes.
- ``ogb_products`` at full width on 16×16 fits one device of that mesh
  (argument + temp bytes under a card's 80 GB) and moves collective
  bytes; the train CLI's refusal to run it in one process quotes those
  bytes.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import math
import re

import pytest
import torch

from repro_torch.configs import registry
from repro_torch.launch import dist, dryrun, train
from repro_torch.launch.mesh import PRODUCTION, device_mesh

FAMILIES = ("gnn", "recsys")
H100_BYTES = 80 * 10 ** 9  # one H100's memory


@pytest.mark.parametrize("flag,n", [("--debug-mesh", 8), ("--multi-pod",
                                                           512)])
def test_mesh_flags_lay_every_gnn_and_recsys_cell_over_the_mesh(flag, n,
                                                                 capsys):
    recs = []
    for family in FAMILIES:
        recs += dryrun.main(["--all", "--family", family, "--smoke", flag])
    assert not torch.distributed.is_initialized()
    assert "one device" not in capsys.readouterr().out
    cells = {(r["arch"], r["shape"]) for r in recs}
    want = {(name, s.name) for name, arch in registry.ARCHS.items()
            if arch.family in FAMILIES for s in arch.shapes}
    assert cells == want and len(cells) == 20
    for r in recs:
        assert r["n_devices"] == n, (r["arch"], r["shape"])
        assert math.prod(map(int, r["mesh"].split("x"))) == n
        mem = r["memory"]
        assert mem["argument_size_in_bytes"] > 0
        assert mem["temp_size_in_bytes"] >= 0
        moved = sum(v for k, v in r["collectives"].items()
                    if not k.startswith("_"))
        assert moved > 0, (r["arch"], r["shape"])
    train_kernels = {r["arch"]: r["kernels"]["segment_sum"]["calls"]
                     for r in recs if r["shape"] == "train_batch"}
    # row 8 a lookup a step on each rank: FM's v and w share one CSR but
    # each has its backward
    assert train_kernels == {"fm": 2, "bert4rec": 4, "mind": 4, "dien": 2}


def test_ogb_products_fits_a_device_of_the_production_mesh():
    names, sizes = PRODUCTION
    with dist.fake_group(math.prod(sizes)):
        rec = dryrun.run_cell("gatedgcn", "ogb_products", verbose=False,
                              mesh=device_mesh(names, sizes, "cpu"))
    assert (rec["n_devices"], rec["mesh"]) == (256, "16x16")
    mem = rec["memory"]
    arg, temp = mem["argument_size_in_bytes"], mem["temp_size_in_bytes"]
    assert 0 < arg + temp < H100_BYTES
    coll = sum(v for k, v in rec["collectives"].items()
               if not k.startswith("_"))
    assert coll > 0
    # the layers' row-8 launches on each rank: 2 forward, 2 in the remat
    # recompute and 4 backward a layer, 16 layers
    assert rec["kernels"]["segment_sum"]["calls"] == 16 * 8
    with pytest.raises(NotImplementedError) as err:
        train.main(["--arch", "gatedgcn", "--shape", "ogb_products",
                    "--device", "cpu"])
    said = re.search(r"\((\d+) \+ (\d+) bytes\) and moves (\S+) collective",
                     str(err.value))
    assert said and (int(said[1]), int(said[2])) == (arg, temp)
    assert float(said[3]) == pytest.approx(coll, rel=1e-3)
