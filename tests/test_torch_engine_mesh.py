"""The sharded request engine on meshes of CPU shards: the port's
``MutableShardedBackend`` against its one-device ``MutableLocalBackend``
and the reference's (tests/test_mutation.py::
test_engine_mutation_kinds_sharded_parity), and ``serve --workload cf
--engine --mesh`` end to end, with and without ``--mutations``.

Tolerances: the mesh backend against the port's one-device backend
bitwise (pairs, top-N, generations, tombstone fractions); against the
reference's ``MutableLocalBackend`` on the reference's fit, pair
predictions within rtol=1e-5, atol=1e-6. The CLI runs at ``--smoke`` under
the mesh's 2000 ms read SLO with ``--rate 500``; no other wall-clock bound
is asserted.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.landmark_cf import fit as jfit
from repro.core.types import LandmarkSpec as JSpec
from repro.core.types import RatingMatrix as JRatings
from repro.lifecycle import buckets as jbuckets
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import MutableLocalBackend as JMutableLocalBackend
from repro.serving import RequestEngine as JRequestEngine
from repro_torch.core.convert import landmark_state_from_numpy
from repro_torch.core.types import LandmarkSpec
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.lifecycle import buckets
from repro_torch.serving import (EngineConfig, MutableLocalBackend,
                                 MutableShardedBackend, RequestEngine)

RTOL, ATOL = 1e-5, 1e-6
U, P = 96, 40
KW = dict(n_landmarks=8, selection="popularity", k_neighbors=5, d2="cosine")
JSPEC, SPEC = JSpec(**KW), LandmarkSpec(**KW)
CFG = dict(max_batch=32, min_shape=8, fold_bq=8)
MESHES = {"pod=2,data=4": (("pod", "data"), (2, 4)),
          "data=4": (("data",), (4,))}
UP_IDS = np.array([5, 30, 60])
RM_IDS = np.array([3, 17, 40, 41, 77, 90, 8, 20])


def _ratings(u, p, seed=0, density=0.35):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    return r * (rng.random((u, p)) < density)


@pytest.fixture(scope="module")
def fitted():
    """The reference's fit of a (96, 40) block, carried into the port."""
    jst = jfit(jax.random.PRNGKey(0),
               JRatings(jnp.asarray(_ratings(U, P, seed=16)), U, P), JSPEC)
    st = landmark_state_from_numpy({
        "landmark_idx": np.asarray(jst.landmark_idx),
        "representation": np.asarray(jst.representation),
        "ratings": np.asarray(jst.ratings),
        "graph.indices": np.asarray(jst.graph.indices),
        "graph.weights": np.asarray(jst.graph.weights)}, device="cpu")
    return jst, st


def _mesh_backend(st, mesh_name):
    names, sizes = MESHES[mesh_name]
    sst = buckets.from_state_sharded(st, make_mesh(names, sizes, "cpu"),
                                     names, min_bucket=8)
    u_per = -(-U // sst.shard_count)
    return MutableShardedBackend(sst, np.arange(U) // u_per,
                                 np.arange(U) % u_per, SPEC, min_bucket=8)


def _reads(backend, users, items):
    pub = backend.snapshot()
    return (backend.predict_pairs(pub, users, items),
            *backend.recommend_topn(pub, users, 5))


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_engine_mutation_kinds_sharded_parity(fitted, mesh_name):
    """The same update, removal and fold through the engine's write lane on
    the mesh and on one device: every generation's routed reads are the
    one-device backend's bits (the reference's within the parity rule),
    the publishes carry no dirty row, and after the compacting refresh the
    mesh keeps its logical ids while one device renumbers."""
    jst, st = fitted
    local = MutableLocalBackend(buckets.from_state(st, min_bucket=32), SPEC,
                                min_bucket=32)
    mesh = _mesh_backend(st, mesh_name)
    jbe = JMutableLocalBackend(jbuckets.from_state(jst, min_bucket=32),
                               JSPEC, min_bucket=32)
    engines = [RequestEngine(local, EngineConfig(**CFG)),
               RequestEngine(mesh, EngineConfig(**CFG)),
               JRequestEngine(jbe, JEngineConfig(**CFG))]
    rng = np.random.default_rng(17)
    users, items = rng.integers(0, U, 16), rng.integers(0, P, 16)
    writes = [("update", dict(users=UP_IDS, rows=_ratings(3, P, seed=18))),
              ("remove", dict(users=RM_IDS)),
              ("fold", dict(rows=_ratings(12, P, seed=19)))]
    for gen, (kind, kw) in enumerate(writes, start=1):
        for eng in engines:
            eng.submit(kind, **kw)
            assert eng.pump_folds() == 1
        assert local.generation == mesh.generation == gen
        assert mesh.snapshot()[0].dirty_count() == 0
        assert mesh.tombstone_frac == local.tombstone_frac
        np.testing.assert_array_equal(mesh.tomb(),
                                      local.tomb()[:mesh.n_users])
        assert _same(_reads(mesh, users, items), _reads(local, users,
                                                        items))
        want = np.asarray(jbe.predict_pairs(jbe.snapshot(), users, items))
        np.testing.assert_allclose(_reads(mesh, users, items)[0], want,
                                   rtol=RTOL, atol=ATOL)
    r = engines[1].submit("pair", users=users, items=items)
    engines[1].pump_reads()
    np.testing.assert_array_equal(r.result, _reads(local, users, items)[0])
    checked, bad = engines[1].verify_sample()
    assert checked == 1 and bad == 0

    gen, table = local.refresh()
    gen2, table2 = mesh.refresh()
    jgen, jtable = jbe.refresh()
    assert gen == gen2 == 4 and mesh.tombstone_frac == 0.0
    live = np.setdiff1d(np.arange(U + 12), RM_IDS)
    assert (table2[RM_IDS] == -1).all()
    np.testing.assert_array_equal(table2[live], live)
    np.testing.assert_array_equal(table[live], np.arange(len(live)))
    lu = live[rng.integers(0, len(live), 32)]
    it = rng.integers(0, P, 32)
    assert _same(_reads(mesh, lu, it), _reads(local, table[lu], it))
    want = np.asarray(jbe.predict_pairs(jbe.snapshot(), jtable[lu], it))
    np.testing.assert_allclose(_reads(mesh, lu, it)[0], want, rtol=RTOL,
                               atol=ATOL)


def test_mesh_writes_publish_fresh_generations(fitted):
    """A write never touches the published generation (reads in flight
    keep their bits); ``tomb()`` is indexed by logical id; the write lane
    pads its batches to the mutation shapes and drains before it
    publishes, counting the repaired rows."""
    _, st = fitted
    mesh = _mesh_backend(st, "pod=2,data=4")
    pub = mesh.snapshot()
    kept = [t.clone() for t in mesh._state_tensors(pub[0])]
    rng = np.random.default_rng(3)
    users, items = rng.integers(0, U, 24), rng.integers(0, P, 24)
    before = _reads(mesh, users, items)
    assert mesh.apply_remove(RM_IDS) == 1
    assert mesh.apply_update(UP_IDS, _ratings(3, P, seed=4)) == 2
    assert all(np.array_equal(a.numpy(), b.numpy())
               for a, b in zip(kept, mesh._state_tensors(pub[0])))
    old = (mesh.predict_pairs(pub, users, items),
           *mesh.recommend_topn(pub, users, 5))
    assert _same(old, before)
    assert set(np.flatnonzero(mesh.tomb())) == set(RM_IDS.tolist())
    assert mesh.repaired_rows > 0 and mesh.snapshot()[0].dirty_count() == 0
    assert mesh.apply_remove(np.zeros(0, np.int64)) == 3  # a no-op publish


SMOKE = ["--workload", "cf", "--engine", "--smoke", "--mesh",
         "pod=2,data=4", "--device", "cpu", "--rate", "500"]


def test_engine_cli_on_the_mesh(capsys):
    res = serve.main(SMOKE)
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[1] == "mesh pod=2,data=4: 8 shards on 1 device(s): cpu x8"
    assert "router materialization check:" in out and "0 offenders" in out
    assert ("routed vs single-device reference (32/64/128 queries): "
            "bit-identical=True") in out
    assert "0 mismatches" in out and lines[-1] == "cf engine: done"
    mesh = res["mesh"]
    assert mesh["shards"] == 8 and mesh["router_offenders"] == 0
    assert mesh["routed_bitwise"] and mesh["block_devices"] == ["cpu"]
    # the warm-up fold and the window's folds, one batch each
    assert mesh["fold_batches"] == res["completed"]["fold"] + 1
    assert res["checked"] > 0 and res["mismatches"] == 0


def test_engine_cli_on_the_mesh_with_mutations(capsys):
    res = serve.main(SMOKE + ["--mutations"])
    out = capsys.readouterr().out
    assert "0 offenders" in out and "bit-identical=True" in out
    assert "tombstone_frac=0.000" in out and "refresh swap: gen" in out
    assert ("live users' pairs and top-N bit-identical=True before "
            "compaction") in out
    assert "after compaction bit-identical=True" in out
    assert out.rstrip().endswith("cf engine: done")
    mut, mesh = res["mutations"], res["mesh"]
    assert mut["cites_dead"] == 0 and mut["dirty_published"] == 0
    assert mut["compacted"] > 0 and mut["post_tombstone_frac"] == 0.0
    assert mesh["shadow_before"]["bitwise"] and mesh["shadow_after"]["bitwise"]
    assert mesh["shadow_after"]["users"] > 0
    assert mesh["updates"] >= res["completed"]["update"] >= 1


def test_engine_cli_on_a_one_axis_mesh_with_ivf(capsys):
    res = serve.main(["--workload", "cf", "--engine", "--smoke", "--mesh",
                      "data=4", "--device", "cpu", "--rate", "500",
                      "--retrieval", "ivf", "--early-exit"])
    out = capsys.readouterr().out
    assert "retrieval: sharded ivf C=16" in out
    assert "early-exit recall" in out and "bit-identical=True" in out
    assert res["mesh"]["shards"] == 4 and res["recalls"]
