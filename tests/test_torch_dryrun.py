"""The port's dry run (``repro_torch.launch.dryrun``), its counting
(``launch/step_costs.py``) and the kernels' cost formulas
(``kernels/cost.py``), on the CPU with no card.

- ``--all`` builds every cell of ``all_cells()`` on ``meta`` (the four
  ``landmark_cf`` cells with them) and exits 0: one module-scoped run. Its
  default mesh is the reference's 16×16: the LM, GNN and recsys cells are
  placed over a fake group of 256 and counted per device; the CF cells
  keep their one-device record, as the reference's.
- Each cell's argument bytes equal the sum of the reference cell's
  ``ShapeDtypeStruct`` bytes (``repro.launch.steps.build_cell``; nothing
  lowered or compiled), per device on a 16×16 ``AbstractMesh`` for an LM,
  GNN or recsys cell (the sum of its shard shapes) and on a one-device
  mesh for a CF cell, but for the differences listed in
  ``ARG_BYTES_DIFF``, each a known difference in how the port holds
  state.
- The matrix-product FLOPs of an LM smoke train cell equal the count
  stated in the test; a deep model's counts taken to its depth equal a
  trace of every layer.
- Each kernel's formula at its path shape in ``PERF.md`` §6 gives that
  row's bound.
- A meta call of every wrapper launches nothing, runs no plain version and
  charges its formula once.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import dataclasses
import json
from unittest import mock

import numpy as np
import pytest
import torch

import jax

from repro.configs import registry as jregistry
from repro.launch.steps import build_cell as jbuild_cell
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import (assign_clusters, build, cost, ivf_probe,
                                 knn_topk, ops, ref, score_candidates)
from repro_torch.kernels import landmark_attention as lsum
from repro_torch.kernels import masked_similarity as ms
from repro_torch.kernels import segment_sum as segsum
from repro_torch.launch import dryrun, step_costs

# (arch, shape): the port's argument bytes minus the reference's, and why
ARG_BYTES_DIFF = {
    # the reference's fit takes a jax.random key (2 x uint32); the port's
    # popularity selection takes no generator
    ("landmark_cf", "ml1m_fit"): -8,
    ("landmark_cf", "netflix1m_fit"): -8,
    # and past 100,000 users the reference holds the ratings in bf16,
    # the port in f32 (kernel 1 reads f32): 1,048,576 x 65,536 x 2 B more
    ("landmark_cf", "web_fit"): 1_048_576 * 65_536 * 2 - 8,
}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    recs = dryrun.main(["--all", "--out", str(out)])  # exit 1 raises
    on_disk = json.loads((out / "dryrun_singlepod.json").read_text())
    assert len(on_disk) == len(recs)
    return {(r["arch"], r["shape"], r["variant"]): r for r in recs}


def test_all_cells_pass_with_a_record_each(records):
    cells = dryrun.all_cells()
    assert sorted(records) == sorted(cells)
    assert len([c for c in cells if c[0] == "landmark_cf"]) == 4
    assert len(cells) == 49  # 25 LM, 4 GNN, 16 recsys, 4 CF
    for (arch, _, _), rec in records.items():
        family = registry.get(arch).family
        lm, mesh = family == "lm", family in dryrun.MESH_FAMILIES
        assert (rec["n_devices"], rec["mesh"]) == (
            (256, "16x16") if mesh else (1, "1x1"))
        assert (sum(rec["collectives"]["_counts"].values()) > 0) == mesh
        assert rec["flops"] >= 0 and rec["bytes_accessed"] > 0
        assert set(rec["memory"]) == {"argument_size_in_bytes",
                                      "output_size_in_bytes",
                                      "temp_size_in_bytes"}
        assert "unfused" in rec["bytes_accessed_note"]
        if lm:  # the fsdp weights' all-gathers
            assert rec["collectives"]["_counts"]["all-gather"] > 0
    fit = records["landmark_cf", "ml1m_fit", "base"]
    assert {k: v["calls"] for k, v in fit["kernels"].items()} == {
        "masked_similarity": 1, "topk_sim": 1}
    assert fit["kernel_ops"] == (
        cost.masked_similarity(6040, 20, 3952, True).ops
        + cost.topk(6040, 6040, 20, 13).ops)


def test_argument_bytes_equal_the_reference_cells(records):
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(
        jax.sharding.AxisType.Auto,) * 2)
    prod = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    for (arch, shape, variant), rec in records.items():
        on = registry.get(arch).family in dryrun.MESH_FAMILIES
        jcell = jbuild_cell(jregistry.get(arch), shape, prod if on else mesh,
                            variant)
        want = sum(int(np.prod(leaf.sharding.shard_shape(leaf.shape)
                               if on else leaf.shape))
                   * np.dtype(leaf.dtype).itemsize
                   for leaf in jax.tree_util.tree_leaves(jcell.args))
        got = rec["memory"]["argument_size_in_bytes"]
        assert got - want == ARG_BYTES_DIFF.get((arch, shape), 0), (
            arch, shape, variant, got, want)


def test_lm_smoke_train_matmul_flops_equal_the_analytic_count():
    """SmolLM's smoke model (2 layers, d 96, 3 heads of 32, 1 kv head,
    d_ff 256, vocab 512, tied embedding) at B = 4, S = 128 in one
    attention chunk. A layer's forward: 2·B·S·(d·H·hd + 2·d·Hkv·hd +
    H·hd·d + 3·d·d_ff) for the projections and the GLU, 2·2·B·H·S²·hd for
    the scores and PV. The step runs each layer's forward, its remat
    recompute (which stops once the backward's saved tensors are back, so
    without the last product, the GLU's down projection, 2·B·S·d_ff·d)
    and its backward (twice the forward's products), and the logits
    (2·B·S·d·V) once forward and twice backward:
    L·(4·layer − down) + 3·logits."""
    cfg = registry.get("smollm-360m").smoke_model
    b, s = 4, 128
    arch = dataclasses.replace(registry.get("smollm-360m"), model=cfg,
                               grad_accum={}, shapes=(ShapeSpec(
                                   "train_4k", "train", dict(batch=b,
                                                             seq=s)),))
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layer = (2 * b * s * (d * h * hd + 2 * d * hkv * hd + h * hd * d
                          + 3 * d * cfg.d_ff)
             + 2 * 2 * b * h * s * s * hd)
    down = 2 * b * s * cfg.d_ff * d
    logits = 2 * b * s * d * cfg.vocab
    costs, layers, traced = dryrun.count_cell(arch, "train_4k")
    assert layers == 2 and traced == [(2, 1)]
    assert costs.matmul_flops == (cfg.n_layers * (4 * layer - down)
                                  + 3 * logits)
    assert costs.kernel_ops == 0 and costs.flops == costs.matmul_flops


@pytest.mark.parametrize("arch,shape,variant,layers", [
    ("smollm-360m", "decode_32k", "base", 32),
    ("smollm-360m", "long_500k", "base", 32),
    ("gatedgcn", "molecule", "base", 16),
])
def test_depth_line_equals_every_layer_traced(arch, shape, variant, layers):
    a = registry.get(arch)
    line, n, traced = dryrun.count_cell(a, shape, variant)
    assert n == layers and traced == [(2, 1), (3, 1)]
    full, _, _ = dryrun.count_cell(a, shape, variant, full_depth=True)
    for f in dataclasses.fields(step_costs.StepCosts):
        if f.name != "seconds":
            assert getattr(line, f.name) == getattr(full, f.name), f.name


# (formula, its arguments at the path shape, PERF.md §6's bound in ms as
# printed, and what sets it)
PERF_ROWS = {
    "1 d1 fit": (cost.masked_similarity, (5976, 20, 3952, True), "0.0284",
                 "bytes"),
    "1 d1 fold-in": (cost.masked_similarity, (64, 20, 3952, True),
                     "0.00040", "bytes"),
    "1' d1 f32": (cost.masked_similarity, (5976, 20, 3952, False), "0.0846",
                  "operations"),
    # the cluster kernel (4 N tiles of 32 landmarks) at phase 14a's wide
    # fit and at web_fit's cut shape, and the f32 route there
    "1 d1 n=128": (cost.masked_similarity, (5976, 128, 3952, True),
                   "0.0367", "operations"),
    "1 d1 web_fit": (cost.masked_similarity, (245_760, 128, 65_536, True),
                     "25.0", "operations"),
    "1' d1 f32 web_fit": (cost.masked_similarity,
                          (245_760, 128, 65_536, False), "369.2",
                          "operations"),
    "2 topk_sim": (cost.topk, (5976, 5976, 20, 13), "0.0213", "operations"),
    "3 foldin_topk": (cost.topk, (64, 6040, 20, 13), "0.00023",
                      "operations"),
    "4 kmeans": (cost.kmeans, (5976, 77, 20, 8), "0.0025", "operations"),
    # 9.49 M live (query, slot) pairs, all 5976 rows stored
    "5 fused probe": (cost.fused_probe,
                      (5976, 19, 77, 104, 20, 13, 9_490_000, 5976),
                      "0.00610", "operations"),
    "6 per-query": (cost.score_candidates, (256, 1976, 20, False), "0.0127",
                    "bytes"),
    "6 per-query n=100": (cost.score_candidates, (256, 1976, 100, False),
                          "0.0610", "bytes"),
    "6 per-query n=128": (cost.score_candidates, (256, 1976, 128, False),
                          "0.0780", "bytes"),
    "6 shared": (cost.score_candidates, (8192, 64, 20, True), "0.00082",
                 "bytes"),
    "6 shared n=100": (cost.score_candidates, (8192, 64, 100, True),
                       "0.00161", "operations"),
    "6 shared n=128": (cost.score_candidates, (8192, 64, 128, True),
                       "0.00206", "operations"),
    "7 bf16": (cost.landmark_summary, (10, 1536, 4096, 64, True), "0.0244",
               "operations"),
    "7 DeepSeek": (cost.landmark_summary, (32, 512, 4096, 128, True),
                   "0.0521", "operations"),
    "7' f32": (cost.landmark_summary, (10, 1536, 4096, 64, False), "0.0733",
               "operations"),
    "7'' bwd bf16": (cost.landmark_summary_bwd, (40, 1536, 4096, 64, True),
                     "0.163", "operations"),
    "7''' bwd f32": (cost.landmark_summary_bwd,
                     (40, 1536, 4096, 64, False), "0.163", "operations"),
    "7'''' bwd D=256": (cost.landmark_summary_bwd, (2, 130, 500, 256, False),
                        "0.0015", "bytes"),
    "8 minibatch_lg": (cost.segment_sum, (70, 54_413, 170_496, 4), "0.0191",
                       "bytes"),
    "8 minibatch_lg bf16": (cost.segment_sum, (70, 54_413, 170_496, 2),
                            "0.0097", "bytes"),
    "8g H=10": (cost.segment_sum, (10, 2_555_904, 41_689_088, 4), "0.581",
                "bytes"),
    "8g H=1": (cost.segment_sum, (1, 2_555_904, 41_689_088, 4), "0.106",
               "bytes"),
    "8h": (cost.segment_sum, (64, 3_276_800, 1_000_448, 4), "0.332",
           "bytes"),
}


@pytest.mark.parametrize("row", sorted(PERF_ROWS))
def test_kernel_formula_gives_the_perf_row_bound(row):
    formula, args, printed, by = PERF_ROWS[row]
    ms_, got_by = formula(*args).bound()
    digits = len(printed.split(".")[1])
    assert f"{ms_:.{digits}f}" == printed and got_by == by, (ms_, got_by)


def _plain_versions_raise():
    """Every plain version a wrapper could take, patched to fail."""
    names = ("masked_similarity_ref", "topk_sim_ref", "foldin_topk_ref",
             "kmeans_lloyd_ref", "assign_clusters_ref",
             "fused_probe_topk_ref", "score_candidates_ref",
             "landmark_summary_ref", "landmark_summary_bwd_ref",
             "segment_sum_ref", "bf16_terms")
    return [mock.patch.object(ref, n, side_effect=AssertionError(n))
            for n in names]


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_meta_calls_launch_nothing_and_charge_their_formula():
    i32 = torch.int32
    patches = _plain_versions_raise()
    for p in patches:
        p.start()
    counts = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    splits = lsum.bf16_terms.launches
    try:
        with cost.tally() as t:
            out = ms.masked_similarity(_meta(50, 30), _meta(7, 30))
            assert out.shape == (50, 7) and out.device.type == "meta"
            ms.masked_similarity(_meta(50, 30), _meta(7, 30), route="f32")
            v, i = knn_topk.topk_sim(_meta(40, 20), _meta(40, 20), k=5,
                                     exclude_self=True)
            assert v.shape == i.shape == (40, 5) and i.dtype == i32
            knn_topk.foldin_topk(_meta(6, 20), _meta(46, 20), k=5,
                                 self_offset=40)
            cent, assign = assign_clusters.kmeans_lloyd(
                _meta(40, 20), _meta(4, 20), iters=3)
            assert cent.shape == (4, 20) and assign.shape == (40,)
            assign_clusters.assign_clusters(_meta(40, 20), _meta(4, 20))
            v, i = ivf_probe.fused_probe_topk(
                _meta(6, 20), _meta(6, 2, dtype=i32), _meta(4, 8, dtype=i32),
                _meta(4, 8, 20), None, _meta(4, dtype=i32), k=5)
            assert v.shape == (6, 5)
            assert score_candidates.score_candidates(
                _meta(6, 20), _meta(6, 9, 20)).shape == (6, 9)
            assert score_candidates.score_candidates(
                _meta(6, 20), _meta(9, 20)).shape == (6, 9)
            for dtype in (torch.bfloat16, torch.float32):
                q = _meta(2, 16, 64, dtype=dtype).requires_grad_()
                k = _meta(2, 100, 64, dtype=dtype).requires_grad_()
                vv = _meta(2, 100, 64, dtype=dtype).requires_grad_()
                o = lsum.landmark_summary(q, k, vv)
                assert o.shape == (2, 16, 64) and o.dtype == torch.float32
                o.sum().backward()
                assert q.grad.shape == q.shape and q.grad.dtype == dtype
            lsum.landmark_summary_bwd(*(_meta(1, 8, 256) for _ in range(2)),
                                      _meta(1, 8, 256), _meta(1, 8, 256),
                                      _meta(1, 8, 256), 0.1)
            idx = _meta(300, dtype=torch.int64)
            csr = segsum.build_csr(idx, 50, _meta(300))
            assert csr.perm.shape == (300,) and csr.indptr.shape == (51,)
            x = _meta(300, 7).requires_grad_()
            y = segsum.seg_sum(x, csr)
            assert y.shape == (50, 7)
            segsum.gather(_meta(50, 7).requires_grad_(), csr).sum().backward()
    finally:
        for p in patches:
            p.stop()
    assert {fn.__name__: fn.launches for fn in ops.WRAPPERS} == counts
    assert lsum.bf16_terms.launches == splits
    calls = {name: row[0] for name, row in t["kernels"].items()}
    assert calls == {"masked_similarity": 2, "topk_sim": 1, "foldin_topk": 1,
                     "assign_clusters": 2, "fused_probe_topk": 1,
                     "score_candidates": 2, "landmark_summary": 2,
                     "landmark_summary_bwd": 3, "segment_sum": 2}
    want = (cost.masked_similarity(50, 7, 30, True).ops
            + cost.masked_similarity(50, 7, 30, False).ops)
    assert t["kernels"]["masked_similarity"][1] == want
    # on meta the probe is charged at its bounds: every probed slot live
    assert t["kernels"]["fused_probe_topk"][1] == cost.fused_probe(
        6, 2, 4, 8, 20, 5, 6 * 2 * 8, 4 * 8).ops


def test_meta_route_refuses_mixed_devices():
    """Only an all-meta call takes the meta route: a real tensor beside a
    meta one raises, so no real tensor is ever passed over."""
    assert build.on_meta("x", _meta(2, 2)) is True
    assert build.on_meta("x", torch.zeros(2, 2)) is False
    with pytest.raises(ValueError, match="meta and real tensors mixed"):
        ms.masked_similarity(_meta(5, 3), torch.zeros(2, 3))
    with pytest.raises(ValueError, match="meta and real tensors mixed"):
        knn_topk.topk_sim(torch.zeros(5, 3), _meta(5, 3), k=2)


def test_no_tally_open_charges_nothing():
    called = []
    cost.charge("x", lambda: called.append(1))
    cost.collective("all-gather", 8)
    assert not called
