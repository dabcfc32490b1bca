"""Compact serving in the port (``lifecycle.buckets.compact_state``,
``RefreshManager(compact=)``, ``serve --compact`` and
``serve --lifecycle --compact-serving``) against the JAX reference on the
CPU.

Tolerances:
- compact reads against the reference's compact reads: rtol=1e-5,
  atol=1e-6 (both packages round the same f32 weights to the same bf16);
- compact reads against the widened graph's reads: rtol=atol=2e-2, the
  reference's bf16 bound (``tests/test_lifecycle.py``);
- the CLIs' artifact-size and compaction lines: equal text.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.launch import serve as jserve
from repro.lifecycle import buckets as jbuckets
from repro.lifecycle import policy as jpolicy
import repro_torch.core as T
from repro_torch.core.convert import landmark_state_from_numpy
from repro_torch.launch import serve
from repro_torch.lifecycle import buckets, compact_state, policy
from repro_torch.lifecycle.refresh import RefreshManager
from repro_torch.train.checkpoint import (landmark_state_meta,
                                          load_landmark_state)

RTOL, ATOL = 1e-5, 1e-6
BF16_TOL = 2e-2
SPEC = T.LandmarkSpec(n_landmarks=8, selection="popularity", k_neighbors=5)
JSPEC = J.LandmarkSpec(n_landmarks=8, selection="popularity", k_neighbors=5)
# the lifecycle replay at a size where both packages fire one refresh
LIFECYCLE = ["--workload", "cf", "--lifecycle", "--smoke", "--users", "128",
             "--items", "64", "--waves", "6", "--arrivals", "32",
             "--requests", "2", "--batch", "32", "--min-bucket", "128",
             "--compact-serving"]


def _ratings(u, p, density=0.35, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    return r * (rng.random((u, p)) < density)


@pytest.fixture(scope="module")
def fitted():
    """The reference's fit of a (120, 48) block, and the same state in the
    port."""
    r = _ratings(120, 48, seed=1)
    jst = J.fit(jax.random.PRNGKey(0),
                J.RatingMatrix(jnp.asarray(r), 120, 48), JSPEC)
    st = landmark_state_from_numpy({
        "landmark_idx": np.asarray(jst.landmark_idx),
        "representation": np.asarray(jst.representation),
        "ratings": np.asarray(jst.ratings),
        "graph.indices": np.asarray(jst.graph.indices),
        "graph.weights": np.asarray(jst.graph.weights)}, device="cpu")
    return st, jst


@pytest.mark.parametrize("rows", [1024, 65535, 65536])
def test_should_compact_gates_on_capacity(rows):
    on, jon = (policy.RefreshSpec(compact_serving=True),
               jpolicy.RefreshSpec(compact_serving=True))
    assert policy.should_compact(on, rows) == jpolicy.should_compact(jon, rows)
    assert policy.should_compact(on, rows) == (rows < 65536)  # uint16 ids
    assert not policy.should_compact(policy.RefreshSpec(), rows)  # off


def test_compact_state_serves_and_widens_on_growth(fitted):
    st, jst = fitted
    bst = buckets.from_state(st, min_bucket=128, growth=2.0)
    cst = compact_state(bst)
    g, gc = bst.state.graph, cst.state.graph
    assert gc.is_compact and gc.indices.dtype == torch.uint16
    assert (gc.indices.nbytes + gc.weights.nbytes) * 2 == \
        g.indices.nbytes + g.weights.nbytes
    jcst = jbuckets.compact_state(jbuckets.from_state(jst, min_bucket=128,
                                                      growth=2.0))
    np.testing.assert_array_equal(gc.indices.numpy(),
                                  np.asarray(jcst.state.graph.indices))
    rng = np.random.default_rng(3)
    users = rng.integers(0, 120, 64).astype(np.int32)
    items = rng.integers(0, 48, 64).astype(np.int32)
    tu, ti = torch.as_tensor(users), torch.as_tensor(items)
    got = buckets.predict_pairs(cst, tu, ti).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jbuckets.predict_pairs(jcst, jnp.asarray(users),
                                               jnp.asarray(items))),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, buckets.predict_pairs(bst, tu, ti).numpy(),
                               rtol=BF16_TOL, atol=BF16_TOL)
    ids, _ = buckets.recommend_topn(cst, tu[:8], n=5)
    jids, _ = jbuckets.recommend_topn(jcst, jnp.asarray(users[:8]), n=5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    # widen on growth: the capacity bump re-pads through to_full
    grown, grew = buckets.ensure_capacity(cst, 64, min_bucket=128, growth=2.0)
    assert grew and not grown.state.graph.is_compact
    # fold-in widens too (extend_neighbor_graph_bucketed goes through to_full)
    padded = torch.zeros((8, 48))
    padded[:3] = torch.as_tensor(_ratings(3, 48, seed=4))
    folded = buckets.fold_in_bucketed(grown, padded, 3, SPEC)
    assert not folded.state.graph.is_compact
    same = buckets.fold_in_bucketed(compact_state(bst), padded, 3, SPEC)
    assert not same.state.graph.is_compact
    # no-op on an already-compact state
    assert compact_state(cst) is cst


@pytest.mark.parametrize("max_rows,stored", [(65536, True), (100, False)])
def test_refresh_manager_stores_the_compact_artifact(tmp_path, max_rows,
                                                     stored):
    r = _ratings(120, 48, seed=1)
    mgr = RefreshManager(str(tmp_path), SPEC, compact=True,
                         compact_max_rows=max_rows, device="cpu")
    assert mgr.request(r, 1)
    mgr.join(timeout=120)
    gen, st = mgr.poll()
    assert gen == 1 and not st.graph.is_compact  # the fitted state, full
    assert landmark_state_meta(str(tmp_path), 1)["compact"] == stored
    raw = load_landmark_state(str(tmp_path), 1, widen=False, device="cpu")
    assert raw.graph.is_compact == stored
    assert torch.equal(raw.graph.to_full().indices, st.graph.indices)


def _line(out, pattern):
    hits = [m.group(0) for m in re.finditer(pattern, out)]
    assert len(hits) == 1, (pattern, hits, out[-2000:])
    return hits[0]


def test_serve_compact_cli_matches_reference(capsys, tmp_path):
    args = ["--workload", "cf", "--smoke", "--waves", "2"]
    serve.main(args + ["--compact", "--device", "cpu", "--ckpt",
                       str(tmp_path / "port")])
    out = capsys.readouterr().out
    jserve.main(args + ["--compact", "--ckpt", str(tmp_path / "ref")])
    ref = capsys.readouterr().out
    pattern = r"graph k=\d+ \(\d+KB, stored compact\)"
    assert _line(out, pattern) == _line(ref, pattern)
    assert out.rstrip().endswith("cf serve: done")
    # without the flag the artifact is full width, twice the bytes
    serve.main(args + ["--device", "cpu", "--ckpt", str(tmp_path / "full")])
    full = _line(capsys.readouterr().out, r"graph k=\d+ \(\d+KB\)")
    kb = lambda s: int(re.search(r"(\d+)KB", s).group(1))
    assert abs(kb(full) - 2 * kb(_line(out, pattern))) <= 1


def test_serve_compact_serving_cli_matches_reference(capsys, tmp_path):
    """--compact-serving with and without the IVF sidecar: the swap wave
    prints the compaction line with the resident KB (graph, and the index
    under --retrieval ivf) the reference prints, and the compact artifact
    passes the oracle check."""
    pattern = r"wave \d+: serving graph compacted \(uint16/bf16, \d+KB resident\)"
    serve.main(LIFECYCLE + ["--device", "cpu", "--ckpt", str(tmp_path / "a")])
    out = capsys.readouterr().out
    line = _line(out, pattern)
    cap = int(re.search(rf"{line.split(':')[0]}: gen 1 U=\d+/cap(\d+)",
                        out).group(1))
    # capacity × k ids and weights, 2 bytes each
    assert f"{round(cap * 13 * 4 / 1024)}KB" in line
    assert "swap oracle-exact vs from-scratch fit (gen 1): True" in out
    assert landmark_state_meta(str(tmp_path / "a"), 1)["compact"]

    ivf = ["--retrieval", "ivf"]
    serve.main(LIFECYCLE + ivf + ["--device", "cpu", "--ckpt",
                                  str(tmp_path / "b")])
    out = capsys.readouterr().out
    jserve.main(LIFECYCLE + ivf + ["--ckpt", str(tmp_path / "c")])
    ref = capsys.readouterr().out
    assert _line(out, pattern) == _line(ref, pattern)
    assert "swap oracle-exact vs from-scratch fit (gen 1): True" in out
    assert out.rstrip().endswith("cf lifecycle: done")
