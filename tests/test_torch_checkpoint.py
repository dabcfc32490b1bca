"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
reference's on-disk layout, on the CPU: an artifact written by either
package loads in the other, bit for bit, plain and compact (uint16 ids,
bf16 weights), and the commit protocol (tmp dir + rename, manifest
required, keep-3) behaves the same.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.train import checkpoint as jck
import repro_torch.core as T
from repro_torch.train import checkpoint as ck

SPEC = T.LandmarkSpec(n_landmarks=6, k_neighbors=5)
JSPEC = J.LandmarkSpec(n_landmarks=6, k_neighbors=5)


def _ratings(u=60, p=30, seed=0):
    rng = np.random.default_rng(seed)
    r = rng.integers(1, 6, (u, p)).astype(np.float32)
    return r * (rng.random((u, p)) < 0.4)


def _port_state():
    r = _ratings()
    return T.fit(T.RatingMatrix(torch.as_tensor(r), *r.shape), SPEC)


def _jax_state():
    r = jnp.asarray(_ratings())
    return J.fit(jax.random.PRNGKey(0), J.RatingMatrix(r, *r.shape), JSPEC)


def _bits(x):
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _same_state(a, b):
    for name in ("landmark_idx", "representation", "ratings"):
        np.testing.assert_array_equal(_bits(getattr(a, name)),
                                      _bits(getattr(b, name)))
    for name in ("indices", "weights"):
        x, y = getattr(a.graph, name), getattr(b.graph, name)
        if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
            x = x.view(torch.int16).numpy().view(np.uint16)
        if isinstance(y, torch.Tensor) and y.dtype == torch.bfloat16:
            y = y.view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(_bits(x), _bits(y))


@pytest.mark.parametrize("compact", [False, True])
def test_reference_artifact_loads_in_the_port(tmp_path, compact):
    st = _jax_state()
    jck.save_landmark_state(str(tmp_path), st, compact=compact, step=4)
    assert ck.latest_step(str(tmp_path)) == 4
    assert ck.landmark_state_meta(str(tmp_path))["compact"] is compact
    got = ck.load_landmark_state(str(tmp_path), widen=False, device="cpu")
    want = jck.load_landmark_state(str(tmp_path), widen=False)
    _same_state(want, got)
    assert got.graph.is_compact is compact
    assert got.landmark_idx.dtype == torch.int64
    full = ck.load_landmark_state(str(tmp_path), device="cpu")
    assert not full.graph.is_compact


@pytest.mark.parametrize("compact", [False, True])
def test_port_artifact_loads_in_the_reference(tmp_path, compact):
    st = _port_state()
    ck.save_landmark_state(str(tmp_path), st, compact=compact, step=2)
    assert jck.latest_step(str(tmp_path)) == 2
    want = ck.load_landmark_state(str(tmp_path), widen=False, device="cpu")
    got = jck.load_landmark_state(str(tmp_path), widen=False)
    _same_state(want, got)
    np.testing.assert_array_equal(np.asarray(got.landmark_idx),
                                  st.landmark_idx.numpy())


def test_manifests_match_the_reference_layout(tmp_path):
    """The same state saved by both packages: the same files, the same
    leaf order (sorted keys), shapes, dtypes and shard index ranges."""
    st = _jax_state()
    jck.save_landmark_state(str(tmp_path / "jax"), st, compact=True)
    port = ck.load_landmark_state(str(tmp_path / "jax"), widen=False,
                                  device="cpu")
    ck.save_landmark_state(str(tmp_path / "port"), port, compact=True)
    a = tmp_path / "jax" / "step_00000000"
    b = tmp_path / "port" / "step_00000000"
    assert (json.loads((a / "manifest.json").read_text())
            == json.loads((b / "manifest.json").read_text()))
    assert (json.loads((a / "state.json").read_text())
            == json.loads((b / "state.json").read_text()))
    assert (sorted(p.relative_to(a).as_posix() for p in a.rglob("*"))
            == sorted(p.relative_to(b).as_posix() for p in b.rglob("*")))


def test_partial_checkpoints_are_invisible_and_keep_three(tmp_path):
    st = _port_state()
    for step in (1, 2, 3, 5):
        ck.save_landmark_state(str(tmp_path), st, step=step)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000002", "step_00000003", "step_00000005"]
    tmp = tmp_path / "step_00000007.tmp" / "leaf_0000"
    tmp.mkdir(parents=True)  # crash before the rename
    np.save(tmp / "shard_0000.npy", np.ones(4))
    part = tmp_path / "step_00000009" / "leaf_0000"
    part.mkdir(parents=True)  # renamed, but no manifest
    np.save(part / "shard_0000.npy", np.ones(4))
    assert ck.latest_step(str(tmp_path)) == 5
    assert jck.latest_step(str(tmp_path)) == 5
    loaded = ck.load_landmark_state(str(tmp_path), device="cpu")
    assert torch.equal(loaded.graph.indices, st.graph.indices)
    assert ck.latest_step(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        ck.load_landmark_state(str(tmp_path / "missing"), device="cpu")


def test_generic_trees_round_trip_in_sorted_key_order(tmp_path):
    tree = {"b": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "a": {"y": torch.ones(3, dtype=torch.bfloat16),
                  "x": np.float32(2.5)},
            "c": [torch.zeros(2), torch.full((1,), 7, dtype=torch.int64)]}
    ck.save_checkpoint(str(tmp_path), 3, tree)
    manifest = json.loads((tmp_path / "step_00000003" / "manifest.json"
                           ).read_text())
    assert [m["dtype"] for m in manifest["leaves"]] == [
        "float32", "bfloat16", "int32", "float32", "int64"]
    out = ck.restore_checkpoint(str(tmp_path), tree, device="cpu")
    assert torch.equal(out["b"], tree["b"])
    assert torch.equal(out["a"]["y"], tree["a"]["y"])
    assert float(out["a"]["x"]) == 2.5 and out["a"]["x"].shape == ()
    assert torch.equal(out["c"][1], tree["c"][1])
    with pytest.raises(ValueError, match="tree structure changed"):
        ck.restore_checkpoint(str(tmp_path), {"b": 0}, device="cpu")
    # the reference reads the same leaves in the same order
    jout = jck.restore_checkpoint(str(tmp_path), {
        "a": {"x": 0, "y": 0}, "b": 0, "c": [0, 0]})
    np.testing.assert_array_equal(np.asarray(jout["b"]), tree["b"].numpy())
