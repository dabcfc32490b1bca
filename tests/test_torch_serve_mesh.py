"""The port's sharded lifecycle replay, ``serve --workload cf --lifecycle
--mesh``, end to end on a mesh of CPU shards (``--device cpu``): the lines
the reference's own acceptance test checks
(tests/test_sharded_serving.py::test_serve_sharded_lifecycle_end_to_end),
with the reference's flags, and the flag combinations that are refused.

Inside the replay every wave's predictions and top-N are asserted bitwise
against a single-device shadow replay of the same stream, and the swapped
artifact against a one-device fit from scratch.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import pytest
import torch

from repro_torch.launch import serve
from repro_torch.train.checkpoint import landmark_state_meta, latest_step

SMOKE = ["--workload", "cf", "--lifecycle", "--smoke", "--mesh",
         "pod=2,data=4", "--users", "128", "--items", "64", "--waves", "6",
         "--arrivals", "32", "--requests", "2", "--batch", "32",
         "--min-bucket", "128", "--device", "cpu"]


def test_serve_sharded_lifecycle_end_to_end(tmp_path, capsys):
    res = serve.main(SMOKE + ["--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert "mesh pod=2,data=4: 8 shards on 1 device(s): cpu x8" in out
    assert "cf sharded lifecycle: done" in out
    assert "0 full-row materializations" in out
    assert "predictions bit-identical to the single-device run: 6/6" in out
    assert "launched on the mesh" in out
    assert "oracle-exact" in out
    assert latest_step(str(tmp_path)) == 1
    assert landmark_state_meta(str(tmp_path))["row_shards"] == 8
    assert res["identical_waves"] == 6 and res["refreshed"]
    assert res["block_devices"] == ["cpu"] and res["row_shards"] == 8
    # the fit and the refit on the mesh; five 32-row arrival batches
    assert res["mesh_fits"] == 2 and res["mesh_fold_batches"] == 5
    assert "launches beside the mesh path" in out
    assert len(res["wave_ms"]) == len(res["side_ms"]) == 6


def test_serve_sharded_lifecycle_with_ivf_early_exit(tmp_path, capsys):
    serve.main(SMOKE + ["--ckpt", str(tmp_path), "--retrieval", "ivf",
                        "--early-exit"])
    out = capsys.readouterr().out
    assert "retrieval: sharded ivf C=16 (2 cells/shard)" in out
    assert "0 candidate-tensor materializations" in out
    assert "early-exit recall" in out
    assert "ivf retrieval (sharded): recall@k per wave" in out
    assert "predictions bit-identical to the single-device run: 6/6" in out
    assert "cf sharded lifecycle: done" in out


def test_serve_sharded_lifecycle_one_axis_mesh(tmp_path, capsys):
    argv = [a if a != "pod=2,data=4" else "data=3" for a in SMOKE]
    res = serve.main(argv + ["--ckpt", str(tmp_path), "--compact-serving"])
    out = capsys.readouterr().out
    assert "ignored under --mesh" in out
    assert "predictions bit-identical to the single-device run: 6/6" in out
    assert res["shards"] == 3 and res["row_shards"] == 3


@pytest.mark.parametrize("extra,match", [
    (["--mutations"], "add --engine"),
    (["--retrieval", "ivf"], "add --lifecycle or --engine"),
])
def test_mesh_with_engine_is_refused(extra, match):
    """``--engine --mesh`` serves (tests/test_torch_engine_mesh.py); what
    is still refused on a mesh is an engine flag without the engine."""
    with pytest.raises(SystemExit, match=match):
        serve.main(["--workload", "cf", "--mesh", "data=2", "--smoke",
                    "--device", "cpu"] + extra)


def test_mesh_needs_the_lifecycle_replay():
    with pytest.raises(SystemExit, match="add --lifecycle"):
        serve.main(["--workload", "cf", "--mesh", "data=2", "--smoke",
                    "--device", "cpu"])


def test_parse_mesh():
    assert serve._parse_mesh("pod=2,data=4") == (("pod", "data"), (2, 4))
    with pytest.raises(ValueError):
        serve._parse_mesh("pod2")


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from repro_torch.launch.mesh import make_mesh

    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(("data",), (2,))


def test_launch_tally_counts_the_calling_thread_only():
    """The replay separates the mesh path's launches from the shadow's with
    a tally on its own thread; a launch made on another thread (a
    background refit) reaches the wrapper's count and no open tally."""
    import threading

    from repro_torch.kernels import build

    def wrapper():
        pass

    wrapper.launches = 0
    with build.tally() as outer:
        build.count_launch(wrapper)
        with build.tally() as inner:
            build.count_launch(wrapper, 3)
            t = threading.Thread(target=build.count_launch, args=(wrapper,))
            t.start()
            t.join()
    build.count_launch(wrapper)
    assert wrapper.launches == 6
    assert inner == {"wrapper": 3} and outer == {"wrapper": 4}
