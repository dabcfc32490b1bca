"""The port's serve CLI and its rules, on the CPU: the CLI runs end to end,
no source of the port imports JAX or the JAX package, the kernel wrappers
never launch for CPU tensors, and the card is the default device."""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core.graph import resolve_backend
from repro_torch.kernels import build, ops
from repro_torch.launch import serve

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import|from) (jax|repro)(\.|\s|$)", re.M)


def test_serve_cli_smoke_on_cpu(capsys, tmp_path):
    """An empty --ckpt: fit, checkpoint, load the artifact and serve it; a
    second run on the same directory loads without fitting."""
    args = ["--workload", "cf", "--smoke", "--device", "cpu", "--ckpt",
            str(tmp_path)]
    serve.main(args)
    out = capsys.readouterr().out
    assert "tf32: off" in out
    assert "fit U=512 P=128 n=8 k=13 on cpu" in out
    assert f"checkpointed {tmp_path}" in out
    assert "loaded U=512 graph k=13" in out
    assert "wave 0: U=512" in out and "wave 1: U=528" in out
    assert "fold-in +16 users" in out
    assert out.rstrip().endswith("cf serve: done")
    serve.main(args)
    again = capsys.readouterr().out
    assert "fit U=" not in again and "loaded U=512 graph k=13" in again
    assert again.rstrip().endswith("cf serve: done")


@pytest.mark.parametrize("backend", ["dense", "streaming", "kernel", "ivf"])
def test_serve_cli_graph_backends(capsys, backend):
    serve.main(["--workload", "cf", "--smoke", "--device", "cpu", "--waves",
                "2", "--requests", "2", "--graph-backend", backend])
    assert "cf serve: done" in capsys.readouterr().out


def test_serve_cli_refuses_ivf_retrieval_without_lifecycle():
    with pytest.raises(SystemExit, match="lifecycle"):
        serve.main(["--workload", "cf", "--smoke", "--device", "cpu",
                    "--retrieval", "ivf"])


def test_port_sources_never_import_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "paper_tables_torch.py"]
    files += sorted((ROOT / "examples").glob("*_torch.py"))
    assert len(files) > 15 and (ROOT / "examples" / "quickstart_torch.py"
                                ) in files
    for f in files:
        hits = FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"


def test_wrappers_never_launch_for_cpu_tensors():
    """On CPU tensors the wrappers take their plain versions and their
    launch counts stay 0 through a whole fit and fold-in."""
    ops.reset_launches()
    rng = np.random.default_rng(0)
    r = rng.integers(1, 6, (80, 30)).astype(np.float32)
    r *= rng.random(r.shape) < 0.4
    spec = T.LandmarkSpec(n_landmarks=6, k_neighbors=4)
    st = T.fit(T.RatingMatrix(torch.as_tensor(r[:70]), 70, 30), spec)
    st = T.fold_in(st, torch.as_tensor(r[70:]), spec)
    assert st.graph.indices.shape == (80, 4)
    assert ops.launch_counts() == {"masked_similarity": 0, "topk_sim": 0,
                                   "foldin_topk": 0, "assign_clusters": 0,
                                   "fused_probe_topk": 0,
                                   "score_candidates": 0,
                                   "landmark_summary": 0,
                                   "landmark_summary_bwd": 0,
                                   "segment_sum": 0}


def test_resolve_backend_follows_the_tensor_device():
    assert resolve_backend("auto", "cpu") == "streaming"
    assert resolve_backend("auto", torch.device("cuda")) == "kernel"
    assert resolve_backend("kernel", "cpu") == "kernel"
    assert resolve_backend("ivf", "cpu") == "ivf"
    assert resolve_backend("ivf", torch.device("cuda")) == "ivf"
    with pytest.raises(ValueError, match="unknown graph backend"):
        resolve_backend("pallas", "cpu")


def test_card_is_the_default_device():
    """Asking for the default device without a card raises: no fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        T.RatingMatrix.from_coo(np.array([0]), np.array([0]),
                                np.array([5.0], np.float32), 2, 2)
    with pytest.raises((RuntimeError, AssertionError)):
        serve.main(["--workload", "cf", "--smoke", "--waves", "1"])


def test_kernel_input_checks_reject_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        build.check_cuda_f32("masked_similarity", torch.zeros((2, 3)))


def test_build_paths_stay_in_the_checkout():
    assert build.BUILD_DIR == ROOT / "build" / "kernels"
    assert sorted(p.name for p in build.CSRC.glob("*.cu")) == [
        "assign_clusters.cu", "ivf_probe.cu", "knn_topk.cu",
        "landmark_summary.cu", "landmark_summary_bwd.cu",
        "masked_similarity.cu", "score_candidates.cu", "segment_sum.cu"]
    assert sorted(p.name for p in build.CSRC.glob("*.cuh")) == [
        "device_smem.cuh", "sm90.cuh", "topk_common.cuh"]
    assert "sm_90a" in build.ARCH
    assert "--use_fast_math" not in build.NVCC_FLAGS
