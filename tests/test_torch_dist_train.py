"""The LM sharded over a mesh of ranks (``torch.distributed``, gloo on
the CPU) against the port's one-process run, which
``tests/test_torch_train.py`` and ``tests/test_torch_lm.py`` hold to the
reference.

Every rank runs in a process of its own (``launch/dist.py::spawn``), never
in the pytest worker: one spawn of 4 ranks on ``data=2, model=2`` runs
every 4-rank case, one spawn of 1 rank the 1×1 mesh.

- The smoke SmolLM (3 heads, 1 kv head: heads replicated, the sequence,
  the FFN and the vocab split over ``model``, parameters and state over
  ``data``) in f32 trains one step with landmark attention and one with
  full attention: the loss, the step-1 gradients gathered whole and the
  updated parameters within 1e-4 of the one-process step (relative to
  each gradient's largest value; absolute on parameters and loss). The
  mesh's sums run in another order (partial sums over the ranks, the
  loss's log-sum-exp over vocab shards), the only difference; seen: 3e-5.
- So do the other four LM archs' smoke models (full attention; Adafactor
  for llama, MoE for deepseek and dbrx, heads split over ``model`` for
  llama and gemma); seen: 1.2e-6.
- A 1×1 mesh step (DTensor, every redistribution a no-op) is bitwise the
  plain step.
- The prefill, exact decode and landmark decode on the mesh equal the
  one-process ones within ``tests/test_torch_lm.py``'s f32 bound (1e-4),
  for each of the five LM archs' smoke models (seen: up to 6e-6).
- Each rank reports the same loss; the collectives are the same on every
  rank; kernel 7's wrappers count no launch on the CPU (the plain
  version runs).
- The all-gather built from the all-to-all (``dist.build_all_gather``, what
  gloo's ranks on a card run) gives the same bits, and the bytes it moves
  are the all-gathers' own, counted as all-to-all.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)

import numpy as np
import pytest
import torch

from repro_torch.launch import dist, mesh_run

F32_TOL = 1e-4  # tests/test_torch_lm.py's f32 bound
MESH = (("data", "model"), (2, 2))


# the other LM archs' smoke models, full attention: Adafactor and
# query heads split over model with kv replicated (llama), query and kv
# heads split (gemma), the MoE FFN on each rank's batch block with shared
# experts (deepseek) and with kv replicated (dbrx)
OTHER_LMS = ("llama3-405b", "gemma-7b", "deepseek-moe-16b", "dbrx-132b")
SERVED = ("full", *OTHER_LMS)  # SmolLM's smoke model is "full"


def _archs():
    out = {b: mesh_run.smoke_arch("smollm-360m", dtype=torch.float32,
                                  backend=b, batch=4, seq=64)
           for b in ("landmark", "full")}
    out.update({n: mesh_run.smoke_arch(n, dtype=torch.float32, batch=4,
                                       seq=64) for n in OTHER_LMS})
    return out


def _ranks(launch, archs, mesh):
    out = {b: mesh_run.train(launch, a, mesh_axes=mesh, want_grads=True,
                             want_params=True)
           for b, a in archs.items()}
    out["serve"] = {n: mesh_run.lm_serve(launch, archs[n], mesh_axes=mesh)
                    for n in SERVED}
    # the all-gather built from the all-to-all, as gloo's CUDA ranks run it
    dist.build_all_gather("CPU")
    out["built"] = mesh_run.train(launch, archs["landmark"],
                                  mesh_axes=mesh, want_params=True)
    return out


@pytest.fixture(scope="module")
def runs():
    archs = _archs()
    mesh = dist.spawn(_ranks, 4, archs, MESH, timeout=600)
    one = {b: mesh_run.train("cpu", a, want_grads=True, want_params=True)
           for b, a in archs.items()}
    one["serve"] = {n: mesh_run.lm_serve("cpu", archs[n]) for n in SERVED}
    return mesh, one


@pytest.mark.parametrize("backend", ["landmark", "full", *OTHER_LMS])
def test_mesh_step_matches_the_one_process_step(runs, backend):
    mesh, one = runs
    want = one[backend]
    for r in mesh:
        got = r[backend]
        assert got["losses"] == mesh[0][backend]["losses"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                                   atol=F32_TOL)
        assert sorted(got["grads"]) == sorted(want["grads"])
        for name, g in want["grads"].items():
            err = (got["grads"][name] - g).abs().max() / g.abs().max()
            assert err <= F32_TOL, (backend, name, float(err))
        for name, p in want["params"].items():
            np.testing.assert_allclose(got["params"][name], p, rtol=0,
                                       atol=F32_TOL, err_msg=name)
        assert got["collectives"] == mesh[0][backend]["collectives"]
        assert all(v == 0 for v in got["launches"][0].values())
    coll = mesh[0][backend]["collectives"][0]
    assert coll["all-gather"]["count"] > 0 and coll["reduce-scatter"]["count"]


def test_built_all_gather_moves_the_same_data(runs):
    mesh, _ = runs
    for r in mesh:
        got, want = r["built"], r["landmark"]
        assert got["losses"] == want["losses"]
        for name, p in want["params"].items():
            assert torch.equal(got["params"][name], p), name
        issued = got["collectives"][0]["all-gather"]["bytes"]
        assert issued == want["collectives"][0]["all-gather"]["bytes"]
        assert got["moved"].get("all-gather", 0) == 0
        assert got["moved"]["all-to-all"] == issued


@pytest.mark.parametrize("name", SERVED)
def test_mesh_serving_matches_the_one_process_run(runs, name):
    mesh, one = runs
    want = one["serve"][name]
    for r in mesh:
        got = r["serve"][name]
        for key in ("prefill_logits", "cache_k"):
            np.testing.assert_allclose(got[key], want[key], rtol=F32_TOL,
                                       atol=F32_TOL, err_msg=key)
        for key in ("decode_logits", "landmark_logits"):
            assert len(got[key]) == len(want[key]) == 3
            for a, b in zip(got[key], want[key]):
                np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL,
                                           err_msg=key)


def _one_by_one(launch, arch):
    return mesh_run.train(launch, arch, mesh_axes=(("data", "model"),
                                                   (1, 1)),
                          want_grads=True, want_params=True)


def test_one_by_one_mesh_step_is_bitwise_the_plain_step():
    arch = _archs()["landmark"]
    (got,) = dist.spawn(_one_by_one, 1, arch, timeout=300)
    want = mesh_run.train("cpu", arch, want_grads=True, want_params=True)
    assert got["losses"] == want["losses"]
    for key in ("grads", "params"):
        for name, t in want[key].items():
            assert torch.equal(got[key][name], t), (key, name)


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError,
                       match=r"(?s)rank 1:.*ZeroDivisionError"):
        dist.spawn(_fail_on_rank_one, 2, timeout=120)


def _fail_on_rank_one(launch):
    if launch.rank == 1:
        return 1 / 0
    return launch.rank


def test_rank_device_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="sees no CUDA device"):
        dist.rank_device(0, "cuda")
    assert dist.choose_backend(torch.device("cpu"), 4)[0] == "gloo"
