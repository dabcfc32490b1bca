"""``tools/paper_tables_torch.py`` (the port's paper tables) on the CPU at a
tiny size: Table 15's landmark and full-matrix kNN rows against the
reference's ``benchmarks.paper_tables._eval_landmark`` and
``_eval_baseline`` on the same data and fold, under the parity rule
(rtol=1e-5, atol=1e-6); the model-based rows on their contracts (finite
MAE, positive times, the ratio to the landmark row).
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import importlib.util
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T
from benchmarks import paper_tables as jpt
from repro.data import ratings as jratings
from repro_torch.data import ratings as tratings

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
U, P, N = 150, 90, 3000  # N: the main test's CLI data only
ALGOS = ["Landmarks kNN", "euclidean kNN", "cosine kNN", "pearson kNN",
         "RSVD", "IRSVD", "PMF", "SVD++", "BPMF"]


def _tool():
    spec = importlib.util.spec_from_file_location(
        "paper_tables_torch", ROOT / "tools" / "paper_tables_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def coo():
    """A (150, 90) block of uniform 1..5 ratings at density 0.3 (~3900
    cells), in a shuffled order. Uniform ratings spread the cosine
    landmark representation, so no row's k-th and (k+1)-th neighbors tie
    within the tolerance (checked below): the two packages' graphs hold
    the same neighbor sets, and Eq. (1) gives the same MAE."""
    rng = np.random.default_rng(0)
    r = rng.integers(1, 6, (U, P)).astype(np.float32)
    r *= rng.random((U, P)) < 0.3
    users, items = np.nonzero(r)
    perm = rng.permutation(len(users))
    users, items = users[perm].astype(np.int32), items[perm].astype(np.int32)
    return users, items, r[users, items]


def test_tab15_rows_match_reference_evaluations(coo):
    users, items, ratings = coo
    tdata = tratings.RatingData(users, items, ratings, U, P)
    rows = _tool().tab15_comparative(data=tdata, epochs=2, device="cpu")
    assert [r["algo"] for r in rows] == ALGOS
    jdata = jratings.RatingData(users, items, ratings, U, P)
    tr, te = jratings.kfold_split(jdata, 0)
    spec = J.LandmarkSpec(n_landmarks=20, selection="popularity")
    # the precondition of exact MAE parity: equal neighbor sets
    jst = J.fit(jax.random.PRNGKey(0), jdata.to_matrix(tr), spec)
    tst = T.fit(tdata.to_matrix(tr, device="cpu"),
                T.LandmarkSpec(n_landmarks=20, selection="popularity"))
    np.testing.assert_array_equal(np.sort(tst.graph.indices.numpy(), 1),
                                  np.sort(np.asarray(jst.graph.indices), 1))
    want = [jpt._eval_landmark(jdata, tr, te, spec)[0]]
    want += [jpt._eval_baseline(jdata, tr, te, m)[0]
             for m in ("euclidean", "cosine", "pearson")]
    np.testing.assert_allclose([r["mae"] for r in rows[:4]], want,
                               rtol=RTOL, atol=ATOL)
    t_lm = rows[0]["time_s"]
    assert rows[0]["rel"] == 1.0 and t_lm > 0
    for r in rows[1:]:
        assert np.isfinite(r["mae"]) and 0 < r["mae"] < 4, r
        assert r["time_s"] > 0 and r["rel"] == pytest.approx(
            r["time_s"] / t_lm)


def test_main_prints_json_rows_and_refuses_a_missing_card(capsys,
                                                          monkeypatch):
    tool = _tool()
    monkeypatch.setattr(tool.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(["--table", "tab10"])
    monkeypatch.setattr(tool, "synthesize", lambda name, seed=0:
                        tratings.RatingData(*_small(), U, P))
    assert tool.main(["--table", "tab10", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all('"table": "tab10"' in ln for ln in lines)
    assert '"device": "cpu"' in lines[0]


def _small():
    rng = np.random.default_rng(2)
    flat = rng.choice(U * P, N, replace=False)
    return ((flat // P).astype(np.int32), (flat % P).astype(np.int32),
            rng.integers(1, 6, N).astype(np.float32))


def test_examples_run_on_the_cpu(capsys, monkeypatch):
    """Both examples end to end on the CPU when asked (the card is their
    default): the quickstart's landmark and full-kNN lines, and the nine
    rows of the comparison at one epoch."""
    monkeypatch.setattr(sys, "argv", ["quickstart_torch.py", "--device",
                                      "cpu"])
    runpy.run_path(str(ROOT / "examples" / "quickstart_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    assert "Landmarks kNN : MAE" in out and "Full kNN CF   : MAE" in out
    runpy.run_path(str(ROOT / "examples" / "compare_baselines_torch.py")
                   )["main"](["--device", "cpu", "--epochs", "1"])
    lines = capsys.readouterr().out.strip().splitlines()[-len(ALGOS):]
    assert [ln.split("MAE")[0].strip() for ln in lines] == ALGOS
