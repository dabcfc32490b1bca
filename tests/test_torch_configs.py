"""The port's small config modules and ``RatingMatrix.rating_counts``
against the reference, on the CPU.

Each of ``configs/fm.py``, ``mind.py``, ``dien.py``, ``bert4rec.py``,
``gemma_7b.py`` and ``llama3_405b.py`` reads its arch from the port's
registry (one source of truth), whose entry holds the reference
registry's hyperparameters. ``rating_counts`` is the reference's per-user
count of rated items, equal on the same ratings.
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import registry as jregistry
from repro.core.types import RatingMatrix as JRatingMatrix
from repro_torch.configs import registry
from repro_torch.core.types import RatingMatrix

MODULES = {"fm": "fm", "mind": "mind", "dien": "dien",
           "bert4rec": "bert4rec", "gemma_7b": "gemma-7b",
           "llama3_405b": "llama3-405b"}


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if not isinstance(v, torch.dtype)}


@pytest.mark.parametrize("module", sorted(MODULES))
def test_config_module_reads_the_registry(module):
    mod = importlib.import_module(f"repro_torch.configs.{module}")
    name = MODULES[module]
    arch = registry.get(name)
    assert mod.CONFIG is arch and mod.MODEL is arch.model
    assert mod.SMOKE is arch.smoke_model and mod.SHAPES is arch.shapes
    jmod = importlib.import_module(f"repro.configs.{module}")
    assert [s.name for s in mod.SHAPES] == [s.name for s in jmod.SHAPES]
    jmodel = _fields(jmod.MODEL)
    for key, val in _fields(mod.MODEL).items():
        if key in jmodel:  # the reference's sharding switches aside
            assert jmodel[key] == val or list(jmodel[key]) == list(val), key


def test_landmark_cf_entry_is_the_config_module():
    from repro_torch.configs import landmark_cf

    arch = registry.get("landmark_cf")
    assert arch.family == "cf" and arch.model is landmark_cf.MODEL
    assert arch.smoke_model is landmark_cf.SMOKE
    assert arch.shapes is landmark_cf.SHAPES
    jarch = jregistry.get("landmark_cf")
    assert dataclasses.asdict(arch.model) == dataclasses.asdict(jarch.model)
    assert {s.name: (s.kind, s.dims) for s in arch.shapes} == {
        s.name: (s.kind, s.dims) for s in jarch.shapes}


def test_rating_counts_match_reference():
    rng = np.random.default_rng(0)
    r = rng.integers(1, 6, size=(30, 17)).astype(np.float32)
    r *= rng.random((30, 17)) < 0.3
    r[3] = 0  # a user with no rating
    got = RatingMatrix(torch.as_tensor(r), 30, 17).rating_counts()
    want = JRatingMatrix(jnp.asarray(r), 30, 17).rating_counts()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[3] == 0
