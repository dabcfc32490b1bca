"""The port's logical-axis layer (``distributed/sharding.py``) and the LM
family's logical trees against the reference's, on the CPU.

- ``filter_rules``, ``spec_for``, ``divisible`` and ``tree_shardings``'
  specs equal the reference's ``PartitionSpec`` tuples for every arch's
  rules, on the debug, production and multi-pod meshes (JAX
  ``AbstractMesh`` es; nothing is placed).
- ``lm_logical``, ``cache_logical``, ``landmark_cache_logical`` and
  ``opt_state_logical`` equal the reference's trees for the five LM
  archs; the port's per-block names take the reference's stacked tuples
  without their leading ``"layers"`` (``param_logical``, the one
  mapping).
- Each LM train cell's parameters and optimizer state, placed by
  ``launch/steps.py`` on ``meta`` over an in-process ``fake`` group of the
  mesh's size, hold at position 0 (the fullest rank) the reference's
  per-device shape: ``NamedSharding(AbstractMesh, spec).shard_shape``
  where the dims divide, the ceil of each dim over its axes where they do
  not (DTensor's first blocks, a padded JAX array's).
"""
import torch_thread_cap  # noqa: F401 (torch threads per xdist worker)
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jregistry
from repro.distributed import sharding as J
from repro.models import transformer as JT
from repro.train import optimizer as jopt
from repro_torch.configs import registry
from repro_torch.distributed import sharding as S
from repro_torch.launch import dist
from repro_torch.launch.mesh import (DEBUG, DEBUG_MULTI_POD, MULTI_POD,
                                     PRODUCTION, apart, device_mesh)
from repro_torch.launch.steps import build_cell
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as topt

MESHES = {"debug": DEBUG, "debug_multi_pod": DEBUG_MULTI_POD,
          "production": PRODUCTION, "multi_pod": MULTI_POD}
LM_ARCHS = [n for n, a in registry.ARCHS.items() if a.family == "lm"]


def _abstract(mesh):
    names, sizes = mesh
    return AbstractMesh(sizes, names)


def _pspec(spec) -> tuple:
    return tuple(P(*spec))


def _is_logical(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _leaves(tree, prefix=()):
    """(path, leaf) pairs of a dict tree whose leaves are logical tuples or
    tensors, sorted by key."""
    if _is_logical(tree) or isinstance(tree, (torch.Tensor, S.Sharding)):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _leaves(tree[k], prefix + (k,))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_rules_and_specs_equal_the_reference(mesh):
    jm = _abstract(MESHES[mesh])
    sizes = dict(zip(*MESHES[mesh]))
    for name, arch in registry.ARCHS.items():
        jarch = jregistry.get(name)
        assert arch.rules == jarch.rules, name
        got, want = S.filter_rules(arch.rules, sizes), J.filter_rules(
            jarch.rules, jm)
        assert got == want, (name, mesh)
        if arch.family != "lm":
            continue
        # the long-context cache is batch 1: its cell replicates the batch
        one = dict(arch.rules, batch=None)
        trees = [(T.lm_logical(arch.model), arch.rules),
                 (T.cache_logical(), arch.rules),
                 (T.cache_logical(True, True), one),
                 (T.landmark_cache_logical(), arch.rules)]
        jtrees = [JT.lm_logical(jarch.model), JT.cache_logical(),
                  JT.cache_logical(True, True), JT.landmark_cache_logical()]
        for (tree, rules), jtree in zip(trees, jtrees):
            ours = [sh for _, sh in _leaves(S.tree_shardings(
                tree, sizes, rules))]
            theirs = jax.tree_util.tree_leaves(J.tree_shardings(
                jtree, jm, rules))
            assert [_pspec(sh.spec) for sh in ours] == [
                tuple(sh.spec) for sh in theirs], (name, mesh)
            for path, la in _leaves(tree):
                assert _pspec(S.spec_for(la, S.filter_rules(rules, sizes))) \
                    == tuple(J.spec_for(la, J.filter_rules(rules, jm))), (
                        name, path)
        for dim in (1, 6, 15, 16, 960, 49152):
            for axes in (None, "model", ("pod", "data"), ("data", "model"),
                         ("pod", "data", "model")):
                assert S.divisible(dim, axes, sizes) == J.divisible(
                    dim, axes, jm), (dim, axes)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_logical_trees_equal_the_reference(name):
    arch, jarch = registry.get(name), jregistry.get(name)
    assert T.lm_logical(arch.model) == JT.lm_logical(jarch.model)
    for long_ctx in (False, True):
        for quant in (False, True):
            assert T.cache_logical(long_ctx, quant) == JT.cache_logical(
                long_ctx, quant)
    assert T.landmark_cache_logical() == JT.landmark_cache_logical()
    logical = T.lm_logical(arch.model)
    for opt in (arch.opt, topt.OptConfig(name="adafactor"),
                topt.OptConfig(name="adafactor", momentum=True)):
        jcfg = jopt.OptConfig(name=opt.name, momentum=opt.momentum,
                              factored=opt.factored)
        assert topt.opt_state_logical(logical, opt) == \
            jopt.opt_state_logical(logical, jcfg)
    # the layer mapping: block i's parameter takes the stacked tuple
    # without its leading "layers"
    by_name = T.param_logical(arch.model)
    model = T.LM(arch.smoke_model, device="meta")
    smoke = T.param_logical(arch.smoke_model)
    assert sorted(smoke) == sorted(n for n, _ in model.named_parameters())
    for pname, la in by_name.items():
        if pname.startswith("layers."):
            stacked = logical["layers"][pname.split(".", 2)[2]]
            assert stacked[0] == "layers" and la == stacked[1:]
        else:
            assert la == logical[pname]


def _want_shape(shape, spec, jm) -> tuple:
    """The reference's per-device shape of ``shape`` under ``spec``: JAX's
    own where every dim divides, else each dim's ceil over its axes."""
    sizes = dict(jm.shape)
    if all(d % math.prod(sizes[a] for a in (
            () if e is None else (e,) if isinstance(e, str) else e)) == 0
           for d, e in zip(shape, tuple(spec) + (None,) * len(shape))):
        return tuple(NamedSharding(jm, P(*spec)).shard_shape(tuple(shape)))
    out = []
    for d, e in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if e is None else (e,) if isinstance(e, str) else e
        out.append(-(-d // math.prod(sizes[a] for a in axes)))
    return tuple(out)


@pytest.mark.parametrize("mesh", ["debug", "production", "multi_pod"])
def test_placed_train_cells_hold_the_reference_shard_shapes(mesh):
    names, sizes = MESHES[mesh]
    jm = _abstract(MESHES[mesh])
    with dist.fake_group(math.prod(sizes)):
        dm = device_mesh(names, sizes, "cpu")
        for name in LM_ARCHS:
            arch, jarch = registry.get(name), jregistry.get(name)
            rules = J.filter_rules(jarch.rules, jm)
            cell = build_cell(arch, "train_4k", mesh=dm)
            model, opt_state, batch = cell.args
            logical = T.lm_logical(arch.model)
            for pname, p in model.named_parameters():
                la = T.param_logical(arch.model)[pname]
                want = _want_shape(p.shape, J.spec_for(la, rules), jm)
                assert tuple(p.to_local().shape) == want, (name, pname)
            ologic = dict(_leaves(topt.opt_state_logical(logical, arch.opt)))
            for path, st in _leaves(opt_state):
                if path == ("step",):
                    continue
                want = _want_shape(st.shape, J.spec_for(ologic[path],
                                                        rules), jm)
                assert tuple(st.to_local().shape) == want, (name, path)
            for key, tok in batch.items():
                spec = J.spec_for(("null", "batch", "null")
                                  if tok.ndim == 3 else ("batch", "null"),
                                  rules)
                assert tuple(tok.to_local().shape) == _want_shape(
                    tok.shape, spec, jm)


def test_a_spec_naming_data_without_pod_is_placed_with_them_apart():
    """At multi-pod the long-context cache's ``kv_seq_all`` (data, model)
    is replicated over pod: the merged ``pod*data`` dim cannot place it,
    and the mesh with pod and data apart places it as the reference."""
    names, sizes = MULTI_POD
    jm = _abstract(MULTI_POD)
    rules = dict(registry.get("smollm-360m").rules, batch=None)
    la = T.cache_logical(True)
    spec = S.spec_for(la["k"], S.filter_rules(rules, dict(zip(names,
                                                              sizes))))
    with dist.fake_group(math.prod(sizes)):
        dm = device_mesh(names, sizes, "cpu")
        assert S.splits_merged(la, rules, dm)
        assert not S.splits_merged(T.cache_logical(), rules, dm)
        with pytest.raises(ValueError, match="without the rest"):
            S.placements(spec, dm)
        sep = apart(dm)
        assert sep.mesh_dim_names == names
        assert tuple(sep.mesh.shape) == sizes
        assert torch.equal(sep.mesh.flatten(), dm.mesh.flatten())
        assert not S.splits_merged(la, rules, sep)
        shape = (32, 1, 524288, 5, 64)
        t = S.distribute(torch.empty(shape, device="meta"), sep, spec)
        assert tuple(t.to_local().shape) == tuple(
            NamedSharding(jm, P(*spec)).shard_shape(shape))


def test_fake_group_is_torn_down():
    with dist.fake_group(8):
        assert torch.distributed.get_world_size() == 8
    assert not torch.distributed.is_initialized()
