"""Device meshes: ``torch.distributed`` meshes over the ranks of a
process group (:func:`device_mesh`, the LM's logical-axis sharding), and
single-process meshes for sharded CF serving.

:func:`device_mesh` lays the reference's axis names over the current
world (``launch/dist.py``): a ``DeviceMesh`` of ``device``'s type whose
position (a, b, …) is rank a·|b|·… + b·… + …, the reference's row-major
device order. With ``dist=True`` the reference's three named meshes come
in that form.

For the CF mesh paths the reference shards from one controller (``shard_map`` over a
``jax.sharding.Mesh``). The port keeps that model: a :class:`Mesh` is a set
of named axes over a list of ``torch.device`` s in mesh-linearized order
(row-major over the axes, the last axis fastest), and the position of a
device in that list is its linear index. A sharded array is a list of
per-shard tensors, shard s on ``mesh.devices[s]``; collectives are explicit
functions of ``distributed.sharding`` (an all-gather concatenates the
shards' blocks in linear order, a sum adds them in that order).

On the card the positions are placed round-robin over the visible CUDA
devices, so a mesh of 4 or 8 shards runs on one H100 with every shard's
blocks and kernel launches of its own: this shows the sharded algorithm's
correctness and per-shard cost, not cross-card bandwidth. On the CPU every
position is ``cpu``.

The reference's three named meshes come as functions of the same name
(:func:`make_production_mesh`, :func:`make_debug_mesh`,
:func:`make_host_mesh`), each placing its positions on ``device`` as
:func:`make_mesh` does, or with ``dist=True`` a ``DeviceMesh`` over the
world (the dry run's world is ``launch/dist.py::fake_group``).

Functions, not module constants: importing this module touches no device.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over devices in mesh-linearized order."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} vs sizes {self.sizes}")
        n = 1
        for s in self.sizes:
            n *= s
        if len(self.devices) != n:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{n} positions")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return len(self.devices)

    def describe(self) -> str:
        """``pod=2,data=2: 4 shards on 1 device(s): cuda:0 x4``."""
        axes = ",".join(f"{a}={s}" for a, s in zip(self.axis_names,
                                                    self.sizes))
        used = Counter(str(d) for d in self.devices)
        return (f"{axes}: {self.size} shards on {len(used)} device(s): "
                + ", ".join(f"{d} x{c}" for d, c in used.items()))


def mesh_devices(count: int, device="cuda") -> Tuple[torch.device, ...]:
    """``count`` positions placed round-robin over the visible devices of
    ``device``'s type (every one ``cpu`` on the CPU). Asking for ``cuda``
    without a card raises, as every entry point of the port does."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return (dev,) * count
    visible = torch.cuda.device_count()
    if visible < 1:
        raise RuntimeError("a cuda mesh needs a CUDA device")
    return tuple(torch.device("cuda", i % visible) for i in range(count))


def make_mesh(names: Sequence[str], sizes: Sequence[int],
              device="cuda") -> Mesh:
    """A mesh of the named axes, its positions on ``device``
    (:func:`mesh_devices`)."""
    names, sizes = tuple(names), tuple(int(s) for s in sizes)
    n = 1
    for s in sizes:
        if s < 1:
            raise ValueError(f"mesh axis sizes must be >= 1, got {sizes}")
        n *= s
    return Mesh(names, sizes, mesh_devices(n, device))



def device_mesh(names: Sequence[str], sizes: Sequence[int],
                device="cuda", merge: bool = True):
    """A ``torch.distributed`` ``DeviceMesh`` with the axes ``names`` of
    ``sizes`` over the current world, whose size must be their product
    (raises naming both). ``device`` gives the mesh's device type: a
    rank's tensors live on its own device (``launch/dist.py``). With
    ``merge``, ``pod`` and ``data`` become one mesh dim ``pod*data`` (rank
    order unchanged); ``distributed/sharding.py::mesh_axes`` still reports
    them apart. A spec that names ``data`` without ``pod`` needs them
    apart (:func:`apart`)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    names, sizes = tuple(names), tuple(int(s) for s in sizes)
    n = 1
    for s in sizes:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"a mesh of {dict(zip(names, sizes))} needs {n} "
                         f"ranks, the world has {world}")
    # pod and data side by side are one mesh dim: every rule names them
    # together (a batch or a weight split over pod x data), and DTensor
    # plans a dim split over two mesh dims with strided shards, a search
    # that takes minutes a step on three axes
    merged = {}
    dims, dim_sizes = list(names), list(sizes)
    if merge and "pod" in names and "data" in names and \
            names.index("data") == names.index("pod") + 1:
        i = names.index("pod")
        key = "pod*data"
        merged[key] = {"pod": sizes[i], "data": sizes[i + 1]}
        dims[i:i + 2] = [key]
        dim_sizes[i:i + 2] = [sizes[i] * sizes[i + 1]]
    mesh = init_device_mesh(torch.device(device).type, tuple(dim_sizes),
                            mesh_dim_names=tuple(dims))
    mesh._merged_sizes = merged
    return mesh


def apart(mesh):
    """``mesh`` (a ``DeviceMesh`` of :func:`device_mesh`) with ``pod`` and
    ``data`` as mesh dims of their own, over the same ranks in the same
    order: the mesh of a cell whose spec names ``data`` without ``pod``
    (the long-context cache's ``kv_seq_all``, split over data and model
    and replicated over pod), which one merged dim cannot place. ``mesh``
    itself where nothing is merged."""
    merged = getattr(mesh, "_merged_sizes", {})
    if not merged:
        return mesh
    names, sizes = [], []
    for name, size in zip(mesh.mesh_dim_names, mesh.mesh.shape):
        parts = merged.get(name, {name: int(size)})
        names += list(parts)
        sizes += list(parts.values())
    return device_mesh(names, sizes, mesh.device_type, merge=False)


def _named(axes, shape, device, dist: bool):
    return (device_mesh(axes, shape, device) if dist
            else make_mesh(axes, shape, device))


PRODUCTION = (("data", "model"), (16, 16))
MULTI_POD = (("pod", "data", "model"), (2, 16, 16))
DEBUG = (("data", "model"), (2, 4))
DEBUG_MULTI_POD = (("pod", "data", "model"), (2, 2, 2))


def make_production_mesh(*, multi_pod: bool = False, device="cuda",
                         dist: bool = False):
    """The reference's production mesh: one 16×16 pod (data, model), or
    with ``multi_pod`` two of them (pod=2, data=16, model=16); a
    ``DeviceMesh`` over the world with ``dist``."""
    return _named(*(MULTI_POD if multi_pod else PRODUCTION), device, dist)


def make_debug_mesh(*, multi_pod: bool = False, device="cuda",
                    dist: bool = False):
    """The reference's small mesh for fast iteration, 8 positions:
    data=2, model=4, or with ``multi_pod`` pod=2, data=2, model=2."""
    return _named(*(DEBUG_MULTI_POD if multi_pod else DEBUG), device, dist)


def make_host_mesh(device="cuda", dist: bool = False):
    """One position, every axis of size 1 (data=1, model=1)."""
    return _named(("data", "model"), (1, 1), device, dist)
