"""Device meshes for sharded CF serving, in one process.

The reference shards from one controller (``shard_map`` over a
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
:func:`make_mesh` does; the dry run places them on ``meta``.

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



def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The reference's production mesh: one 16×16 pod (data, model), or
    with ``multi_pod`` two of them (pod=2, data=16, model=16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(axes, shape, device)


def make_debug_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The reference's small mesh for fast iteration, 8 positions:
    data=2, model=4, or with ``multi_pod`` pod=2, data=2, model=2."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(axes, shape, device)


def make_host_mesh(device="cuda") -> Mesh:
    """One position, every axis of size 1 (data=1, model=1)."""
    return make_mesh(("data", "model"), (1, 1), device)
