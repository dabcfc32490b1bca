"""Process groups for the port's multi-process runs: what
``jax.distributed`` does for the reference.

The reference runs one controller over every chip; the port runs one
process a rank and joins them with ``torch.distributed``:

- :func:`init` joins a group from torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``); :func:`spawn` starts ``world`` ranks of a function
  with that environment set (the tests and ``chip_smoke.py``).
- The backend is chosen and the reason returned and printed
  (:func:`choose_backend`): NCCL when every rank of a host has its own
  card; gloo when ranks share a card (NCCL refuses two ranks of one
  communicator on one device) or run on the CPU. Gloo stages CUDA tensors
  through host memory; the computation stays on the card.
- Each rank's device is explicit: ``cuda:LOCAL_RANK % visible``, or
  ``cpu`` when asked. A rank asked for ``cuda`` that sees no card raises.
- :func:`fake_group` sets up torch's in-process ``fake`` group of N
  positions (no traffic; collectives return buffers of the right shapes)
  for the dry run, and tears it down after.
- :class:`Collectives` is a dispatch mode that sees every functional
  collective (``_c10d_functional``: what DTensor issues) and charges its
  output bytes by kind to ``kernels/cost.py::collective``: the dry run's
  count, ``launch/hlo.py``'s convention. Where gloo lacks a collective
  for CUDA tensors the layer builds it from collectives gloo has, in a
  kernel registered for the op (:func:`build_all_gather`), and
  :class:`Launch` says which (:data:`GLOO_CUDA_BUILT`: the all-gather, an
  all-to-all of the block's copies). :data:`MOVED` counts the bytes the
  backend really moved.

Kernels are built once before ranks spawn (:func:`spawn`), and
``kernels/build.py`` holds a file lock while it builds, so ranks started
by torchrun do not race on the build directory.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import socket
import traceback
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import cost

# functional collective -> the kind the dry run counts it under
KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
# gloo's collectives of CUDA tensors that the layer builds from others:
# its all-gather ends the calling process (SIGSEGV, seen with torch 2.11,
# where its all-reduce, reduce-scatter and all-to-all of CUDA tensors
# work). It is built from the all-to-all (each rank sends its whole block to
# every rank), which moves the same bytes, in a kernel registered for the
# op's CUDA key (:func:`build_all_gather`).
GLOO_CUDA_BUILT = ("all_gather_into_tensor",)


# bytes the backend moved, by kind, since reset_moved(): every Collectives
# block's, and every all-gather built from the all-to-all
MOVED: Dict[str, int] = {}


def reset_moved() -> None:
    MOVED.clear()


@dataclasses.dataclass
class Launch:
    """One rank's place: its rank, the world, its device and the backend
    with the reason it was chosen."""

    rank: int
    world: int
    local_rank: int
    device: torch.device
    backend: str
    reason: str
    built: tuple = ()  # collectives made up from others (see Collectives)

    def describe(self) -> str:
        made = (f"; built from others: {', '.join(self.built)}"
                if self.built else "")
        return (f"rank {self.rank}/{self.world} on {self.device}: backend "
                f"{self.backend} ({self.reason}){made}")


def rank_device(local_rank: int, device: str = "cuda") -> torch.device:
    """``cuda:LOCAL_RANK % visible``, or the CPU when asked. Raises when
    asked for ``cuda`` without a card."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"rank device must be cuda or cpu, got {device}")
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < 1:
        raise RuntimeError(f"rank {local_rank} asked for cuda and sees no "
                           f"CUDA device")
    return torch.device("cuda", local_rank % visible)


def choose_backend(device: torch.device, local_world: int):
    """(backend, reason): gloo on the CPU or when ranks share a card,
    NCCL when every rank of the host has a card of its own."""
    if device.type == "cpu":
        return "gloo", "ranks run on the CPU"
    visible = torch.cuda.device_count()
    if local_world > visible:
        return "gloo", (f"{local_world} ranks share {visible} card(s): NCCL "
                        f"refuses two ranks of one communicator on one "
                        f"device; gloo stages CUDA tensors through host "
                        f"memory")
    return "nccl", f"each of {local_world} ranks has a card of its own"


_LAUNCH: Optional[Launch] = None


def current() -> Optional[Launch]:
    """This process's :class:`Launch` after :func:`init`, else None."""
    return _LAUNCH


def init(device: str = "cuda", verbose: bool = True) -> Launch:
    """Join the process group torchrun's environment describes and return
    this rank's :class:`Launch` (printed when ``verbose``)."""
    global _LAUNCH
    env = os.environ
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    dev = rank_device(local_rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    chosen, reason = choose_backend(dev, local_world)
    dist.init_process_group(
        chosen, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        rank=rank, world_size=world)
    built = ()
    if chosen == "gloo" and dev.type == "cuda":
        build_all_gather("CUDA")
        built = GLOO_CUDA_BUILT
    _LAUNCH = Launch(rank, world, local_rank, dev, chosen, reason, built)
    if verbose:
        print(_LAUNCH.describe(), flush=True)
    return _LAUNCH


def shutdown() -> None:
    global _LAUNCH
    if dist.is_initialized():
        dist.destroy_process_group()
    _LAUNCH = None


# dispatch key ("CUDA", "CPU") -> the library holding its built all-gather
_BUILT: Dict[str, torch.library.Library] = {}


def build_all_gather(key: str) -> None:
    """Register, once per dispatch key, :func:`_all_gather_by_all_to_all`
    as the kernel of ``_c10d_functional.all_gather_into_tensor``: every
    all-gather of a tensor of that key this process issues, in a
    :class:`Collectives` block or not, then goes through the all-to-all
    (``"CUDA"`` in gloo's ranks on a card; a test may ask for ``"CPU"``)."""
    if key not in _BUILT:
        lib = torch.library.Library("_c10d_functional", "IMPL")
        lib.impl("all_gather_into_tensor", _all_gather_by_all_to_all, key)
        _BUILT[key] = lib


def _is_built(name: str, x) -> bool:
    return (name == "all_gather_into_tensor"
            and x.device.type.upper() in _BUILT)


def _all_gather_by_all_to_all(x: torch.Tensor, size: int, group: str
                              ) -> torch.Tensor:
    """All-gather along dim 0 as an all-to-all: the input is ``size``
    copies of the block, copy j sent to rank j, so each rank receives
    every rank's block in rank order. Its bytes are added to
    :data:`MOVED` as all-to-all."""
    ops = torch.ops._c10d_functional
    x = x.contiguous()
    splits = [x.shape[0]] * size
    sent = x.repeat((size,) + (1,) * (x.ndim - 1))
    out = ops.wait_tensor(ops.all_to_all_single(sent, splits, splits, group))
    _moved("all-to-all", _nbytes(out))
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, device: str, fn: Callable,
               args: tuple, queue, threads: Optional[int]) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if threads:
        torch.set_num_threads(threads)
    result = None
    try:
        launch = init(device, verbose=False)
        result = ("ok", pickle.dumps(fn(launch, *args)))
    except BaseException:
        result = ("error", traceback.format_exc())
        raise
    finally:
        queue.put((rank,) + result)
        shutdown()


def spawn(fn: Callable, world: int, *args, device: str = "cpu",
          threads: Optional[int] = 1, timeout: Optional[float] = None
          ) -> list:
    """Run ``fn(launch, *args)`` in ``world`` new processes, one a rank of
    a group on ``localhost`` (start method ``spawn``: the ranks import the
    port afresh), and return each rank's result in rank order. A rank that
    raises, or dies, fails the call with what it left (its traceback, or
    its exit code), as does a run past ``timeout`` seconds; the other ranks
    are stopped. On ``cuda`` the kernels are built here first. ``threads``
    caps each rank's torch threads."""
    import time

    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda":
        from ..kernels import build

        build.library()
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = mp.start_processes(
        _rank_main, args=(world, _free_port(), device, fn, args, queue,
                          threads),
        nprocs=world, join=False, start_method="spawn")
    out, errors = {}, []
    t0 = time.monotonic()
    while len(out) < world and not errors:
        if not queue.empty():
            rank, status, payload = queue.get()
            if status == "ok":
                out[rank] = pickle.loads(payload)
            else:
                errors.append(f"rank {rank}:\n{payload}")
            continue
        dead = [(r, p.exitcode) for r, p in enumerate(procs.processes)
                if p.exitcode not in (None, 0) and r not in out]
        if dead and queue.empty():
            time.sleep(0.5)  # a failing rank's report may be in flight
            if queue.empty():
                errors.append(f"ranks {dead} (rank, exit code) died "
                              f"without a report")
        elif timeout is not None and time.monotonic() - t0 > timeout:
            errors.append(f"no result from ranks "
                          f"{sorted(set(range(world)) - set(out))} after "
                          f"{timeout:.0f} s")
        else:
            time.sleep(0.05)
    if errors:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
        for p in procs.processes:
            p.join(10)
            if p.is_alive():
                p.kill()
        raise RuntimeError("a rank failed:\n" + "\n".join(errors))
    while not procs.join():
        pass
    return [out[r] for r in range(world)]


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """An in-process ``fake`` group of ``world`` positions, this process
    at ``rank`` (the dry run: collectives move nothing and return buffers
    of their shapes). Destroyed on exit, so nothing later in the process
    inherits it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_group: a process group is already set up")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def is_dtensor_op(types) -> bool:
    """Whether an op's tensor types hold a DTensor: a mode that counts
    per rank passes such an op on to DTensor, whose local ops and
    collectives then come back to it."""
    from torch.distributed.tensor import DTensor

    return any(issubclass(t, DTensor) for t in types)


def is_fake_op(types) -> bool:
    """Whether an op runs on FakeTensors: DTensor's sharding propagation
    (once per op and placements, then cached), which a mode that counts
    runs without counting."""
    from torch._subclasses.fake_tensor import FakeTensor

    return any(issubclass(t, FakeTensor) for t in types)


def _nbytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(map(_nbytes, out))
    return 0


class Collectives(TorchDispatchMode):
    """See every functional collective the block issues, under DTensor
    too (a DTensor op is passed on to DTensor, whose local ops and
    collectives then come here): each op's output bytes are charged by
    kind to ``kernels/cost.py``'s open tallies, and added to :data:`MOVED`
    by kind, but where the op is built from others, whose kernel adds what
    it moved (:func:`build_all_gather`)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if is_dtensor_op(types):
            return NotImplemented
        name = func._schema.name.split("::")[-1]
        if (func.namespace != "_c10d_functional" or name not in KINDS
                or is_fake_op(types)):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if not _is_built(name, args[0]):
            _moved(KINDS[name], _nbytes(out))
        cost.collective(KINDS[name], _nbytes(out))
        return out


def _moved(kind: str, nbytes: int) -> None:
    MOVED[kind] = MOVED.get(kind, 0) + nbytes
