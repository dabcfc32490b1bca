"""What one step costs, counted while it runs.

The port's counterpart of the reference's ``launch/hlo.py``, which reads
the collective bytes from the compiled HLO, and of the XLA cost and memory
analyses that the reference's dry run reads beside it. Torch compiles
nothing ahead, so :func:`measure` runs the step once, on ``meta`` tensors
(no memory, no arithmetic) or on real ones, and counts as it goes:

- ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  matrix products, convolutions and attention calls, plus the kernels' own
  operations, each charged by its wrapper from its formula in
  ``kernels/cost.py`` (the formula behind ``chip_smoke.py``'s bound);
- ``bytes_accessed``: every operation's tensor inputs and outputs summed,
  unfused (a view moves nothing, an allocation writes nothing), plus the
  kernels' bytes from the same formulas;
- ``collectives``: the bytes and count of each kind of the port's explicit
  collectives (``distributed/sharding.py``: ``all_gather_rows``,
  ``ordered_sum``, ``gather_rows``; ``distributed/compression.py``), in
  the reference's ``collective_bytes`` layout;
- ``memory``: the argument bytes (the distinct storages the inputs hold),
  the output bytes (those of the tensors the step returns) and the temp
  bytes: the peak of the bytes of storages the step made and held at
  once, outputs included.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, Iterator, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from ..kernels import cost

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
# allocations: nothing read, nothing written
ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided"}


def tensors(obj: Any) -> Iterator[torch.Tensor]:
    """Every tensor in ``obj``: a tensor, a module's parameters and
    buffers, the values of a dict, the items of a list or tuple, the
    fields of a dataclass."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensors(getattr(obj, f.name))


def storage_bytes(obj: Any) -> int:
    """Bytes of the distinct storages of the tensors in ``obj``."""
    seen = {}
    for t in tensors(obj):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _flat_bytes(items) -> int:
    total = 0
    for x in items:
        if isinstance(x, (list, tuple)):
            total += sum(map(_nbytes, x))
        else:
            total += _nbytes(x)
    return total


class _Traffic(TorchDispatchMode):
    """Bytes each operation reads and writes, and the live bytes of the
    storages made under the mode (their peak)."""

    def __init__(self, known):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in tensors(known):  # the arguments: held before the step
            self._seen[t.untyped_storage()] = 0
        self._views: Dict[Any, bool] = {}

    def _is_view(self, func) -> bool:
        v = self._views.get(func)
        if v is None:
            v = any(r.alias_info is not None and not r.alias_info.is_write
                    for r in func._schema.returns)
            self._views[func] = v
        return v

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._drop, n)

    def _drop(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else (out,)
        if not self._is_view(func):
            if func._schema.name.split("::")[-1] not in ALLOCATIONS:
                self.bytes += (_flat_bytes(args) + _flat_bytes(kwargs.values())
                               + _flat_bytes(outs))
            for t in outs:
                if isinstance(t, torch.Tensor):
                    self._hold(t)
        return out


@dataclasses.dataclass
class StepCosts:
    """One step's count (see the module's notes); ``kernels`` by wrapper:
    ``{name: {"calls", "ops", "bytes"}}``."""

    seconds: float
    flops: float
    matmul_flops: float
    kernel_ops: float
    bytes_accessed: float
    collectives: Dict[str, Any]
    memory: Dict[str, int]
    kernels: Dict[str, Dict[str, float]]

    @staticmethod
    def combine(terms) -> "StepCosts":
        """Σ coefficient · count over ``terms``, (coefficient, StepCosts)
        pairs, every number alike (``seconds``: the runs' sum)."""
        def mix(vals):
            a = vals[0][1]
            if isinstance(a, dict):
                keys = set().union(*(v.keys() for _, v in vals))
                return {k: mix([(w, v.get(k, 0)) for w, v in vals])
                        for k in keys}
            return type(a)(sum(w * v for w, v in vals))

        out = {f.name: mix([(w, getattr(c, f.name)) for w, c in terms])
               for f in dataclasses.fields(StepCosts)}
        out["seconds"] = sum(c.seconds for _, c in terms)
        return StepCosts(**out)


def measure(fn: Callable, args: Tuple[Any, ...]) -> Tuple[Any, StepCosts]:
    """Run ``fn(*args)`` once and count what it costs: ``(its result,
    StepCosts)``. Runs where the arguments lie; on ``meta`` the kernel
    wrappers charge their calls without launching."""
    arg_bytes = storage_bytes(args)
    traffic = _Traffic(args)
    flop_mode = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with cost.tally() as tally, flop_mode, traffic:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    kernels = {name: {"calls": calls, "ops": ops, "bytes": nbytes}
               for name, (calls, ops, nbytes) in tally["kernels"].items()}
    kernel_ops = sum(k["ops"] for k in kernels.values())
    kernel_bytes = sum(k["bytes"] for k in kernels.values())
    coll: Dict[str, Any] = {k: 0.0 for k in KINDS}
    counts = {k: 0 for k in KINDS}
    for kind, (count, nbytes) in tally["collectives"].items():
        coll[kind] += float(nbytes)
        counts[kind] += count
    coll["_counts"] = counts
    matmul = float(flop_mode.get_total_flops())
    return out, StepCosts(
        seconds=seconds, flops=matmul + kernel_ops, matmul_flops=matmul,
        kernel_ops=kernel_ops,
        bytes_accessed=float(traffic.bytes + kernel_bytes),
        collectives=coll,
        memory={"argument_size_in_bytes": arg_bytes,
                "output_size_in_bytes": storage_bytes(out),
                "temp_size_in_bytes": traffic.peak},
        kernels=kernels)
