"""Background landmark refresh + atomic artifact swap, one device.

The refit is ``core.landmark_cf.fit`` on the accumulated rating matrix
(landmark reselection included: fold-in freezes the landmarks, refresh
moves them to where the population is), run on a daemon thread so serving
never blocks. The committed artifact goes through
``train.checkpoint.save_landmark_state`` with ``step=generation``: a crash
mid-refresh leaves the previous generation as the loadable artifact, and
generations are monotone (``request`` refuses non-increasing ones).

On the card the thread's kernels run on that thread's current stream (the
wrappers launch on ``torch.cuda.current_stream``), which is the default
stream, and the kernel launch counters are plain attributes: read them
after :meth:`join`.

With an observability instance installed (``obs.install``), the refit
records the spans ``refresh.fit``, ``refresh.commit`` and
``refresh.ivf_rebuild`` (each ending after its device work) and bumps
``lifecycle.refreshes`` / sets ``lifecycle.refresh_generation`` at commit.

With a ``mesh``, the refit runs ``fit_distributed`` instead (users
block-partitioned over the mesh's row axes, the kNN step a scan of each
shard's rows against the gathered candidates) and the committed checkpoint
stores one file per row shard. ``fit_distributed`` selects the same
landmarks and computes the same graph as ``fit``, so the oracle property
below holds on a mesh too.

Oracle property: the swapped artifact equals a from-scratch ``fit`` with a
generator seeded by the generation on the same accumulated rows — refresh
is a schedule for refitting, never a different algorithm.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

from .. import obs as obslib
from ..core import RatingMatrix, fit
from ..core.landmark_cf import fit_distributed
from ..core.types import LandmarkSpec
from ..train.checkpoint import save_landmark_state


class RefreshManager:
    """One-in-flight background refit with checkpoint-committed results.

    ``request`` snapshots the accumulated ratings and starts the refit
    thread; ``poll`` returns ``(generation, state)`` exactly once when a
    refit has committed. Errors in the thread surface on the next ``poll``.

    ``compact`` stores the uint16/bf16 graph, gated by
    ``compact_max_rows`` — pass ``RefreshSpec.compact_max_rows`` so the
    checkpoint side agrees with the serving-side ``policy.should_compact``
    gate (skipped once U outgrows the ceiling). ``poll`` still hands back
    the full-width fitted state.

    ``ivf`` (a ``retrieval.IVFSpec``) also rebuilds the IVF index over the
    refitted representation inside the background swap (the quantizer is
    frozen between refreshes, like the landmarks); ``poll`` then returns
    ``(generation, state, index)``. The index is derived data, rebuilt from
    the artifact in one call, so it is not checkpointed.

    ``mesh`` (+ ``row_axes``) routes the refit through ``fit_distributed``
    and commits a row-sharded checkpoint; with ``ivf`` the spec then
    resolves through ``retrieval.resolve_ivf_sharded`` and the index comes
    back placed on the mesh (``retrieval.shard_index``). The fit runs on
    ``device`` (with a mesh: the device of its first shard).
    """

    def __init__(self, ckpt_dir: str, spec: LandmarkSpec, *,
                 compact: bool = False, compact_max_rows: int = 65536,
                 ivf=None, device="cuda", mesh=None,
                 row_axes=("pod", "data")):
        self.ckpt_dir = ckpt_dir
        self.spec = spec
        self.compact = compact
        self.compact_max_rows = compact_max_rows
        self.ivf = ivf
        self.mesh = mesh
        self.row_axes = row_axes
        self.device = torch.device(device)
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._result: Optional[Tuple] = None
        self._error: Optional[BaseException] = None
        self._last_generation = -1

    def _sync(self) -> None:
        """Wait for this thread's device work (its current streams, on every
        device of the mesh)."""
        devs = {self.device} | set(self.mesh.devices if self.mesh else ())
        for d in devs:
            if d.type == "cuda":
                torch.cuda.current_stream(d).synchronize()

    def _axes(self):
        from ..distributed.sharding import cf_row_axes

        return cf_row_axes(self.mesh, self.row_axes)

    def _row_shards(self) -> int:
        if self.mesh is None:
            return 1
        from ..distributed.sharding import cf_shard_count

        return cf_shard_count(self.mesh, self._axes())

    @property
    def busy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def request(self, ratings, generation: int,
                seed: Optional[int] = None) -> bool:
        """Start a background refit of ``ratings`` (the valid, unpadded
        rows). Returns False, doing nothing, while a refit is in flight.
        The fit's generator is seeded with ``seed``, by default the
        generation, so a refresh is reproducible by a from-scratch fit."""
        if self.busy:
            return False
        if generation <= self._last_generation:
            raise ValueError(f"generation must increase: {generation} <= "
                             f"{self._last_generation}")
        self._last_generation = generation
        r = np.array(ratings, dtype=np.float32)  # host snapshot
        seed = generation if seed is None else seed

        def work():
            try:
                with obslib.span("refresh.fit", cat="lifecycle",
                                 args={"generation": generation,
                                       "rows": int(r.shape[0])}):
                    rt = torch.as_tensor(r, device=self.device)
                    gen = torch.Generator().manual_seed(seed)
                    if self.mesh is not None:
                        st = fit_distributed(rt, self.spec, self.mesh,
                                             self.row_axes, generator=gen)
                    else:
                        st = fit(RatingMatrix(rt, r.shape[0], r.shape[1]),
                                 self.spec, generator=gen)
                    self._sync()
                compact = self.compact and r.shape[0] < self.compact_max_rows
                with obslib.span("refresh.commit", cat="lifecycle",
                                 args={"generation": generation}):
                    save_landmark_state(self.ckpt_dir, st, compact=compact,
                                        step=generation,
                                        row_shards=self._row_shards())
                o = obslib.current()
                if o is not None and o.enabled:
                    o.registry.counter("lifecycle.refreshes").inc()
                    o.registry.gauge("lifecycle.refresh_generation").set(
                        float(generation))
                if self.ivf is not None:
                    from ..retrieval import build_index, resolve_ivf

                    u = st.representation.shape[0]
                    with obslib.span("refresh.ivf_rebuild", cat="lifecycle",
                                     args={"generation": generation}):
                        if self.mesh is not None:
                            from ..retrieval import (resolve_ivf_sharded,
                                                     shard_index)

                            cfg = resolve_ivf_sharded(self.ivf, u,
                                                      self._row_shards())
                            index = shard_index(
                                build_index(st.representation, cfg,
                                            self.spec.d2),
                                self.mesh, self._axes())
                        else:
                            cfg = resolve_ivf(self.ivf, u)
                            index = build_index(st.representation, cfg,
                                                self.spec.d2)
                        self._sync()
                    result = (generation, st, index)
                else:
                    result = (generation, st)
                with self._lock:
                    self._result = result
            except BaseException as e:  # surfaced on the next poll
                with self._lock:
                    self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def poll(self) -> Optional[Tuple]:
        """Non-blocking: the committed (generation, state[, index]), once per
        refit; None while nothing new has committed."""
        with self._lock:
            if self._error is not None:
                err, self._error = self._error, None
                raise RuntimeError("background refresh failed") from err
            result, self._result = self._result, None
        return result

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
