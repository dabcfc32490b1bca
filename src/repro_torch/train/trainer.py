"""Training loop: prefetching, checkpoint/restart, straggler monitoring,
SIGTERM-safe emergency save — the reference's ``repro.train.trainer`` on
one device.

The step function updates the model and the optimizer state in place and
returns them with its metrics; the loop reads the loss once a step
(``float``), which is its one host sync. A checkpoint is
``(lm_tree(model), opt_state)``, the reference's ``(params, opt_state)``
tree, so either package resumes from the other's.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from ..models.convert import lm_tree, load_lm_tree
from .checkpoint import (AsyncCheckpointer, _flatten, latest_step,
                         restore_checkpoint)


@dataclasses.dataclass
class StragglerMonitor:
    """Per-step EWMA + outlier detection (the reference's: on one process
    it records the decisions)."""

    ewma: float = 0.0
    alpha: float = 0.1
    threshold: float = 2.0
    window: deque = dataclasses.field(default_factory=lambda: deque(maxlen=50))
    flagged: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.window.append(dt)
        if self.ewma == 0.0:
            self.ewma = dt
        slow = dt > self.threshold * self.ewma and len(self.window) > 5
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        if slow:
            self.flagged.append((step, dt, self.ewma))
        return slow


class Prefetcher:
    """One-batch-ahead host→device pipeline (double buffering): ``put`` of
    the next batch is issued when the current one is handed out."""

    def __init__(self, it: Iterator, put: Callable[[Any], Any]):
        self.it = it
        self.put = put
        self._next = None
        self._prime()

    def _prime(self):
        try:
            self._next = self.put(next(self.it))
        except StopIteration:
            self._next = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._next is None:
            raise StopIteration
        out = self._next
        self._prime()
        return out


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A batch of host arrays on ``device``: for a card, pinned host copies
    sent with ``non_blocking=True`` (the copy overlaps the running step)."""
    device = torch.device(device)
    out = {}
    for key, val in batch.items():
        t = torch.as_tensor(val)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t
    return out


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10


@torch.no_grad()
def _copy_into(dst, src) -> None:
    for d, s in zip(_flatten(dst), _flatten(src)):
        d.copy_(s)


def train_loop(
    step_fn: Callable,  # (model, opt_state, batch) -> (model, opt_state, metrics)
    model: torch.nn.Module,
    opt_state: Dict,
    batches: Iterator,
    cfg: TrainerConfig,
    log: Callable[[str], None] = print,
) -> Dict[str, Any]:
    """Run ``total_steps``; resume from the latest checkpoint if present
    (restored into ``model`` and ``opt_state`` in place)."""
    start_step = 0
    ckpt = AsyncCheckpointer(cfg.ckpt_dir, cfg.keep) if cfg.ckpt_dir else None
    if cfg.ckpt_dir and latest_step(cfg.ckpt_dir) is not None:
        start_step = latest_step(cfg.ckpt_dir)
        params, opt = restore_checkpoint(cfg.ckpt_dir,
                                         (lm_tree(model), opt_state),
                                         device=model.embed.device)
        load_lm_tree(model, params)
        _copy_into(opt_state, opt)
        log(f"resumed from step {start_step}")

    # SIGTERM → emergency checkpoint before exiting (preemption safety).
    interrupted = {"flag": False}

    def _on_term(signum, frame):
        interrupted["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, _on_term)

    monitor = StragglerMonitor()
    losses = []
    step = start_step
    try:
        for step in range(start_step, cfg.total_steps):
            try:
                batch = next(batches)
            except StopIteration:
                break
            t0 = time.perf_counter()
            model, opt_state, metrics = step_fn(model, opt_state, batch)
            losses.append(float(metrics["loss"]))  # the step's one sync
            dt = time.perf_counter() - t0
            slow = monitor.observe(step, dt)
            if step % cfg.log_every == 0:
                log(f"step {step:5d} loss {losses[-1]:.4f} {dt*1e3:.0f}ms"
                    + (" [straggler]" if slow else ""))
            if ckpt and (step + 1) % cfg.ckpt_every == 0:
                ckpt.save(step + 1, (lm_tree(model), opt_state))
            if interrupted["flag"]:
                log(f"SIGTERM at step {step}: emergency checkpoint")
                if ckpt:
                    ckpt.save(step + 1, (lm_tree(model), opt_state))
                break
    finally:
        if ckpt:
            ckpt.wait()
        signal.signal(signal.SIGTERM, old_handler)

    return {
        "params": model,
        "opt_state": opt_state,
        "losses": losses,
        "last_step": step,
        "stragglers": monitor.flagged,
    }
