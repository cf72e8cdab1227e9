"""Fault tolerance for the train loop: preemption, stragglers, the restart
manifest (counterpart: ``repro/distributed/fault_tolerance.py``; a copy of
its ``PreemptionHandler``, ``StragglerMonitor`` and ``RestartManifest``,
which import no jax, kept here because the port imports nothing of
``repro``).

* :class:`PreemptionHandler` — SIGTERM/SIGINT -> synchronous checkpoint at
  the next step boundary, then clean exit (requeue-able).
* :class:`StragglerMonitor` — per-step wall-time EMA; steps slower than
  ``threshold x`` EMA are flagged and recorded into the manifest.
* :class:`RestartManifest` — tiny JSON (step, mesh shape, data cursor,
  checkpoint path). ``save`` is atomic (tmp file + ``os.replace``).
"""
from __future__ import annotations

import json
import os
import signal
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional


class PreemptionHandler:
    """Convert SIGTERM/SIGINT into a checkpoint-at-step-boundary request."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._prev = {}
        self._signals = signals

    def install(self) -> "PreemptionHandler":
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def uninstall(self) -> None:
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()

    def _handler(self, signum, frame):
        self.requested = True


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, ema: float = 0.9,
                 warmup_steps: int = 5):
        self.threshold = threshold
        self.ema_coef = ema
        self.warmup = warmup_steps
        self.ema: Optional[float] = None
        self.n = 0
        self.flagged: List[Dict[str, float]] = []
        self._t0: Optional[float] = None

    def step_start(self) -> None:
        self._t0 = time.monotonic()

    def step_end(self, step: int) -> Optional[Dict[str, float]]:
        dt = time.monotonic() - (self._t0 or time.monotonic())
        self.n += 1
        flag = None
        if self.ema is not None and self.n > self.warmup and \
                dt > self.threshold * self.ema:
            flag = {"step": step, "seconds": dt, "ema": self.ema}
            self.flagged.append(flag)
        self.ema = dt if self.ema is None else (
            self.ema_coef * self.ema + (1 - self.ema_coef) * dt)
        return flag


@dataclass
class RestartManifest:
    step: int
    checkpoint_dir: str
    mesh_shape: List[int]
    mesh_axes: List[str]
    data_seed: int
    arch: str = ""
    shape: str = ""
    straggler_events: List[Dict[str, float]] = field(default_factory=list)
    # Serving checkpoint (``ServeEngine.snapshot()``): queued + in-flight
    # request state and the engine/env config needed to re-prefill and drain
    # to byte-identical greedy completions after a preemption. ``None`` for
    # training manifests.
    serve: Optional[Dict[str, Any]] = None
    # Training loop state (``launch/train.py``'s ``loop_state``): data salt,
    # loss EWMA, skip/rollback counters, RNG key — the same payload the
    # checkpoint ``extra`` carries, mirrored here so a restart controller
    # can inspect it without opening the checkpoint. ``None`` for serving
    # manifests.
    train: Optional[Dict[str, Any]] = None

    def save(self, path: str) -> None:
        """Atomically persist: write ``path + ".tmp"``, fsync, then
        ``os.replace``. A crash mid-save leaves either the previous manifest
        or none — never a torn file — and the orphaned tmp is removed on the
        failure path so a retry starts clean."""
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(asdict(self), f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @classmethod
    def load(cls, path: str) -> "RestartManifest":
        with open(path) as f:
            return cls(**json.load(f))
