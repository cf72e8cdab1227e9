"""Fault tolerance: preemption, stragglers, shard health, the restart
manifest (counterpart: ``repro/distributed/fault_tolerance.py``; a copy of
its classes, which import no jax, kept here because the port imports
nothing of ``repro``).

* :class:`PreemptionHandler` — SIGTERM/SIGINT -> synchronous checkpoint at
  the next step boundary, then clean exit (requeue-able).
* :class:`StragglerMonitor` — per-step wall-time EMA; steps slower than
  ``threshold x`` EMA are flagged and recorded into the manifest.
* :class:`HealthMonitor` — a fleet's per-shard heartbeat ledger: a shard
  that answers a step beats; ``miss_suspect`` consecutive misses make it
  SUSPECT (no new routing), ``miss_dead`` DEAD (its work fails over).
* :class:`RestartManifest` — tiny JSON (step, mesh shape, data cursor,
  checkpoint path). ``save`` is atomic (tmp file + ``os.replace``).
"""
from __future__ import annotations

import enum
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


class ShardState(str, enum.Enum):
    """Failure-domain state of one fleet shard. LIVE shards take new work;
    SUSPECT shards keep their in-flight work but get no new routing until
    they beat again; DEAD is sticky (a late reply never resurrects it)."""

    LIVE = "live"
    SUSPECT = "suspect"
    DEAD = "dead"

    def __str__(self) -> str:
        return self.value


class HealthMonitor:
    """Per-shard heartbeat ledger: miss-threshold -> suspect -> dead.

    The fleet calls :meth:`beat` when a shard answers a step with its
    heartbeat flag set and :meth:`miss` when it does not (timeout, stall, a
    dropped flag); :meth:`mark_dead` skips the escalation for unambiguous
    failures (process exit, closed pipe, a raised kill). Transitions are
    appended to ``events``."""

    def __init__(self, n_shards: int, *, miss_suspect: int = 2,
                 miss_dead: int = 4):
        assert 0 < miss_suspect <= miss_dead
        self.miss_suspect, self.miss_dead = miss_suspect, miss_dead
        self.states = [ShardState.LIVE] * n_shards
        self.misses = [0] * n_shards
        self.beats = [0] * n_shards
        self.suspects = 0
        self.recoveries = 0
        self.deaths = 0
        self.events: List[Dict[str, Any]] = []

    def state(self, shard: int) -> ShardState:
        return self.states[shard]

    def alive(self, shard: int) -> bool:
        return self.states[shard] is not ShardState.DEAD

    @property
    def live_shards(self) -> List[int]:
        return [s for s, st in enumerate(self.states)
                if st is ShardState.LIVE]

    @property
    def dead_shards(self) -> List[int]:
        return [s for s, st in enumerate(self.states)
                if st is ShardState.DEAD]

    def beat(self, shard: int, step: int) -> ShardState:
        """A heartbeat arrived; a SUSPECT shard recovers to LIVE."""
        if self.states[shard] is ShardState.DEAD:
            return ShardState.DEAD                 # zombies stay dead
        self.beats[shard] += 1
        self.misses[shard] = 0
        if self.states[shard] is ShardState.SUSPECT:
            self.states[shard] = ShardState.LIVE
            self.recoveries += 1
            self.events.append({"kind": "recover", "shard": shard,
                                "step": step})
        return self.states[shard]

    def miss(self, shard: int, step: int) -> ShardState:
        """A heartbeat was missed; escalate suspect -> dead at thresholds."""
        if self.states[shard] is ShardState.DEAD:
            return ShardState.DEAD
        self.misses[shard] += 1
        if self.misses[shard] >= self.miss_dead:
            return self.mark_dead(shard, step,
                                  f"{self.misses[shard]} missed heartbeats")
        if (self.misses[shard] >= self.miss_suspect
                and self.states[shard] is ShardState.LIVE):
            self.states[shard] = ShardState.SUSPECT
            self.suspects += 1
            self.events.append({"kind": "suspect", "shard": shard,
                                "step": step, "misses": self.misses[shard]})
        return self.states[shard]

    def mark_dead(self, shard: int, step: int, reason: str) -> ShardState:
        if self.states[shard] is not ShardState.DEAD:
            self.states[shard] = ShardState.DEAD
            self.deaths += 1
            self.events.append({"kind": "dead", "shard": shard,
                                "step": step, "reason": reason})
        return ShardState.DEAD


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
