"""Deterministic fault injection for the train loop (counterpart: the
train-loop part of ``repro/distributed/chaos.py``: ``TrainStepCrashError``,
``nan_grad_hook``, ``TrainChaosConfig`` and ``TrainChaosMonkey``).

Every decision is drawn from ``numpy.random.default_rng(seed)`` exactly as
the reference draws it, so a plan equals the reference's step for step.
``TrainChaosConfig.from_env()`` parses the ``REPRO_CHAOS`` knob (e.g.
``REPRO_CHAOS="nan=2,slow=1,spike=1,preempt=11,seed=7"``).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.tree import tree_map

CHAOS_ENV = "REPRO_CHAOS"


class ChaosError(RuntimeError):
    """Base class for injected faults."""


class TrainStepCrashError(ChaosError):
    """Injected hard train-step failure, raised on the host *before* the
    dispatch — the training analogue of a node loss. The
    ``TrainSupervisor``'s bounded restart budget absorbs it by resuming from
    the last verified checkpoint."""


def nan_grad_hook(loss, grads, arm):
    """NaN-gradient injection for ``make_train_step(grad_hook=...)``
    (counterpart: the reference's trace-time hook). ``arm`` is an int32
    device scalar: nonzero poisons every floating-point gradient leaf with
    NaN so the step's non-finite guard must skip the update; a disarmed
    step passes through bitwise-unchanged (``torch.where`` with a false
    predicate is identity). The choice is made on the device, so the step
    reads nothing back to the host.
    """
    bad = arm > 0
    poisoned = tree_map(
        lambda g: torch.where(bad, torch.full_like(g, float("nan")), g)
        if g.is_floating_point() else g, grads)
    return loss, poisoned


TRAIN_CHAOS_KNOBS = ("seed", "nan", "slow", "spike", "crash", "ckpt_fail",
                     "torn", "preempt", "slow_ms", "spike_x", "after_step",
                     "window")


@dataclass
class TrainChaosConfig:
    """Seeded fault plan for one training run.

    Budgets: ``nan`` steps get NaN gradients (through the compiled guard),
    ``slow`` steps sleep ``slow_ms`` before dispatch, ``spike`` steps have
    their *observed* loss scaled by ``spike_x`` (tripping the EWMA anomaly
    detector and its rollback), ``crash`` steps raise
    :class:`TrainStepCrashError` on the host, ``ckpt_fail`` checkpoint
    writes fail mid-save, and ``torn`` checkpoints are truncated *after* a
    successful save (corruption the atomic rename can't prevent — media
    rot). ``preempt=N`` requests a clean preemption at step ``N``.

    Seeded budget draws land on distinct steps in
    ``[after_step, after_step + window)``; the ``*_steps`` fields are
    explicit overrides for deterministic tests. ``ckpt_fail_steps`` /
    ``torn_steps`` are *thresholds*: each arms the first checkpoint written
    at-or-after that step. Everything is resolved at
    :class:`TrainChaosMonkey` construction as a pure function of the config,
    so a rolled-back or resumed window re-arms the same absolute steps —
    exactly what the bitwise resume-identity gate needs. Spikes additionally
    fire only in the original data window (``salt == 0``), so a rollback's
    re-seeded replay cannot re-trip the detector forever.
    """

    seed: int = 0
    nan: int = 0
    slow: int = 0
    spike: int = 0
    crash: int = 0
    ckpt_fail: int = 0
    torn: int = 0
    preempt: int = -1
    slow_ms: float = 25.0
    spike_x: float = 50.0
    after_step: int = 1
    window: int = 8
    nan_steps: Optional[Sequence[int]] = None
    slow_steps: Optional[Sequence[int]] = None
    spike_steps: Optional[Sequence[int]] = None
    crash_steps: Optional[Sequence[int]] = None
    ckpt_fail_steps: Optional[Sequence[int]] = None
    torn_steps: Optional[Sequence[int]] = None

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "TrainChaosConfig":
        """Parse ``"nan=2,slow=1,spike=1,preempt=11,seed=7"``."""
        kw: Dict[str, Any] = {"seed": seed}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in TRAIN_CHAOS_KNOBS:
                raise ValueError(f"{CHAOS_ENV}: unknown train chaos knob "
                                 f"{k!r}")
            kw[k] = float(v) if k in ("slow_ms", "spike_x") else int(v)
        return cls(**kw)

    @classmethod
    def from_env(cls, seed: Optional[int] = None
                 ) -> Optional["TrainChaosConfig"]:
        spec = os.environ.get(CHAOS_ENV, "")
        if not spec:
            return None
        return cls.parse(spec, seed=0 if seed is None else seed)

    @property
    def wants_nan(self) -> bool:
        return self.nan > 0 or bool(self.nan_steps)


class TrainChaosMonkey:
    """Executes a :class:`TrainChaosConfig` against one *supervised* run.

    The driver calls :meth:`nan_armed` when building each dispatch's ``arm``
    operand, :meth:`on_step` before the dispatch (sleep / raise),
    :meth:`loss_scale` when feeding the anomaly detector, :meth:`preempt`
    at each step boundary, and wires :meth:`ckpt_fault` into the
    ``CheckpointManager`` as its ``fault_hook``; :meth:`maybe_tear`
    truncates a just-written checkpoint.

    Per-step data faults (nan/slow/spike) are pure functions of the
    absolute step, so a replayed window injects identically — that keeps
    interrupted+resumed runs bitwise-equal to uninterrupted ones.
    Operational faults (crash/ckpt_fail/torn/preempt) are fire-once per
    monkey; the ``TrainSupervisor`` shares ONE monkey across its restart
    attempts, so "the machine was preempted at step 11" happens once per
    supervised run, like a real incident.
    """

    def __init__(self, cfg: TrainChaosConfig, total_steps: int):
        self.cfg = cfg
        self.events: List[Dict[str, Any]] = []
        rng = np.random.default_rng(cfg.seed)
        hi = max(total_steps, cfg.after_step + 1)

        def draw(budget: int, explicit) -> List[int]:
            if explicit is not None:
                return sorted(int(s) for s in explicit)
            if budget <= 0:
                return []
            lo = min(cfg.after_step, hi - 1)
            span = max(min(cfg.after_step + cfg.window, hi) - lo, 1)
            picks = rng.choice(span, size=min(budget, span), replace=False)
            return sorted(int(lo + s) for s in picks)

        self.nan_steps = set(draw(cfg.nan, cfg.nan_steps))
        self.slow_steps = set(draw(cfg.slow, cfg.slow_steps))
        self.spike_steps = set(draw(cfg.spike, cfg.spike_steps))
        self.crash_steps = set(draw(cfg.crash, cfg.crash_steps))
        self._ckpt_fail = draw(cfg.ckpt_fail, cfg.ckpt_fail_steps)
        self._torn = draw(cfg.torn, cfg.torn_steps)
        self._fired_slow: set = set()
        self._fired_crash: set = set()
        self._preempt_armed = cfg.preempt >= 0

    # -- per-step data faults (pure in the absolute step) -------------------
    def nan_armed(self, step: int) -> bool:
        if step in self.nan_steps:
            self.events.append({"kind": "nan", "step": step})
            return True
        return False

    def loss_scale(self, step: int, salt: int = 0) -> float:
        """Observed-loss multiplier feeding the spike detector. Fires only
        in the original data window (``salt == 0``): a rollback re-seeds the
        window precisely so the replay does not re-trip."""
        if salt == 0 and step in self.spike_steps:
            self.events.append({"kind": "spike", "step": step,
                                "x": self.cfg.spike_x})
            return self.cfg.spike_x
        return 1.0

    # -- operational faults (fire-once per monkey) --------------------------
    def on_step(self, step: int) -> None:
        """Called before dispatching ``step``; may sleep or raise. Raises
        happen before the dispatch so donated buffers are never consumed by
        a step the supervisor will replay."""
        if step in self.slow_steps and step not in self._fired_slow:
            self._fired_slow.add(step)
            self.events.append({"kind": "slow", "step": step,
                                "ms": self.cfg.slow_ms})
            time.sleep(self.cfg.slow_ms / 1e3)
        if step in self.crash_steps and step not in self._fired_crash:
            self._fired_crash.add(step)
            self.events.append({"kind": "crash", "step": step})
            raise TrainStepCrashError(
                f"injected hard step failure at step {step} "
                f"(seed={self.cfg.seed})")

    def preempt(self, step: int) -> bool:
        if self._preempt_armed and step >= self.cfg.preempt:
            self._preempt_armed = False
            self.events.append({"kind": "preempt", "step": step})
            return True
        return False

    def ckpt_fault(self, step: int, key: str) -> None:
        """``CheckpointManager`` fault hook: the first checkpoint written
        at-or-after each armed threshold fails on its first leaf."""
        for i, thr in enumerate(self._ckpt_fail):
            if step >= thr:
                del self._ckpt_fail[i]
                self.events.append({"kind": "ckpt_fail", "step": step,
                                    "leaf": key})
                raise OSError(f"injected checkpoint write failure at step "
                              f"{step} (seed={self.cfg.seed})")

    def maybe_tear(self, manager, step: int) -> None:
        """After a completed save of ``step``: truncate one leaf file,
        simulating corruption the atomic rename cannot prevent. ``restore``
        must detect the bad CRC and fall back to the previous checkpoint."""
        for i, thr in enumerate(self._torn):
            if step >= thr:
                del self._torn[i]
                manager.wait()
                path = os.path.join(manager.dir, f"step_{step:08d}")
                leaves = sorted(f for f in os.listdir(path)
                                if f.endswith(".npy"))
                if not leaves:
                    return
                target = os.path.join(path, leaves[0])
                size = os.path.getsize(target)
                with open(target, "r+b") as f:
                    f.truncate(max(size // 2, 1))
                self.events.append({"kind": "torn", "step": step,
                                    "leaf": leaves[0]})
                return
