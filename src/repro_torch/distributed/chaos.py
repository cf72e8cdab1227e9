"""Deterministic fault injection (counterpart:
``repro/distributed/chaos.py``) for the three failure domains:

* one serving engine — :class:`ChaosMonkey` injects non-finite logits
  through the fused chunk's ``logits_hook`` (:func:`nan_logits_hook`),
  slow chunks (a host sleep before a dispatch), transient step failures
  (:class:`TransientStepError`, raised before the dispatch) and page-pool
  pressure (pages stolen from the allocator's free list);
* a fleet's shards — :class:`ShardChaosMonkey` kills, stalls or drops the
  heartbeats of whole shards;
* the train loop — :class:`TrainChaosMonkey` (``TrainStepCrashError``,
  ``nan_grad_hook`` and the checkpoint faults).

Every decision is drawn from ``numpy.random.default_rng(seed)`` exactly as
the reference draws it, so a plan equals the reference's event for event.
``ChaosConfig.from_env()`` / ``TrainChaosConfig.from_env()`` parse the
``REPRO_CHAOS`` knob (e.g. ``REPRO_CHAOS="seed=7,nan=1,slow=2,fail=1,
pages=4"``).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_map

CHAOS_ENV = "REPRO_CHAOS"


class ChaosError(RuntimeError):
    """Base class for injected faults."""


class TransientStepError(ChaosError):
    """Injected transient chunk-dispatch failure (succeeds on retry)."""


class ShardKilledError(ChaosError):
    """Injected hard shard loss: an in-process fleet shard raises this from
    its next step (a spawned worker is ``terminate()``-d instead); both
    reach the fleet's ``HealthMonitor`` as an unambiguous death."""


def nan_logits_hook(logits: torch.Tensor, row_pos: torch.Tensor,
                    arm: torch.Tensor) -> torch.Tensor:
    """NaN injection for ``make_generate_step(logits_hook=...)``.

    ``logits`` (B, S, V); ``row_pos`` (B, S) is the absolute cache position
    of each logits row; ``arm`` (B,) int32 holds the poison position per
    slot (-1 disarmed). Rows whose position equals the armed one go NaN;
    every other row passes through bitwise unchanged (a fill under a false
    mask is identity), so disarmed slots decode as an unhooked chunk does.
    Tensor ops only: it runs inside a captured graph."""
    hit = (arm[:, None] >= 0) & (row_pos == arm[:, None])
    return logits.masked_fill(hit[..., None], float("nan"))


CHAOS_KNOBS = ("seed", "nan", "slow", "fail", "pages", "slow_ms",
               "steal_after_chunk")


@dataclass
class ChaosConfig:
    """Seeded fault plan for one engine drain.

    ``nan``/``slow``/``fail``/``pages`` are budgets: how many requests get
    poisoned logits, how many chunks are slowed / failed, how many physical
    pages are stolen. ``nan_targets`` (uid -> generated-token index) and
    ``slow_chunks`` / ``fail_chunks`` (chunk indices) are explicit
    overrides for deterministic tests; each replaces its seeded draw.
    """

    seed: int = 0
    nan: int = 0
    slow: int = 0
    fail: int = 0
    pages: int = 0
    slow_ms: float = 25.0
    steal_after_chunk: int = 1
    nan_targets: Optional[Dict[int, int]] = None
    slow_chunks: Optional[Sequence[int]] = None
    fail_chunks: Optional[Sequence[int]] = None

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "ChaosConfig":
        """Parse ``"nan=1,slow=2,fail=1,pages=4,slow_ms=25,seed=7"``."""
        kw: Dict[str, Any] = {"seed": seed}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in CHAOS_KNOBS:
                raise ValueError(f"{CHAOS_ENV}: unknown chaos knob {k!r}")
            kw[k] = float(v) if k == "slow_ms" else int(v)
        return cls(**kw)

    @classmethod
    def from_env(cls, seed: Optional[int] = None) -> Optional["ChaosConfig"]:
        spec = os.environ.get(CHAOS_ENV, "")
        if not spec:
            return None
        return cls.parse(spec, seed=0 if seed is None else seed)

    @property
    def wants_nan(self) -> bool:
        return self.nan > 0 or bool(self.nan_targets)


class ChaosMonkey:
    """Executes a :class:`ChaosConfig` against one engine drain.

    The engine calls :meth:`plan_request` at admission (arming NaN
    injection), :meth:`on_chunk` just before each chunk's dispatch (sleep /
    raise) and :meth:`page_pressure` between chunks (steal pages). Every
    decision is cached per injection site and fires at most once, so a
    chunk retried after an injected failure replays clean.
    """

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.events: List[Dict[str, Any]] = []
        self._nan_left = cfg.nan
        self._slow_left = cfg.slow
        self._fail_left = cfg.fail
        self._chunk_plan: Dict[int, Tuple[bool, bool]] = {}
        self._fired_slow: set = set()
        self._fired_fail: set = set()
        self.held_pages: List[int] = []

    def plan_request(self, uid: int, prompt_len: int,
                     max_new: int) -> Optional[int]:
        """Absolute cache position to poison for this request (None =
        clean): arming position ``prompt_len + g`` ends the request with
        ``g + 1`` tokens."""
        if self.cfg.nan_targets is not None:
            g = self.cfg.nan_targets.get(uid)
            if g is None:
                return None
            pos = prompt_len + int(g)
        else:
            if self._nan_left <= 0:
                return None
            if self.rng.random() >= 0.5:
                return None
            self._nan_left -= 1
            pos = prompt_len + int(self.rng.integers(0, max(max_new - 1, 1)))
        self.events.append({"kind": "nan", "uid": uid, "pos": pos})
        return pos

    def _plan_chunk(self, idx: int) -> Tuple[bool, bool]:
        if idx not in self._chunk_plan:
            if self.cfg.slow_chunks is not None:
                slow = idx in self.cfg.slow_chunks
            else:
                slow = self._slow_left > 0 and self.rng.random() < 0.5
            if self.cfg.fail_chunks is not None:
                fail = idx in self.cfg.fail_chunks
            else:
                fail = self._fail_left > 0 and self.rng.random() < 0.4
            if slow and self.cfg.slow_chunks is None:
                self._slow_left -= 1
            if fail and self.cfg.fail_chunks is None:
                self._fail_left -= 1
            self._chunk_plan[idx] = (slow, fail)
        return self._chunk_plan[idx]

    def on_chunk(self, idx: int) -> None:
        """Called before dispatching chunk ``idx``; may sleep or raise
        (before the dispatch, so a retry replays nothing)."""
        slow, fail = self._plan_chunk(idx)
        if slow and idx not in self._fired_slow:
            self._fired_slow.add(idx)
            self.events.append({"kind": "slow", "chunk": idx,
                                "ms": self.cfg.slow_ms})
            time.sleep(self.cfg.slow_ms / 1e3)
        if fail and idx not in self._fired_fail:
            self._fired_fail.add(idx)
            self.events.append({"kind": "fail", "chunk": idx})
            raise TransientStepError(
                f"injected transient failure at chunk {idx} "
                f"(seed={self.cfg.seed})")

    def page_pressure(self, alloc, idx: int) -> None:
        """Steal ``cfg.pages`` physical pages from ``alloc``'s free list
        once, after ``steal_after_chunk`` chunks have dispatched."""
        if self.cfg.pages <= 0 or self.held_pages or \
                idx < self.cfg.steal_after_chunk:
            return
        steal = min(self.cfg.pages, len(alloc.free))
        self.held_pages = [alloc.free.pop() for _ in range(steal)]
        self.events.append({"kind": "pages", "chunk": idx,
                            "stolen": len(self.held_pages)})

    def release_pages(self, alloc) -> None:
        alloc.free.extend(self.held_pages)
        self.held_pages = []


# ---------------------------------------------------------------------------
# Shard-level faults (the fleet failure domain)
# ---------------------------------------------------------------------------
@dataclass
class ShardChaosConfig:
    """Seeded shard-level fault plan for a ``ServeFleet`` drain.

    * **kill** — hard shard loss: an in-process shard raises
      :class:`ShardKilledError`, a spawned worker is ``terminate()``-d;
    * **stall** — the shard stops stepping and heartbeating for
      ``stall_steps`` fleet steps (default: forever), so the health monitor
      walks miss -> suspect -> dead before failover;
    * **drop** — heartbeats are dropped for ``drop_beats`` steps while the
      shard keeps working (suspect -> recover, no failover).

    ``kill_targets`` / ``stall_targets`` / ``drop_targets`` map ``shard ->
    fleet step`` (``drop``: ``(step, beats)``); the ``kill`` / ``stall`` /
    ``drop`` budgets instead draw distinct (shard, step) pairs from the
    seed. Every fault fires at most once. :meth:`parse` takes the
    ``--fleet-chaos`` spelling: ``kill=SHARD@STEP``, ``drop=SHARD@STEPxBEATS``
    and budgets ``kills=N,stalls=N,drops=N``, e.g. ``"kill=1@2"``.
    """

    seed: int = 0
    kill: int = 0
    stall: int = 0
    drop: int = 0
    after_step: int = 1           # earliest step for seeded draws
    window: int = 4               # seeded steps land in [after, after+window)
    stall_steps: int = 1 << 30    # a stall is a hang unless bounded
    drop_beats: int = 2
    kill_targets: Optional[Dict[int, int]] = None
    stall_targets: Optional[Dict[int, int]] = None
    drop_targets: Optional[Dict[int, Tuple[int, int]]] = None  # sid->(step,n)

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "ShardChaosConfig":
        """Parse ``"kill=1@2,stall=0@4,drop=1@3x2,kills=1,seed=7"``."""
        kw: Dict[str, Any] = {"seed": seed}
        budgets = {"kills": "kill", "stalls": "stall", "drops": "drop"}
        ints = ("seed", "after_step", "window", "stall_steps", "drop_beats")
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            k = k.strip()
            if k in budgets:
                kw[budgets[k]] = int(v)
            elif k in ints:
                kw[k] = int(v)
            elif k in ("kill", "stall"):
                sid, _, step = v.partition("@")
                tgt = kw.setdefault(k + "_targets", {})
                tgt[int(sid)] = int(step or 1)
            elif k == "drop":
                sid, _, rest = v.partition("@")
                step, _, beats = rest.partition("x")
                tgt = kw.setdefault("drop_targets", {})
                tgt[int(sid)] = (int(step or 1), int(beats or 2))
            else:
                raise ValueError(f"--fleet-chaos: unknown shard fault {k!r}")
        return cls(**kw)

    @property
    def armed(self) -> bool:
        return bool(self.kill or self.stall or self.drop or self.kill_targets
                    or self.stall_targets or self.drop_targets)


class ShardChaosMonkey:
    """Executes a :class:`ShardChaosConfig` against one fleet drain: the
    fleet asks :meth:`directive` for every (shard, fleet step) before that
    shard's step. Seeded draws are fixed at construction (distinct shards,
    steps in the config's window), so the plan is a pure function of
    (seed, n_shards), fire-once."""

    def __init__(self, cfg: ShardChaosConfig, n_shards: int):
        self.cfg = cfg
        self.events: List[Dict[str, Any]] = []
        rng = np.random.default_rng(cfg.seed)
        self._plan: Dict[Tuple[int, int], Dict[str, Any]] = {}

        def seed_draws(kind: str, budget: int, extra=None) -> None:
            picks = rng.choice(n_shards, size=min(budget, n_shards),
                               replace=False) if budget else []
            for sid in picks:
                step = int(cfg.after_step + rng.integers(0, max(cfg.window,
                                                                1)))
                self._add(kind, int(sid), step, extra)

        for sid, step in (cfg.kill_targets or {}).items():
            self._add("kill", sid, step, None)
        for sid, step in (cfg.stall_targets or {}).items():
            self._add("stall", sid, step, {"steps": cfg.stall_steps})
        for sid, (step, beats) in (cfg.drop_targets or {}).items():
            self._add("drop", sid, step, {"beats": beats})
        seed_draws("kill", cfg.kill)
        seed_draws("stall", cfg.stall, {"steps": cfg.stall_steps})
        seed_draws("drop", cfg.drop, {"beats": cfg.drop_beats})

    def _add(self, kind: str, sid: int, step: int, extra) -> None:
        d = {"kind": kind, "shard": sid, "step": step}
        if extra:
            d.update(extra)
        self._plan.setdefault((sid, step), d)

    def directive(self, shard: int, step: int) -> Optional[Dict[str, Any]]:
        """Fault to inject into ``shard`` at fleet ``step`` (fire-once)."""
        d = self._plan.pop((shard, step), None)
        if d is not None:
            self.events.append(dict(d))
        return d


# ---------------------------------------------------------------------------
# Train-loop faults (the training failure domain)
# ---------------------------------------------------------------------------
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
