"""ServeFleet: N engine shards behind one submit/step/run facade
(counterpart: ``repro/launch/fleet.py``).

Each shard is a full :class:`~repro_torch.launch.engine.ServeEngine` (its
own cache, page pool and decode graph); the fleet routes, health-checks
and fails over. The shard, not the request, is the failure domain.

Two backends, one protocol:

* ``inproc`` — shards are objects in this process (they may share one
  model's weights). Deterministic and fast.
* ``mp``     — each shard is a worker process started with the ``spawn``
  context (never a fork after CUDA is initialised), which builds its own
  engine on the device the parent names, from the same seed or weights; a
  worker that cannot open the card raises, it never serves on the CPU. The
  fleet sends every routable shard its step first, then collects the
  replies, so the workers' chunks overlap. A kill is a real
  ``Process.terminate()``.

Every shard step is a heartbeat: a reply with its ``beat`` flag feeds
:meth:`~repro_torch.distributed.fault_tolerance.HealthMonitor.beat`, a
timeout or a dropped flag ``miss`` (LIVE -> SUSPECT -> DEAD), and an
unambiguous death (process exit, closed pipe, a raised
:class:`~repro_torch.distributed.chaos.ShardKilledError`) ``mark_dead``.
On a death the fleet fails over: the shard's last periodic ``snapshot()``
(also written as an atomic ``RestartManifest`` per shard with
``manifest_dir``) is replayed into survivors — completions not yet drained
deliver directly, in-flight requests regenerate from their prompts (the
reference resumes paged ones from their produced tokens; see
``ServeEngine.load_snapshot`` for why the port does not), requests routed
after the last checkpoint replay from the retained original. Only with no survivor, or a request past its replay
budget, does a request end with ``ErrorReason.SHARD_LOST``: exactly one
Completion per submitted request, faults or not.

Control plane only: the device work lives behind the engine.
"""
from __future__ import annotations

import multiprocessing
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.distributed.chaos import (ShardChaosConfig,
                                           ShardChaosMonkey,
                                           ShardKilledError)
from repro_torch.distributed.dispatcher import Dispatcher
from repro_torch.distributed.fault_tolerance import (HealthMonitor,
                                                     RestartManifest,
                                                     ShardState)
from repro_torch.launch.engine import Completion, ErrorReason, Request

# engine stats counters a warm benchmark measurement resets to zero
_RESET_STATS = ("tokens_out", "decode_dispatches", "prefills",
                "error_completions", "deadline_miss")


def _reset_engine_stats(eng) -> None:
    for k in _RESET_STATS:
        eng.stats[k] = 0
    eng.stats["wall_seconds"] = 0.0
    eng.stats["chunk_seconds"] = []


def _step_report(eng, drained: int, beat: bool,
                 more: bool) -> Dict[str, Any]:
    """The per-step shard reply: heartbeat flag, progress flag, completions
    emitted since the last report, and the KV-reservation routing signal."""
    new = eng.completions[drained:]
    return {"beat": beat, "more": more, "completions": list(new),
            "reserved": eng.stats.get("kv_pages_reserved", 0)}


class InProcessShard:
    """A shard living in the fleet's own process (tests, chaos drills)."""

    backend = "inproc"

    def __init__(self, sid: int, engine):
        self.sid = sid
        self.eng = engine
        self.pending = False          # inproc replies are always immediate
        self._drained = 0
        self._killed = False
        self._stall_until = -1
        self._drop_until = -1
        self._report: Optional[Dict[str, Any]] = None

    def submit(self, req: Request) -> None:
        self.eng.submit(req)

    def load(self, snap: Dict[str, Any]) -> None:
        self.eng.load_snapshot(snap)

    def snapshot(self) -> Dict[str, Any]:
        return self.eng.snapshot()

    def final_stats(self) -> Dict[str, Any]:
        return dict(self.eng.stats)

    def reset_stats(self) -> None:
        _reset_engine_stats(self.eng)

    def kill(self) -> None:
        self._killed = True

    def step_send(self, directive: Optional[Dict[str, Any]],
                  step: int) -> None:
        if self._killed:
            raise ShardKilledError(f"shard {self.sid}: killed by chaos")
        if directive is not None:
            if directive["kind"] == "stall":
                self._stall_until = step + directive["steps"]
            elif directive["kind"] == "drop":
                self._drop_until = step + directive["beats"]
        if step < self._stall_until:     # hung: no work, no heartbeat
            self._report = {"beat": False, "more": True, "completions": [],
                            "reserved": 0}
            return
        more = self.eng.step()
        self._report = _step_report(self.eng, self._drained,
                                    step >= self._drop_until, more)
        self._drained = len(self.eng.completions)

    def step_recv(self, timeout_s: float) -> Optional[Dict[str, Any]]:
        r, self._report = self._report, None
        return r

    def close(self) -> None:
        pass


def _worker_main(conn, spec: Dict[str, Any]) -> None:
    """Entry point of one ``mp`` shard worker (module-level so the spawn
    context can import it). Builds its engine from ``spec["engine"]``
    (:func:`~repro_torch.launch.serve.make_queue_engine`'s arguments, the
    device among them) after setting ``spec["env"]``: every shard builds
    the same weights and programs, so any shard decodes any request as any
    other. A failed build (no card for a ``cuda`` engine) is reported to
    the parent, which raises."""
    t0 = time.perf_counter()
    for k, v in spec.get("env", {}).items():
        os.environ[k] = v
    try:
        from repro_torch.launch.serve import make_queue_engine
        eng = make_queue_engine(**spec["engine"])
    except Exception as e:  # noqa: BLE001 — surfaced via the pipe
        conn.send(("error", f"engine build failed: {e!r}"))
        return
    conn.send(("ready", {"device": str(eng.device), "pid": os.getpid(),
                         "build_seconds": time.perf_counter() - t0}))
    drained = 0
    drop_until = -1
    while True:
        try:
            cmd, payload = conn.recv()
        except (EOFError, KeyboardInterrupt):
            return
        try:
            if cmd == "stop":
                conn.send(("ok", None))
                return
            if cmd == "submit":
                eng.submit(payload)
                conn.send(("ok", None))
            elif cmd == "load":
                eng.load_snapshot(payload)
                conn.send(("ok", None))
            elif cmd == "snapshot":
                conn.send(("snap", eng.snapshot()))
            elif cmd == "stats":
                conn.send(("stats", dict(eng.stats)))
            elif cmd == "reset":
                _reset_engine_stats(eng)
                conn.send(("ok", None))
            elif cmd == "step":
                d, step = payload["directive"], payload["step"]
                if d is not None and d["kind"] == "drop":
                    drop_until = step + d["beats"]
                more = eng.step()
                conn.send(("report", _step_report(eng, drained,
                                                  step >= drop_until, more)))
                drained = len(eng.completions)
            else:
                conn.send(("error", f"unknown command {cmd!r}"))
        except Exception as e:  # noqa: BLE001 — a poisoned engine kills the
            try:                # shard; the fleet fails its work over
                conn.send(("error", repr(e)))
            except Exception:
                pass
            return


class WorkerShard:
    """A shard running as a worker process of the ``spawn`` context.

    Chaos ``kill`` is a real ``Process.terminate()``: the fleet notices it
    through process liveness and the closed pipe, not a cooperative flag.
    ``startup_seconds`` is the wall time from the start of the process to
    its engine's readiness; ``info`` is what the worker reported (its
    device, pid and the seconds its build took).
    """

    backend = "mp"

    def __init__(self, sid: int, spec: Dict[str, Any], ctx=None):
        ctx = ctx or multiprocessing.get_context("spawn")
        self.sid = sid
        self.pending = False
        self.info: Dict[str, Any] = {}
        self.startup_seconds = 0.0
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_worker_main, args=(child, spec),
                                daemon=True)
        self._t0 = time.perf_counter()
        self.proc.start()
        child.close()

    def wait_ready(self) -> None:
        try:
            tag, payload = self.conn.recv()
        except EOFError:
            raise RuntimeError(f"shard {self.sid}: worker exited before "
                               f"its engine was ready "
                               f"(exit code {self.proc.exitcode})")
        if tag != "ready":
            raise RuntimeError(f"shard {self.sid}: {payload}")
        self.info = payload
        self.startup_seconds = time.perf_counter() - self._t0

    def _rpc(self, msg) -> Any:
        try:
            self.conn.send(msg)
            tag, payload = self.conn.recv()
        except (EOFError, BrokenPipeError, ConnectionResetError, OSError) as e:
            raise ShardKilledError(
                f"shard {self.sid}: worker gone mid-{msg[0]} ({e!r})")
        if tag == "error":
            raise ShardKilledError(f"shard {self.sid}: {payload}")
        return payload

    def submit(self, req: Request) -> None:
        self._rpc(("submit", req))

    def load(self, snap: Dict[str, Any]) -> None:
        self._rpc(("load", snap))

    def snapshot(self) -> Dict[str, Any]:
        return self._rpc(("snapshot", None))

    def final_stats(self) -> Dict[str, Any]:
        return self._rpc(("stats", None))

    def reset_stats(self) -> None:
        self._rpc(("reset", None))

    def kill(self) -> None:
        self.proc.terminate()
        self.proc.join(timeout=30)

    def step_send(self, directive: Optional[Dict[str, Any]],
                  step: int) -> None:
        if not self.proc.is_alive():
            raise ShardKilledError(f"shard {self.sid}: worker process died")
        try:
            self.conn.send(("step", {"directive": directive, "step": step}))
        except (BrokenPipeError, OSError) as e:
            raise ShardKilledError(f"shard {self.sid}: pipe closed ({e!r})")

    def step_recv(self, timeout_s: float) -> Optional[Dict[str, Any]]:
        try:
            if not self.conn.poll(timeout_s):
                if not self.proc.is_alive():
                    raise ShardKilledError(
                        f"shard {self.sid}: worker died without replying")
                return None                        # missed heartbeat
            tag, payload = self.conn.recv()
        except ShardKilledError:
            raise
        except (EOFError, BrokenPipeError, ConnectionResetError, OSError) as e:
            raise ShardKilledError(f"shard {self.sid}: pipe closed ({e!r})")
        if tag == "error":
            raise ShardKilledError(f"shard {self.sid}: {payload}")
        return payload

    def close(self) -> None:
        if self.proc.is_alive():
            try:
                self.conn.send(("stop", None))
                self.proc.join(timeout=10)
            except (BrokenPipeError, OSError):
                pass
            if self.proc.is_alive():
                self.proc.terminate()
                self.proc.join(timeout=10)
        self.conn.close()


class ServeFleet:
    """N engine shards behind one ``submit/step/run`` facade.

    ``factory(sid) -> ServeEngine`` builds in-process shards;
    ``worker_spec`` (``{"engine": make_queue_engine kwargs, "env": {...}}``)
    builds ``mp`` workers instead, all started before any is waited for.
    All shards must share one seed / weights and config, so that any shard
    decodes any request as any other: failover replay rests on it.
    ``stats["worker_startup_seconds"]`` lists each worker's start-up.
    """

    def __init__(self, factory: Optional[Callable[[int], Any]] = None, *,
                 shards: int = 2, backend: str = "inproc",
                 worker_spec: Optional[Dict[str, Any]] = None,
                 checkpoint_every: int = 1,
                 manifest_dir: Optional[str] = None,
                 miss_suspect: int = 2, miss_dead: int = 4,
                 heartbeat_timeout_s: float = 120.0,
                 chaos: Optional[ShardChaosConfig] = None,
                 max_replays: int = 2, seed: int = 0):
        assert backend in ("inproc", "mp"), backend
        assert shards >= 1
        self.n_shards = shards
        self.backend = backend
        self.seed = seed
        self.monitor = HealthMonitor(shards, miss_suspect=miss_suspect,
                                     miss_dead=miss_dead)
        self.dispatcher = Dispatcher(self.monitor)
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.checkpoint_every = max(int(checkpoint_every), 1)
        self.manifest_dir = manifest_dir
        self.max_replays = max_replays
        self.chaos = (ShardChaosMonkey(chaos, shards)
                      if chaos is not None and chaos.armed else None)
        self.completions: List[Completion] = []
        self.stats: Dict[str, Any] = {
            "fleet_steps": 0, "failovers": 0, "shard_lost": 0, "replays": 0,
            "checkpoints": 0, "heartbeat_misses": 0, "tokens_out": 0,
            "wall_seconds": 0.0, "error_completions": 0, "deadline_miss": 0,
        }
        self._requests: Dict[int, Request] = {}    # originals, for replay
        self._completed: set = set()               # exactly-one guard
        self._replays: Dict[int, int] = {}
        self._snaps: Dict[int, Dict[str, Any]] = {}
        self._failed_over: set = set()
        self._step_no = 0
        if backend == "inproc":
            assert factory is not None, "inproc backend needs a factory"
            self.shards: List[Any] = [InProcessShard(s, factory(s))
                                      for s in range(shards)]
        else:
            assert worker_spec is not None, "mp backend needs worker_spec"
            ctx = multiprocessing.get_context("spawn")
            # start every worker before waiting: engines build concurrently
            self.shards = [WorkerShard(s, worker_spec, ctx=ctx)
                           for s in range(shards)]
            try:
                for sh in self.shards:
                    sh.wait_ready()
            except BaseException:
                self.close()
                raise
            self.stats["worker_startup_seconds"] = [
                sh.startup_seconds for sh in self.shards]

    # -- facade --------------------------------------------------------------
    def submit(self, request: Request) -> bool:
        """Route to the least-loaded healthy shard; emits an immediate typed
        ``shard_lost`` completion when the whole fleet is dead."""
        self._requests[request.uid] = request
        while True:
            sid = self.dispatcher.route(exclude=self._pending_sids())
            if sid is None and self.dispatcher.route() is not None:
                self._await_pending()     # only stalled-reply shards remain
                continue
            if sid is None:
                self._lost(request.uid, (),
                           "no live shard to route the request to")
                return False
            try:
                self.shards[sid].submit(request)
            except ShardKilledError as e:
                self._note_death(sid, self._step_no, str(e))
                continue
            self.dispatcher.assign(request.uid, sid)
            return True

    def step(self) -> bool:
        """One fleet round: dispatch a step to every routable shard, collect
        replies (heartbeats), fail over any death, checkpoint. Returns True
        while submitted requests are still outstanding."""
        step = self._step_no
        self._step_no += 1
        self.stats["fleet_steps"] += 1
        deaths: List[tuple] = []
        stepped: List[int] = []
        # phase 1: send — mp shards overlap their chunk compute
        for sid, shard in enumerate(self.shards):
            if not self.monitor.alive(sid):
                continue
            if shard.pending:            # last round's reply still owed
                stepped.append(sid)
                continue
            d = self.chaos.directive(sid, step) if self.chaos else None
            if d is not None and d["kind"] == "kill":
                shard.kill()             # inproc: arm; mp: real terminate()
                d = None                 # detection runs through step_send
            try:
                shard.step_send(d, step)
            except ShardKilledError as e:
                deaths.append((sid, str(e)))
                continue
            stepped.append(sid)
        # phase 2: collect
        for sid in stepped:
            death = self._collect(sid, step)
            if death is not None:
                deaths.append((sid, death))
        # phase 3: failover
        for sid, why in deaths:
            self._note_death(sid, step, why)
        # phase 4: periodic checkpoint of live shards
        if step % self.checkpoint_every == 0:
            self._checkpoint(step)
        return self.dispatcher.outstanding > 0

    def run(self, requests: Optional[List[Request]] = None,
            max_steps: Optional[int] = None) -> List[Completion]:
        for r in requests or ():
            self.submit(r)
        t0 = time.perf_counter()
        while self.step():
            if max_steps is not None and self._step_no >= max_steps:
                break
        self.stats["wall_seconds"] += time.perf_counter() - t0
        self.stats["tokens_per_second"] = self.stats["tokens_out"] / max(
            self.stats["wall_seconds"], 1e-9)
        self.stats.update(suspects=self.monitor.suspects,
                          recoveries=self.monitor.recoveries,
                          deaths=self.monitor.deaths)
        return self.completions

    def close(self) -> None:
        for shard in self.shards:
            shard.close()

    # -- plumbing ------------------------------------------------------------
    def _pending_sids(self) -> set:
        return {s for s, sh in enumerate(self.shards) if sh.pending}

    def _collect(self, sid: int, step: int) -> Optional[str]:
        """Receive one shard's step reply; returns a death reason or None."""
        shard = self.shards[sid]
        try:
            r = shard.step_recv(self.heartbeat_timeout_s)
        except ShardKilledError as e:
            shard.pending = False
            return str(e)
        if r is None:                       # timeout: reply still owed
            shard.pending = True
            self.stats["heartbeat_misses"] += 1
            if self.monitor.miss(sid, step) is ShardState.DEAD:
                return "missed heartbeats"
            return None
        shard.pending = False
        self.dispatcher.note_reserved(sid, r.get("reserved", 0))
        self._drain(r.get("completions") or ())
        if r.get("beat", True):
            self.monitor.beat(sid, step)
        else:
            self.stats["heartbeat_misses"] += 1
            if self.monitor.miss(sid, step) is ShardState.DEAD:
                return "missed heartbeats"
        return None

    def _await_pending(self) -> None:
        """Block on shards that owe a reply (used when every routable shard
        is mid-step and a submit/failover needs a target)."""
        for sid in sorted(self._pending_sids()):
            if not self.monitor.alive(sid):
                continue
            death = self._collect(sid, self._step_no)
            if death is not None:
                self._note_death(sid, self._step_no, death)

    def _drain(self, comps) -> None:
        for c in comps:
            if c.uid in self._completed:    # zombie/dup replay guard
                continue
            self._completed.add(c.uid)
            self.dispatcher.complete(c.uid)
            self.completions.append(c)
            self.stats["tokens_out"] += int(
                np.asarray(c.tokens).reshape(-1).size)
            if c.finish_reason == "error":
                self.stats["error_completions"] += 1
                if c.reason == ErrorReason.DEADLINE.value:
                    self.stats["deadline_miss"] += 1

    def _lost(self, uid: int, partial, msg: str) -> None:
        """The one place a fleet-level failure becomes a Completion."""
        self.completions.append(Completion(
            uid=uid, tokens=np.asarray(partial, np.int32).reshape(-1),
            finish_reason="error", error=msg,
            reason=ErrorReason.SHARD_LOST.value))
        self._completed.add(uid)
        self.dispatcher.complete(uid)
        self.stats["shard_lost"] += 1
        self.stats["error_completions"] += 1

    def _checkpoint(self, step: int) -> None:
        for sid, shard in enumerate(self.shards):
            if not self.monitor.alive(sid) or shard.pending:
                continue
            try:
                snap = shard.snapshot()
            except ShardKilledError:
                continue                 # the next step notices the death
            self._snaps[sid] = snap
            self.stats["checkpoints"] += 1
            if self.manifest_dir:
                RestartManifest(
                    step=step, checkpoint_dir="", mesh_shape=[1],
                    mesh_axes=["data"], data_seed=self.seed,
                    shape=f"fleet-shard{sid}", serve=snap,
                ).save(os.path.join(self.manifest_dir, f"shard{sid}.json"))

    def _manifest_snap(self, sid: int) -> Optional[Dict[str, Any]]:
        if not self.manifest_dir:
            return None
        path = os.path.join(self.manifest_dir, f"shard{sid}.json")
        if not os.path.exists(path):
            return None
        return RestartManifest.load(path).serve

    def _note_death(self, sid: int, step: int, why: str) -> None:
        self.monitor.mark_dead(sid, step, why)
        if sid in self._failed_over:
            return
        self._failed_over.add(sid)
        self._failover(sid, step, why)

    def _failover(self, sid: int, step: int, why: str) -> None:
        """Re-drive a dead shard's outstanding requests on survivors from
        its last checkpoint. Requests finished-but-undrained in the snapshot
        deliver directly; snapshotted in-flight/queued ones regenerate on a
        survivor; ones routed after the snapshot replay from the retained
        original Request. ``shard_lost``
        fires only when no survivor exists or the replay budget is spent."""
        self.stats["failovers"] += 1
        outstanding = self.dispatcher.fail_shard(sid)
        snap = self._manifest_snap(sid) or self._snaps.get(sid) or {}
        comp_by_uid = {c["uid"]: c for c in snap.get("completions") or ()}
        entry_by_uid = {d["uid"]: d
                        for d in list(snap.get("queued") or ())
                        + list(snap.get("active") or ())}
        for uid in outstanding:
            if uid in self._completed:
                continue
            if uid in comp_by_uid:       # done before death, reply lost
                c = comp_by_uid[uid]
                self._drain([Completion(
                    uid=uid, tokens=np.asarray(c["tokens"], np.int32),
                    finish_reason=c["finish_reason"], error=c.get("error"),
                    reason=c.get("reason"))])
                continue
            entry = entry_by_uid.get(uid)
            partial = [int(x) for x in (entry or {}).get("produced") or ()]
            self._replays[uid] = self._replays.get(uid, 0) + 1
            if self._replays[uid] > self.max_replays:
                self._lost(uid, partial,
                           f"shard {sid} died ({why}); replay budget "
                           f"({self.max_replays}) exhausted")
                continue
            placed = False
            while not placed:
                tgt = self.dispatcher.route(exclude=self._pending_sids())
                if tgt is None and self.dispatcher.route() is not None:
                    self._await_pending()
                    continue
                if tgt is None:
                    self._lost(uid, partial,
                               f"shard {sid} died ({why}); no survivor "
                               "to replay on")
                    break
                try:
                    if entry is not None:
                        self.shards[tgt].load({"queued": [entry]})
                    else:                # routed after the last checkpoint
                        self.shards[tgt].submit(self._requests[uid])
                except ShardKilledError as e:
                    self._note_death(tgt, step, str(e))
                    continue
                self.dispatcher.assign(uid, tgt)
                self.stats["replays"] += 1
                placed = True

    # -- instrumentation -----------------------------------------------------
    def reset_stats(self) -> None:
        """Zero the throughput counters after a warmup drain so a benchmark
        measures warm decode only (compile time excluded)."""
        for k in ("tokens_out", "error_completions", "deadline_miss"):
            self.stats[k] = 0
        self.stats["wall_seconds"] = 0.0
        for sid, shard in enumerate(self.shards):
            if self.monitor.alive(sid):
                try:
                    shard.reset_stats()
                except ShardKilledError:
                    pass

    def per_shard_stats(self) -> List[Dict[str, Any]]:
        """Per-shard serving stats (the per-channel stats registry of the
        PIMulator idiom): tok/s over decode-chunk wall time plus tail
        latency, one row per shard, dead or alive."""
        rows = []
        for sid, shard in enumerate(self.shards):
            s: Dict[str, Any] = {}
            if self.monitor.alive(sid) and not shard.pending:
                try:
                    s = shard.final_stats()
                except ShardKilledError:
                    s = {}
            cs = [float(x) for x in s.get("chunk_seconds") or ()]
            rows.append({
                "shard": sid, "state": str(self.monitor.state(sid)),
                "tokens_out": int(s.get("tokens_out", 0)),
                "dispatches": int(s.get("decode_dispatches", 0)),
                "tok_s": (s.get("tokens_out", 0) / max(sum(cs), 1e-9)
                          if cs else 0.0),
                "p50_ms": float(np.percentile(cs, 50)) * 1e3 if cs else 0.0,
                "p95_ms": float(np.percentile(cs, 95)) * 1e3 if cs else 0.0,
                "error_completions": int(s.get("error_completions", 0)),
                "deadline_miss": int(s.get("deadline_miss", 0)),
            })
        return rows

    @property
    def chaos_events(self) -> List[Dict[str, Any]]:
        return [] if self.chaos is None else list(self.chaos.events)
