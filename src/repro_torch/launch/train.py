"""Training driver: guarded end-to-end loop with verified checkpoints,
bitwise-identical resume, chaos injection, and a bounded-restart supervisor
(counterpart: ``repro/launch/train.py``).

Trains every family of the reference (dense, MoE, VLM, the hybrid
Griffin, the xLSTM, the encoder-decoder) on one device, the card unless
``--device cpu`` is asked for; attention runs the hand-written prefill
kernel under autograd, Griffin's recurrences the RG-LRU kernel. The batch
carries the family's extras (``patch_embeds``, ``src_embeds``) as the
reference's stream makes them. The model holds no weights of its own (the
tree being trained is the only copy) and the step updates the tree and the
optimizer state in place, as the reference donates both to its jitted
step. The loop is the reference's:

* every step carries an on-device non-finite guard — a NaN/Inf loss or
  gradient skips the optimizer update (params pass through unchanged) and
  ``max_bad_steps`` consecutive skips abort with a typed
  :class:`TrainDivergedError`;
* a host-side loss-spike detector (EWMA + factor threshold) rolls back to
  the last good checkpoint and re-seeds the data window (``salt``);
* checkpoints (the reference's on-disk layout and leaf keys) capture the
  full loop state, so an interrupted+resumed run's losses and final params
  are *byte-identical* to an uninterrupted run — gated by
  :func:`verify_resume_identity`;
* :class:`TrainSupervisor` wraps :func:`train` in a bounded auto-restart
  loop resuming from the last *verified* checkpoint.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
      --device cpu --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 200
  PYTHONPATH=src python -m repro_torch.launch.train --steps 10 \
      --checkpoint-dir /tmp/ck --checkpoint-every 3 --preempt-after 5 \
      --max-restarts 2 --resume-verify    # byte-identity gate

The reference's ``--attn-impl`` (an attention backend knob: the port has
none) and ``--kv-quant`` (a serving knob; the train step has no KV cache)
have no counterpart.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointManager, CheckpointWriteError
from repro_torch.configs import (ALL_IDS, ModelConfig, RunConfig, ShapeConfig,
                                 get_config)
from repro_torch.data import make_batch_fn
from repro_torch.distributed import (PreemptionHandler, RestartManifest,
                                     StragglerMonitor, TrainChaosConfig,
                                     TrainChaosMonkey)
from repro_torch.distributed.chaos import nan_grad_hook
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params, reference_tree
from repro_torch.models.model import model_class, training_model
from repro_torch.optim import make_optimizer
from repro_torch.tree import leaves, tree_map


class TrainDivergedError(RuntimeError):
    """``max_bad_steps`` consecutive steps were skipped by the non-finite
    guard: the run has genuinely diverged, and an auto-restart would replay
    the same divergence — so the supervisor never retries this."""


def _tree_host(tree: Any) -> Any:
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def _to_device(host: Any, device) -> Any:
    """A restored numpy tree as tensors on ``device``."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), host)


def initial_params(cfg, seed: int, device, params=None) -> Dict[str, Any]:
    """The parameter tree to train from: the port's init drawn from
    ``seed`` on the CPU (so one seed gives the same weights on every
    device), or a copy of ``params``, a tree in the reference's layout
    (numpy arrays or tensors, e.g. the reference's own init carried
    across; copied, since the train step updates its tree in place). The
    family's list keys (``model_class(cfg).LISTS``: Griffin's ``tail``,
    the xLSTM's ``blocks``) are lists, as in the reference."""
    if params is None:
        flat = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
        return tree_map(lambda t: t.to(device),
                        reference_tree(flat, model_class(cfg).LISTS))
    return tree_map(lambda a: (a.detach().to(device, copy=True)
                               if isinstance(a, torch.Tensor)
                               else torch.from_numpy(np.array(a)).to(device)),
                    params)


def _salted_seed(seed: int, salt: int) -> int:
    """Data-pipeline seed for rollback window ``salt`` (0 = original run).

    ``batch(step)`` is a pure function of (seed, step), so bumping the salt
    after a rollback re-seeds the replayed step window deterministically —
    the same salt always yields the same token stream."""
    return seed if salt == 0 else (seed + 0x9E3779B1 * salt) & 0x7FFFFFFF


def train(arch: str, *, smoke: bool = True, steps: int = 100,
          batch: int = 8, seq: int = 128, run: Optional[RunConfig] = None,
          checkpoint_dir: str = "", resume: bool = False,
          log_every: int = 10, chaos: Any = None,
          max_bad_steps: int = 8, spike_factor: float = 3.0,
          spike_warmup: int = 10,
          preempt_after: Optional[int] = None, device="cuda",
          params: Any = None,
          cfg: Optional[ModelConfig] = None) -> Dict[str, Any]:
    """One training attempt on ``device`` (the card unless ``"cpu"`` is
    asked for). ``chaos`` is a :class:`TrainChaosConfig` (a fresh monkey is
    built) or a :class:`TrainChaosMonkey` (shared across a supervisor's
    attempts, so fire-once faults stay fired). ``preempt_after`` requests a
    clean preemption once the run first crosses that absolute step; a
    resumed run past it never re-fires. ``params`` is the tree to start
    from (``initial_params``, which copies it; default: the port's init
    from ``run.seed``), ``cfg`` a model config to train in place of
    ``arch``'s (a cut depth).
    The returned ``step_seconds`` holds each step's host wall time, from
    its start to its loss read, beside ``losses``.
    The reference's ``use_mesh`` and ``proteus`` have no counterpart: the
    port trains on one device without a mesh."""
    dev = resolve_device(device)
    cfg = cfg or get_config(arch, smoke=smoke)
    run = run or RunConfig(total_steps=steps, microbatches=1)
    shape = ShapeConfig("custom", seq_len=seq, global_batch=batch,
                        mode="train")
    print(f"train {arch} on {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
             else ""))
    model = training_model(cfg)
    optimizer = make_optimizer(cfg.optimizer, run)

    params = initial_params(cfg, run.seed, dev, params)
    opt_state = optimizer.init(params)

    monkey: Optional[TrainChaosMonkey] = None
    if isinstance(chaos, TrainChaosMonkey):
        monkey = chaos
    elif chaos is not None:
        monkey = TrainChaosMonkey(chaos, total_steps=steps)
    hook = nan_grad_hook if (monkey and monkey.nan_steps) else None
    step_fn = make_train_step(model, optimizer, run, guard=True,
                              grad_hook=hook)

    # -- loop state: checkpointed, restored bit-for-bit on resume -----------
    start = 0
    salt = 0                        # rollback window counter (data reseed)
    ewma: Optional[float] = None    # loss EWMA for the spike detector
    ewma_n = 0
    consec_skips = 0
    skipped_total = 0
    rollbacks = 0
    anomalies = 0
    ckpt_failures = 0
    # the reference's jax.random.PRNGKey(seed) as it checkpoints it
    rng_key = [(run.seed >> 32) & 0xFFFFFFFF, run.seed & 0xFFFFFFFF]

    ckpt = CheckpointManager(
        checkpoint_dir, keep=run.keep_checkpoints,
        fault_hook=monkey.ckpt_fault if monkey else None) \
        if checkpoint_dir else None
    resumed_at = None
    if ckpt and resume and ckpt.latest_step() is not None:
        start, state = ckpt.restore({"params": params, "opt": opt_state})
        state = _to_device(state, dev)
        params, opt_state = state["params"], state["opt"]
        loop = ckpt.load_extra(start).get("loop", {})
        salt = int(loop.get("data_salt", 0))
        ewma = loop.get("loss_ewma")
        ewma_n = int(loop.get("ewma_n", 0))
        consec_skips = int(loop.get("consec_skips", 0))
        skipped_total = int(loop.get("skipped_steps", 0))
        rollbacks = int(loop.get("rollbacks", 0))
        anomalies = int(loop.get("anomalies", 0))
        rng_key = loop.get("rng_key", rng_key)
        resumed_at = start
        print(f"resumed from step {start} (salt={salt})")

    batch_fn = make_batch_fn(cfg, shape, seed=_salted_seed(run.seed, salt))
    preempt = PreemptionHandler().install()
    straggler = StragglerMonitor()
    losses: List[float] = []
    step_seconds: List[float] = []
    first_step = start
    preempted = False
    t_begin = time.time()

    def loop_state(step_next: int) -> Dict[str, Any]:
        return {"step": step_next, "data_salt": salt, "loss_ewma": ewma,
                "ewma_n": ewma_n, "consec_skips": consec_skips,
                "skipped_steps": skipped_total, "rollbacks": rollbacks,
                "anomalies": anomalies, "rng_key": rng_key,
                "straggler_flags": len(straggler.flagged)}

    def save_boundary(step_next: int, loss: float) -> bool:
        nonlocal ckpt_failures
        try:
            ckpt.save(step_next, {"params": params, "opt": opt_state},
                      extra={"loss": loss, "loop": loop_state(step_next)})
            RestartManifest(
                step=step_next, checkpoint_dir=checkpoint_dir,
                mesh_shape=[1], mesh_axes=["data"],
                data_seed=run.seed, arch=arch, shape=shape.name,
                straggler_events=straggler.flagged,
                train=loop_state(step_next),
            ).save(os.path.join(checkpoint_dir, "manifest.json"))
            if monkey:
                monkey.maybe_tear(ckpt, step_next)
        except CheckpointWriteError as e:
            ckpt_failures += 1
            warnings.warn(f"checkpoint write failed at step {step_next} "
                          f"({e}); training continues — the previous "
                          "checkpoint still restores")
            return False
        return True

    def drain_writer() -> None:
        nonlocal ckpt_failures
        if not ckpt:
            return
        try:
            ckpt.wait()
        except CheckpointWriteError as e:
            ckpt_failures += 1
            warnings.warn(str(e))

    step = start
    while step < steps:
        straggler.step_start()
        t_step = time.monotonic()
        if monkey:
            try:
                monkey.on_step(step)    # injected sleep / hard host crash
            except Exception:
                preempt.uninstall()
                drain_writer()
                raise
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch_fn(step).items()}
        if hook is not None:
            arm = torch.tensor(1 if monkey.nan_armed(step) else 0,
                               dtype=torch.int32).to(dev)
            params, opt_state, metrics = step_fn(params, opt_state, b, arm)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        losses.append(loss)
        step_seconds.append(time.monotonic() - t_step)

        if bool(metrics["skipped"]):
            skipped_total += 1
            consec_skips += 1
            print(f"step {step:5d} SKIPPED non-finite loss/grads "
                  f"(grad_norm={gnorm:.3g}, {consec_skips} consecutive)")
            if consec_skips >= max_bad_steps:
                preempt.uninstall()
                drain_writer()
                raise TrainDivergedError(
                    f"{consec_skips} consecutive non-finite steps ending at "
                    f"step {step} (max_bad_steps={max_bad_steps})")
        else:
            consec_skips = 0
            observed = loss * (monkey.loss_scale(step, salt) if monkey
                               else 1.0)
            if (spike_factor > 0 and ewma is not None
                    and ewma_n >= spike_warmup
                    and observed > spike_factor * max(ewma, 1e-9)):
                anomalies += 1
                drain_writer()  # pending async saves must be visible, so
                                # the rollback target is deterministic
                if ckpt and ckpt.latest_step() is not None:
                    rb, state = ckpt.restore({"params": params,
                                              "opt": opt_state})
                    state = _to_device(state, dev)
                    params, opt_state = state["params"], state["opt"]
                    loop = ckpt.load_extra(rb).get("loop", {})
                    rollbacks += 1
                    salt = int(loop.get("data_salt", 0)) + 1
                    ewma = loop.get("loss_ewma")
                    ewma_n = int(loop.get("ewma_n", 0))
                    consec_skips = int(loop.get("consec_skips", 0))
                    skipped_total = int(loop.get("skipped_steps", 0))
                    batch_fn = make_batch_fn(
                        cfg, shape, seed=_salted_seed(run.seed, salt))
                    if rb < first_step:
                        first_step = rb
                        del losses[:], step_seconds[:]
                    else:
                        del losses[rb - first_step:]
                        del step_seconds[rb - first_step:]
                    print(f"loss spike at step {step} ({observed:.3f} > "
                          f"{spike_factor:.1f}x EWMA): rolled back to step "
                          f"{rb}, data window re-seeded (salt={salt})")
                    step = rb
                    continue
                warnings.warn(f"loss spike at step {step} with no "
                              "checkpoint to roll back to; continuing")
            ewma = observed if ewma is None else 0.9 * ewma + 0.1 * observed
            ewma_n += 1

        flag = straggler.step_end(step)
        if flag:
            print(f"  straggler flag: {flag}")
        if step % log_every == 0 or step == steps - 1:
            dt = time.time() - t_begin
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"({dt / max(step - start + 1, 1):.2f}s/step)")
        if preempt_after is not None and start < preempt_after <= step + 1:
            preempt.requested = True
        if monkey and monkey.preempt(step):
            preempt.requested = True
        if ckpt and ((step + 1) % run.checkpoint_every == 0
                     or preempt.requested or step == steps - 1):
            save_boundary(step + 1, loss)
        if preempt.requested:
            print(f"preemption requested: checkpointed at {step + 1}, "
                  "exiting cleanly")
            preempted = True
            break
        step += 1
    preempt.uninstall()
    drain_writer()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "step_seconds": step_seconds,
            "params": params, "opt_state": opt_state,
            "first_step": first_step, "resumed_at": resumed_at,
            "preempted": preempted, "skipped_steps": skipped_total,
            "rollbacks": rollbacks, "anomalies": anomalies,
            "ckpt_failures": ckpt_failures,
            "chaos_events": list(monkey.events) if monkey else []}


class TrainSupervisor:
    """Bounded auto-restart loop around :func:`train`.

    Each attempt resumes from the last *verified* checkpoint
    (``CheckpointManager.restore`` walks back past torn/corrupt steps). An
    injected preemption or hard step crash consumes one restart;
    :class:`TrainDivergedError` is never retried — a divergence replays
    deterministically, so a restart would only burn the budget. One chaos
    monkey is shared across attempts: operational faults (preempt, crash,
    checkpoint failures/tears) fire once per supervised run, per-step data
    faults (NaN grads, spikes) replay by absolute step — together that makes
    the supervised run byte-identical to an uninterrupted one
    (:func:`verify_resume_identity`).
    """

    def __init__(self, arch: str, *, checkpoint_dir: str, steps: int,
                 max_restarts: int = 2, chaos: Any = None,
                 preempt_after: Optional[int] = None, **train_kw):
        assert checkpoint_dir, "TrainSupervisor needs a checkpoint_dir"
        self.arch = arch
        self.checkpoint_dir = checkpoint_dir
        self.steps = steps
        self.max_restarts = max_restarts
        if chaos is not None and not isinstance(chaos, TrainChaosMonkey):
            chaos = TrainChaosMonkey(chaos, total_steps=steps)
        self.monkey: Optional[TrainChaosMonkey] = chaos
        self.preempt_after = preempt_after
        self.train_kw = train_kw
        self.restarts = 0
        self.attempts: List[Dict[str, Any]] = []

    def run(self) -> Dict[str, Any]:
        while True:
            try:
                out = train(self.arch, checkpoint_dir=self.checkpoint_dir,
                            steps=self.steps, resume=True, chaos=self.monkey,
                            preempt_after=(self.preempt_after
                                           if self.restarts == 0 else None),
                            **self.train_kw)
            except TrainDivergedError:
                raise
            except Exception as e:  # noqa: BLE001 — supervisor absorbs
                self.attempts.append({"error": repr(e)})
                if self.restarts >= self.max_restarts:
                    raise
                self.restarts += 1
                print(f"supervisor: attempt {self.restarts} died ({e!r}); "
                      "restarting from the last verified checkpoint")
                continue
            self.attempts.append({"first_step": out["first_step"],
                                  "losses": list(out["losses"]),
                                  "preempted": out["preempted"]})
            if out["preempted"] and self.restarts < self.max_restarts:
                self.restarts += 1
                print(f"supervisor: preempted; restart "
                      f"{self.restarts}/{self.max_restarts}")
                continue
            out["restarts"] = self.restarts
            out["losses_full"] = self.stitched_losses()
            return out

    def stitched_losses(self) -> List[float]:
        """Per-attempt loss curves merged by absolute step (later attempts
        win — they replayed those steps from a verified checkpoint)."""
        by_step: Dict[int, float] = {}
        for a in self.attempts:
            if "losses" not in a:
                continue
            for i, loss in enumerate(a["losses"]):
                by_step[a["first_step"] + i] = loss
        return [by_step[s] for s in sorted(by_step)]


def _strip_operational(cfg: TrainChaosConfig) -> TrainChaosConfig:
    """The reference run keeps per-step data faults (NaN/slow/spike — they
    must replay identically) but drops operational faults (preemption,
    crashes, checkpoint failures/tears — the interruptions under test)."""
    return dataclasses.replace(
        cfg, preempt=-1, crash=0, ckpt_fail=0, torn=0,
        crash_steps=None, ckpt_fail_steps=None, torn_steps=None)


def verify_resume_identity(arch: str, *, steps: int, work_dir: str,
                           chaos: Optional[TrainChaosConfig] = None,
                           preempt_after: Optional[int] = None,
                           max_restarts: int = 2,
                           **train_kw) -> Dict[str, Any]:
    """The resume-identity gate: a run interrupted by preemption/crashes and
    auto-restarted by :class:`TrainSupervisor` must produce byte-identical
    losses and final params vs an uninterrupted reference run."""
    sup = TrainSupervisor(arch, checkpoint_dir=os.path.join(work_dir, "sup"),
                          steps=steps, max_restarts=max_restarts,
                          chaos=chaos, preempt_after=preempt_after,
                          **train_kw)
    out = sup.run()
    ref_chaos = _strip_operational(chaos) if chaos is not None else None
    ref = train(arch, steps=steps,
                checkpoint_dir=os.path.join(work_dir, "ref"),
                chaos=ref_chaos, **train_kw)
    losses_ok = (len(out["losses_full"]) == len(ref["losses"])
                 and np.array_equal(np.asarray(out["losses_full"]),
                                    np.asarray(ref["losses"]),
                                    equal_nan=True))
    pa = leaves(_tree_host(out["params"]))
    pb = leaves(_tree_host(ref["params"]))
    params_ok = len(pa) == len(pb) and all(
        a.tobytes() == b.tobytes() for a, b in zip(pa, pb))
    return {"identical": losses_ok and params_ok,
            "losses_match": losses_ok, "params_match": params_ok,
            "restarts": out["restarts"],
            "skipped_steps": out["skipped_steps"],
            "rollbacks": out["rollbacks"],
            "ckpt_failures": out["ckpt_failures"],
            "out": out, "ref": ref}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="pimref-100m", choices=list(ALL_IDS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="checkpoint interval in steps (default: RunConfig)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="seed for the REPRO_CHAOS train fault plan (arms "
                    "a default nan+slow plan when the env var is unset)")
    ap.add_argument("--supervise", action="store_true",
                    help="wrap the run in TrainSupervisor auto-restart")
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--max-bad-steps", type=int, default=8)
    ap.add_argument("--spike-factor", type=float, default=3.0)
    ap.add_argument("--preempt-after", type=int, default=None,
                    help="request a clean preemption once this absolute "
                    "step is crossed (with --supervise / --resume-verify "
                    "the run auto-restarts)")
    ap.add_argument("--resume-verify", action="store_true",
                    help="run the interrupted+resumed vs uninterrupted "
                    "byte-identity gate and exit")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="train on the card (default) or, asked for, on the "
                    "CPU through the plain PyTorch path")
    args = ap.parse_args()
    run = RunConfig(total_steps=args.steps, learning_rate=args.lr,
                    microbatches=1,
                    checkpoint_every=args.checkpoint_every or 200)
    chaos = TrainChaosConfig.from_env(args.chaos_seed)
    if chaos is None and args.chaos_seed is not None:
        chaos = TrainChaosConfig.parse("nan=1,slow=1", seed=args.chaos_seed)
    common: Dict[str, Any] = dict(
        smoke=args.smoke, batch=args.batch, seq=args.seq, run=run,
        max_bad_steps=args.max_bad_steps, spike_factor=args.spike_factor,
        device=args.device)
    if args.resume_verify:
        work = args.checkpoint_dir or tempfile.mkdtemp(prefix="train_verify_")
        res = verify_resume_identity(
            args.arch, steps=args.steps, work_dir=work, chaos=chaos,
            preempt_after=args.preempt_after or max(args.steps // 2, 1),
            max_restarts=args.max_restarts, **common)
        assert res["identical"], (
            f"resume-verify FAILED: losses_match={res['losses_match']} "
            f"params_match={res['params_match']}")
        print(f"resume-verify: byte-identical across {res['restarts']} "
              f"restart(s) ({res['skipped_steps']} skipped, "
              f"{res['rollbacks']} rollback(s))")
        return
    if args.supervise or (args.preempt_after is not None):
        assert args.checkpoint_dir, "--supervise needs --checkpoint-dir"
        sup = TrainSupervisor(
            args.arch, checkpoint_dir=args.checkpoint_dir, steps=args.steps,
            max_restarts=args.max_restarts, chaos=chaos,
            preempt_after=args.preempt_after, **common)
        out = sup.run()
        print(f"supervisor: {out['restarts']} restart(s), "
              f"{out['skipped_steps']} skipped step(s), "
              f"{out['rollbacks']} rollback(s)")
    else:
        out = train(args.arch, steps=args.steps,
                    checkpoint_dir=args.checkpoint_dir, resume=args.resume,
                    chaos=chaos, **common)
    if chaos is not None and (chaos.nan or chaos.nan_steps):
        assert out["skipped_steps"] >= 1, \
            "chaos armed NaN grads but no step was skipped"
        print(f"chaos: survived {out['skipped_steps']} skipped step(s), "
              f"{out['rollbacks']} rollback(s), "
              f"{len(out['chaos_events'])} injected event(s)")
    if out["final_loss"] is None:
        print(f"nothing to do: resumed at step {out['resumed_at']}, "
              f"already past --steps {args.steps}")
    else:
        print(f"final loss: {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
