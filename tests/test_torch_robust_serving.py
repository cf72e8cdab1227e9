"""The port's robust serving layer (``ServeEngine``'s queue bound,
deadlines, NaN quarantine, retries, load shedding, snapshots and the chaos
harness) against the reference's, function by function of
``tests/test_robust_serving.py``, at smoke size in fp32 on the CPU.

The reference side is the mesh-less ``ServeEngine`` (its KV and drafter
knobs set through ``monkeypatch``) with the same weights through
``models/bridge.py``. Where both drain the same requests under the same
explicit faults, the uids, finish reasons, typed reasons and token ids
must be equal; chaos plans drawn from one seed must be equal event for
event. Tolerance: exact (greedy fp32 tokens and integer plans)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.core.mimdram import plan_sharding, use_plan  # noqa: E402
from repro.distributed import chaos as jchaos  # noqa: E402
from repro.distributed.fault_tolerance import \
    RestartManifest as JRestartManifest  # noqa: E402
from repro.launch import engine as jengine  # noqa: E402
from repro.models import build_model, init_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import chaos as tchaos  # noqa: E402
from repro_torch.distributed.chaos import TransientStepError  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.engine import (ErrorReason,  # noqa: E402
                                       PagePoolExhaustedError, Request,
                                       _PageAllocator)

PS = 4          # page size of the paged layouts
KNOBS = ("REPRO_KV_PAGES", "REPRO_KV_QUANT", "REPRO_SPEC_DECODE",
         "REPRO_SPEC_K", "REPRO_CHAOS")
LAYOUTS = {"contig": dict(kv_quant="off", page_size=0),
           "paged": dict(kv_quant="off", page_size=PS),
           "paged_q8": dict(kv_quant="int8", page_size=PS),
           "spec": dict(kv_quant="off", page_size=0, spec="ngram")}


@pytest.fixture(scope="module")
def ref():
    jcfg = get_config("pimref-100m", smoke=True).replace(
        compute_dtype="float32")
    tcfg = tconfigs.get_config("pimref-100m", smoke=True).replace(
        compute_dtype="float32")
    plan = plan_sharding(jcfg, ShapeConfig("serve", 16, 2, "decode"), None)
    jm = build_model(jcfg)
    with use_plan(plan):
        params = init_params(jm.param_specs(), jax.random.PRNGKey(0))
    return dict(jcfg=jcfg, tcfg=tcfg, plan=plan, jm=jm, params=params,
                np_params=jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture
def layout(monkeypatch):
    """Sets the reference's knobs for a named layout; returns the port's
    explicit arguments."""
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)

    def set_layout(name):
        lay = LAYOUTS[name]
        monkeypatch.setenv("REPRO_KV_PAGES", str(lay["page_size"]))
        monkeypatch.setenv("REPRO_KV_QUANT", lay["kv_quant"])
        monkeypatch.setenv("REPRO_SPEC_DECODE", lay.get("spec", "off"))
        return dict(lay)
    return set_layout


def _port(ref, lay, slots=2, prompt_len=8, max_new=8, chunk=4, **kw):
    return tserve.make_queue_engine(
        slots=slots, prompt_len=prompt_len, gen=max_new, chunk=chunk,
        device="cpu", cfg=ref["tcfg"], params=ref["np_params"], **lay, **kw)


def _jref(ref, slots=2, prompt_len=8, max_new=8, chunk=4, **kw):
    """The reference engine; its layout comes from the knobs."""
    return jengine.ServeEngine(ref["jm"], ref["params"], ref["plan"],
                               slots=slots, prompt_len=prompt_len,
                               max_new=max_new, chunk=chunk, **kw)


def _chaos(**kw):
    """The same chaos config in both packages: (reference, port)."""
    return jchaos.ChaosConfig(**kw), tchaos.ChaosConfig(**kw)


def _prompts(ref, n, prompt_len=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, ref["tcfg"].vocab_size,
                         prompt_len).astype(np.int32) for _ in range(n)]


def _requests(prompts, max_new=8, cls=Request):
    return [cls(uid=i, tokens=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]


def _by_uid(eng):
    return {c.uid: c for c in eng.completions}


def _summary(eng):
    return sorted((c.uid, c.finish_reason, c.reason,
                   np.asarray(c.tokens).tolist()) for c in eng.completions)


def _same_as_reference(teng, jeng):
    """Exactly one completion per uid on the port's side, and the port's
    completions equal the reference's: uids, finish reasons, typed reasons
    and token ids."""
    uids = [c.uid for c in teng.completions]
    assert len(uids) == len(set(uids)), uids
    assert _summary(teng) == _summary(jeng)


# ---------------------------------------------------------------------------
# Typed errors and chaos plumbing (no engine builds)
# ---------------------------------------------------------------------------
def test_page_allocator_typed_exhaustion():
    alloc = _PageAllocator(3)                      # 2 usable (row 0 = trash)
    assert alloc.alloc() == 1 and alloc.alloc() == 2
    with pytest.raises(PagePoolExhaustedError) as ei:
        alloc.alloc("unit test")
    assert ei.value.pool_stats == {"n_phys": 3, "free": 0, "used": 2,
                                   "registered": 0}
    assert "unit test" in str(ei.value)
    alloc.decref(2)                                # freed pages allocate again
    assert alloc.alloc() == 2


def test_error_reason_enum_is_the_reference_vocabulary():
    assert [r.value for r in ErrorReason] == \
        [r.value for r in jengine.ErrorReason]
    assert {r.value for r in ErrorReason} == {
        "prompt_too_long", "bad_request", "queue_full", "deadline",
        "page_pool", "nan_logits", "step_failure", "shard_lost"}
    assert str(ErrorReason.NAN_LOGITS) == "nan_logits"


def test_chaos_config_parse_and_env(monkeypatch):
    spec = "nan=1, slow=2,fail=1,pages=4,slow_ms=7"
    cfg = tchaos.ChaosConfig.parse(spec, seed=9)
    assert (cfg.nan, cfg.slow, cfg.fail, cfg.pages) == (1, 2, 1, 4)
    assert cfg.slow_ms == 7.0 and cfg.seed == 9 and cfg.wants_nan
    assert vars(cfg) == vars(jchaos.ChaosConfig.parse(spec, seed=9))
    with pytest.raises(ValueError, match="unknown chaos knob"):
        tchaos.ChaosConfig.parse("bogus=1")
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    assert tchaos.ChaosConfig.from_env() is None
    monkeypatch.setenv("REPRO_CHAOS", "fail=2")
    env = tchaos.ChaosConfig.from_env(seed=5)
    assert env.fail == 2 and env.seed == 5 and not env.wants_nan


class _Alloc:
    """A free list, all a page steal reads."""

    def __init__(self, n):
        self.free = list(range(n, 0, -1))


def _monkey_plan(mod, cfg, chunks=12, uids=10):
    """Every decision a ChaosMonkey makes over a drain: NaN positions per
    admission, (slow, fail) per chunk (fired: the sleep skipped), stolen
    pages."""
    mk = mod.ChaosMonkey(cfg)
    mk.cfg.slow_ms = 0.0
    alloc = _Alloc(9)
    plan = []
    for i in range(max(chunks, uids)):
        if i < uids:
            plan.append(("nan", mk.plan_request(i, 8 + i % 3, 8 + i % 5)))
        if i < chunks:
            mk.page_pressure(alloc, i)
            try:
                mk.on_chunk(i)
                plan.append(("chunk", i, "ok"))
            except mod.TransientStepError:
                plan.append(("chunk", i, "fail"))
                mk.on_chunk(i)                     # fire-once: the retry
    return plan, mk.events, mk.held_pages, sorted(alloc.free)


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
def test_chaos_monkey_plan_matches_reference(seed):
    """The same seed draws the same faults in the same order: NaN targets
    and positions, slow and failing chunks (fire-once on retry), stolen
    pages."""
    kw = dict(seed=seed, nan=3, slow=2, fail=2, pages=4, steal_after_chunk=2)
    jcfg, tcfg = _chaos(**kw)
    got = _monkey_plan(tchaos, tcfg)
    assert got == _monkey_plan(jchaos, jcfg)
    kinds = {e["kind"] for e in got[1]}
    assert "pages" in kinds and len(got[2]) == 4
    explicit = dict(seed=seed, nan_targets={2: 1, 5: 3}, slow_chunks=[1],
                    fail_chunks=[0, 4])
    jcfg, tcfg = _chaos(**explicit)
    assert _monkey_plan(tchaos, tcfg) == _monkey_plan(jchaos, jcfg)


@pytest.mark.parametrize("spec,n_shards", [
    ("kills=1,seed=3", 4), ("kills=1,stalls=1,drops=1,seed=7", 3),
    ("kills=2,drops=2,seed=0,window=6", 4), ("stalls=1,seed=5", 2)])
def test_shard_chaos_plan_matches_reference(spec, n_shards):
    """A seeded shard-fault plan is a pure function of (seed, shards), the
    reference's."""
    got = tchaos.ShardChaosMonkey(tchaos.ShardChaosConfig.parse(spec),
                                  n_shards)
    want = jchaos.ShardChaosMonkey(jchaos.ShardChaosConfig.parse(spec),
                                   n_shards)
    assert got._plan == want._plan and got._plan


def test_synth_requests_repeat_period_matches_reference():
    from repro.launch.serve import synth_requests as jsynth
    for kw in (dict(repeat_period=4), dict(repeat_period=3, shared_prefix=5),
               dict(repeat_period=0, shared_prefix=2)):
        want = jsynth("pimref-100m", requests=7, prompt_len=24, gen=8,
                      seed=5, **kw)
        got = tserve.synth_requests("pimref-100m", requests=7, prompt_len=24,
                                    gen=8, seed=5, **kw)
        assert len(got) == len(want) == 7
        for a, b in zip(got, want):
            assert (a.uid, a.max_new_tokens) == (b.uid, b.max_new_tokens)
            np.testing.assert_array_equal(a.tokens, b.tokens)
    period = tserve.synth_requests("pimref-100m", requests=2, prompt_len=24,
                                   gen=8, seed=5, repeat_period=4)[0].tokens
    assert (period[4:] == period[:-4]).all()


# ---------------------------------------------------------------------------
# Admission control and backpressure
# ---------------------------------------------------------------------------
def test_bounded_queue_rejects_with_queue_full(ref, layout):
    """Submissions past ``max_queue`` complete at once with a typed
    ``queue_full`` error and ``submit`` returns False, as the reference's;
    accepted work still drains, to the reference's tokens."""
    lay = layout("contig")
    prompts = _prompts(ref, 3)
    teng = _port(ref, lay, slots=1, max_queue=1)
    jeng = _jref(ref, slots=1, max_queue=1)
    for eng, cls in ((teng, Request), (jeng, jengine.Request)):
        reqs = _requests(prompts, max_new=4, cls=cls)
        assert [eng.submit(r) for r in reqs] == [True, False, False]
        eng.run()
    _same_as_reference(teng, jeng)
    comps = _by_uid(teng)
    assert comps[0].finish_reason == "length" and len(comps[0].tokens) == 4
    assert [comps[u].reason for u in (1, 2)] == ["queue_full"] * 2
    assert all(len(comps[u].tokens) == 0 for u in (1, 2))
    assert teng.stats["error_completions"] == 2
    assert teng.stats["queue_peak"] == jeng.stats["queue_peak"] == 1


def test_paged_admission_reserves_worst_case_pages(ref, layout):
    """A pool sized for one worst-case request serializes admissions
    (backpressure, never exhaustion) and equals a full-size pool's drain."""
    lay = layout("paged")
    # worst_pages(n=8, cap=8) = ceil(min(8+8-1+4, 16)/4) = 4 = the whole pool
    eng = _port(ref, lay, page_pool_pages=4)
    assert eng.paged and eng.n_phys_pages == 5
    eng.run(_requests(_prompts(ref, 3)))
    comps = _by_uid(eng)
    assert all(c.finish_reason == "length" for c in comps.values())
    assert eng.stats["admission_blocked"] > 0
    assert eng.stats["error_completions"] == 0
    assert eng.stats["kv_pages_in_use"] == 0
    full = _port(ref, lay)
    full.run(_requests(_prompts(ref, 3)))
    assert _summary(eng) == _summary(full)


def test_paged_oversized_request_fails_fast(ref, layout):
    lay = layout("paged")
    eng = _port(ref, lay, page_pool_pages=3)       # capacity 3 < need 4
    eng.run(_requests(_prompts(ref, 1)))
    (c,) = eng.completions
    assert c.finish_reason == "error" and c.reason == "page_pool"
    assert "pool holds 3" in c.error


def test_chaos_page_steal_hits_typed_exhaustion(ref, layout):
    """Pages stolen by chaos surface as a typed ``page_pool`` error on the
    request that needed them; the rest drains; the reference agrees."""
    lay = layout("paged")
    jc, tc = _chaos(seed=0, pages=99, steal_after_chunk=1)
    teng = _port(ref, lay, slots=1, chaos=tc)
    jeng = _jref(ref, slots=1, chaos=jc)
    prompts = _prompts(ref, 2)
    teng.run(_requests(prompts))
    jeng.run(_requests(prompts, cls=jengine.Request))
    _same_as_reference(teng, jeng)
    comps = _by_uid(teng)
    assert comps[0].finish_reason == "length"
    assert comps[1].reason == "page_pool" and "exhausted" in comps[1].error
    assert teng.chaos_events == jeng.chaos_events
    assert any(e["kind"] == "pages" for e in teng.chaos_events)
    teng._chaos.release_pages(teng._alloc)
    assert len(teng._alloc.free) == teng.n_phys_pages - 1


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["contig", "paged"])
def test_deadline_retires_queued_and_active(ref, layout, name):
    """On an injected clock: an expired active request returns its partial
    tokens with a ``deadline`` error, an expired queued one returns empty,
    and the deadline-free request equals a fault-free drain; the reference
    gives the same completions."""
    lay = layout(name)
    prompts = _prompts(ref, 3)
    engines = []
    for make, cls in ((_port, Request), (_jref, jengine.Request)):
        clk = {"t": 100.0}
        args = (ref, lay) if make is _port else (ref,)
        eng = make(*args, slots=1, clock=lambda c=clk: c["t"])
        reqs = _requests(prompts, cls=cls)
        reqs[0].deadline_ms = reqs[1].deadline_ms = 1000.0
        for r in reqs:
            eng.submit(r)
        assert eng.step()                          # admit uid 0, one chunk
        clk["t"] += 10.0                           # both deadlines expire
        eng.run()
        engines.append(eng)
    teng, jeng = engines
    _same_as_reference(teng, jeng)
    comps = _by_uid(teng)
    assert comps[0].reason == "deadline" and 0 < len(comps[0].tokens) < 8
    assert comps[1].reason == "deadline" and len(comps[1].tokens) == 0
    assert comps[2].finish_reason == "length"
    assert teng.stats["deadline_miss"] == jeng.stats["deadline_miss"] == 2
    if teng.paged:
        assert teng.stats["kv_pages_in_use"] == 0
    clean = _port(ref, lay, slots=1)
    clean.run(_requests(prompts)[2:])
    assert comps[2].tokens.tolist() == _by_uid(clean)[2].tokens.tolist()


# ---------------------------------------------------------------------------
# NaN quarantine (the chunk's finite guard, the logits hook)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["contig", "paged", "paged_q8", "spec"])
def test_nan_quarantine_is_per_slot(ref, layout, name):
    """Poisoned logits quarantine exactly the slot they hit: the victim
    returns the clean ``g + 1``-token prefix with a ``nan_logits`` error,
    every co-resident request equals a fault-free drain, in the four
    cache / drafter configurations (the hook runs in the verify block with
    ``spec``); the mesh-less reference gives the same completions and
    events."""
    lay = layout(name)
    g = 2
    jc, tc = _chaos(seed=0, nan_targets={1: g})
    prompts = _prompts(ref, 3)
    teng = _port(ref, lay, chaos=tc)
    teng.run(_requests(prompts))
    jeng = _jref(ref, chaos=jc)
    jeng.run(_requests(prompts, cls=jengine.Request))
    _same_as_reference(teng, jeng)
    assert teng.chaos_events == jeng.chaos_events == [
        {"kind": "nan", "uid": 1, "pos": 8 + g}]
    clean = _port(ref, lay)
    clean.run(_requests(prompts))
    refs, comps = _by_uid(clean), _by_uid(teng)
    assert comps[1].reason == "nan_logits" and len(comps[1].tokens) == g + 1
    assert comps[1].tokens.tolist() == refs[1].tokens.tolist()[:g + 1]
    for uid in (0, 2):
        assert comps[uid].finish_reason == refs[uid].finish_reason
        assert comps[uid].tokens.tolist() == refs[uid].tokens.tolist(), uid


# ---------------------------------------------------------------------------
# Transient failures: retry, then fail over
# ---------------------------------------------------------------------------
def test_transient_failure_retries_to_identity(ref, layout):
    lay = layout("contig")
    jc, tc = _chaos(seed=0, fail_chunks=[1])
    prompts = _prompts(ref, 3)
    teng = _port(ref, lay, chaos=tc, retry_backoff_s=0.0)
    teng.run(_requests(prompts))
    jeng = _jref(ref, chaos=jc, retry_backoff_s=0.0)
    jeng.run(_requests(prompts, cls=jengine.Request))
    _same_as_reference(teng, jeng)
    assert teng.stats["retries"] == jeng.stats["retries"] == 1
    assert teng.stats["error_completions"] == 0
    clean = _port(ref, lay)
    clean.run(_requests(prompts))
    assert _summary(teng) == _summary(clean)


@pytest.mark.parametrize("name", ["contig", "paged"])
def test_persistent_failure_fails_over_every_request(ref, layout, name):
    """Past the retry budget every in-flight and queued request ends with
    a ``step_failure`` error and the engine stays dead; a dead paged
    engine writes no device table."""
    lay = layout(name)
    eng = _port(ref, lay, slots=1, chaos=tchaos.ChaosConfig(),
                max_retries=1, retry_backoff_s=0.0)

    def always_fail(idx):
        raise TransientStepError(f"persistent fault at chunk {idx}")

    eng._chaos.on_chunk = always_fail
    writes = []
    if eng.paged:
        put = eng._set_table_row
        eng._set_table_row = lambda *a: (writes.append(a) if eng._dead
                                         else put(*a))
    eng.run(_requests(_prompts(ref, 3)))
    comps = _by_uid(eng)
    assert sorted(comps) == [0, 1, 2]
    assert all(c.reason == "step_failure" for c in comps.values())
    assert eng.stats["retries"] == 2               # 1 retry + the final trip
    assert eng._dead and eng.step() is False
    assert writes == []
    if eng.paged:
        assert eng.stats["kv_pages_in_use"] == 0


def test_dispatch_exception_kills_the_engine(ref, layout):
    """A dispatch that raises (on the card: a sticky CUDA error) ends
    everything in flight with ``step_failure``; the engine is dead and
    touches no device buffer afterwards."""
    lay = layout("paged")
    eng = _port(ref, lay, slots=1)

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    eng._generate._eager = broken                  # inside the dispatch
    put = eng._set_table_row
    eng._set_table_row = lambda *a: (
        pytest.fail("device write after death") if eng._dead else put(*a))
    eng.run(_requests(_prompts(ref, 2)))
    assert [c.reason for c in eng.completions] == ["step_failure"] * 2
    assert "illegal memory access" in eng.completions[0].error
    assert eng._dead and eng.step() is False


# ---------------------------------------------------------------------------
# Watchdog and load shedding
# ---------------------------------------------------------------------------
class _FlagOn:
    """Deterministic StragglerMonitor stand-in: flags exact chunk indices."""

    def __init__(self, steps):
        self.steps, self.flagged = set(steps), []

    def step_start(self):
        pass

    def step_end(self, idx):
        if idx in self.steps:
            self.flagged.append({"step": idx, "seconds": 1.0, "ema": 0.1})
            return self.flagged[-1]
        return None


@pytest.mark.parametrize("name", ["contig", "spec"])
def test_straggler_watchdog_sheds_load_byte_identically(ref, layout, name):
    """Straggler flags shed one level each (speculation off first, then
    the chunk halved); the token streams equal an unshed drain's and the
    decode steps follow the live program."""
    lay = layout(name)
    eng = _port(ref, lay, max_new=16, shed_after=1)
    eng._straggler = _FlagOn({2, 3})
    eng.run(_requests(_prompts(ref, 4), max_new=16))
    assert eng.stats["straggler_events"] == 2
    assert eng.stats["shed_events"] == 2
    assert len(eng.stats["shed_capture_seconds"]) == 2
    assert eng._spec_live == "off"
    assert eng._chunk_live == (2 if name == "spec" else 1)
    assert eng._gen_shed.chunk == eng._chunk_live
    unshed = _port(ref, lay, max_new=16)
    unshed.run(_requests(_prompts(ref, 4), max_new=16))
    assert _summary(eng) == _summary(unshed)
    # the shed programs' shorter chunks take more dispatches
    assert eng.stats["decode_dispatches"] > unshed.stats["decode_dispatches"]


# ---------------------------------------------------------------------------
# Checkpoint / restore
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name,resume", [("contig", False),
                                         ("paged", False), ("paged", True)])
def test_snapshot_restore_drains_byte_identically(ref, layout, name, resume):
    """Preempt mid-drain, snapshot, restore into a fresh engine, drain: the
    union equals an uninterrupted drain. The port regenerates in-flight
    requests; ``resume=True`` (paged) re-prefills prompt + produced as the
    reference does, which is exact here (the plain path, fp32, unquantized
    KV) and round-trips a second snapshot to the first."""
    lay = layout(name)
    prompts = _prompts(ref, 4)
    eng = _port(ref, lay)
    for r in _requests(prompts):
        eng.submit(r)
    eng.run(stop=lambda: eng.stats["decode_dispatches"] >= 1)
    snap = eng.snapshot()
    assert snap["active"] and any(d["produced"] for d in snap["active"])
    json.dumps(snap)                               # manifest-serializable
    need = max(len(d["tokens"]) + len(d["produced"])
               for d in snap["queued"] + snap["active"])
    eng2 = _port(ref, lay, prompt_len=max(8, need) if resume else 8)
    eng2.load_snapshot(snap, resume=resume)
    snap2 = eng2.snapshot()
    key = (lambda d: (d["uid"], tuple(d["tokens"]), tuple(d["produced"]),
                      d["max_new_tokens"])) if resume else \
        (lambda d: (d["uid"], tuple(d["tokens"]), d["max_new_tokens"]))
    assert sorted(map(key, snap2["queued"] + snap2["active"])) == \
        sorted(map(key, snap["queued"] + snap["active"]))
    eng2.run()
    whole = _port(ref, lay)
    whole.run(_requests(prompts))
    assert _summary(eng2) == _summary(whole)
    if not resume:
        with pytest.raises(ValueError, match="paged"):
            _port(ref, LAYOUTS["contig"]).load_snapshot(snap, resume=True)


def test_port_manifest_loads_in_the_reference(ref, layout, tmp_path):
    """A port serving manifest is the reference's format: its
    ``RestartManifest.load`` reads it and its ``engine.env`` names the
    layout under the reference's knobs; the port's restore drains it to an
    uninterrupted drain's completions."""
    lay = layout("paged_q8")
    prompts = _prompts(ref, 4)
    eng = _port(ref, lay)
    for r in _requests(prompts):
        eng.submit(r)
    eng.run(stop=lambda: eng.stats["decode_dispatches"] >= 1)
    path = str(tmp_path / "serve.json")
    tserve.save_serve_manifest(path, eng, arch="pimref-100m", smoke=True,
                               slots=2, prompt_len=8, gen=8, chunk=4)
    man = JRestartManifest.load(path)
    e = man.serve["engine"]
    assert man.shape == "serve" and man.step == 1
    assert e["env"] == {"REPRO_KV_PAGES": str(PS), "REPRO_KV_QUANT": "int8",
                        "REPRO_SPEC_DECODE": "off"}
    assert (e["kv_quant"], e["page_size"], e["spec"], e["device"]) == \
        ("int8", PS, "off", "cpu")
    restored = tserve.restore_serve(path, device="cpu", cfg=ref["tcfg"],
                                    params=ref["np_params"])
    assert restored.paged and restored.model.kv_quant == "int8"
    whole = _port(ref, lay)
    whole.run(_requests(prompts))
    assert _summary(restored) == _summary(whole)


def test_reference_manifest_restores_in_the_port(ref, layout, tmp_path):
    """The port's restore reads a reference manifest's layout from its
    knobs (paged int8 here) and drains its queue to the completions of the
    reference's uninterrupted drain."""
    from repro.launch.serve import save_serve_manifest as jsave
    layout("paged_q8")
    jeng = _jref(ref)
    for r in _requests(_prompts(ref, 4), cls=jengine.Request):
        jeng.submit(r)
    jeng.run(stop=lambda: jeng.stats["decode_dispatches"] >= 1)
    path = str(tmp_path / "serve.json")
    jsave(path, jeng, arch="pimref-100m", smoke=True, slots=2, prompt_len=8,
          gen=8, chunk=4)
    jeng.run()                                     # the uninterrupted drain
    restored = tserve.restore_serve(path, device="cpu", cfg=ref["tcfg"],
                                    params=ref["np_params"])
    assert restored.paged and restored.page_size == PS
    assert restored.model.kv_quant == "int8"
    assert _summary(restored) == _summary(jeng)


# ---------------------------------------------------------------------------
# The invariant under everything at once
# ---------------------------------------------------------------------------
def test_exactly_one_completion_under_mixed_chaos(ref, layout):
    """Seeded NaN + slow + transient-failure + page-steal chaos on the
    quantized paged engine: every uid ends in exactly one completion with
    a typed reason when errored, and the reference's drain under the same
    seed gives the same completions and events."""
    lay = layout("paged_q8")
    kw = dict(seed=11, nan=2, slow=1, fail=1, pages=2, slow_ms=1.0,
              steal_after_chunk=2)
    jc, tc = _chaos(**kw)
    prompts = _prompts(ref, 6)
    teng = _port(ref, lay, chaos=tc, retry_backoff_s=0.0)
    teng.run(_requests(prompts))
    jeng = _jref(ref, chaos=jc, retry_backoff_s=0.0)
    jeng.run(_requests(prompts, cls=jengine.Request))
    _same_as_reference(teng, jeng)
    assert teng.chaos_events == jeng.chaos_events
    assert sorted(c.uid for c in teng.completions) == list(range(6))
    valid = {r.value for r in ErrorReason}
    for c in teng.completions:
        if c.finish_reason == "error":
            assert c.reason in valid and c.error
        else:
            assert c.reason is None
    assert teng.stats["error_completions"] == sum(
        c.finish_reason == "error" for c in teng.completions)


# ---------------------------------------------------------------------------
# The CLI's robust paths (queue mode on the CPU, smoke config)
# ---------------------------------------------------------------------------
def _cli(args, cwd, env=None):
    import os
    import subprocess
    import sys
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
               OMP_NUM_THREADS="2", **(env or {}))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         *args], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_serve_cli_chaos_verify_and_restore_verify(tmp_path):
    """``--chaos-seed`` with ``REPRO_CHAOS`` and ``--chaos-verify``; then
    ``--preempt-after`` (a real SIGTERM) writes a manifest that
    ``--restore --restore-verify`` drains to an uninterrupted drain's
    completions."""
    queue = ["--mode", "queue", "--smoke", "--slots", "4", "--requests", "10",
             "--prompt-len", "32", "--gen", "16", "--kv-page-size", "8"]
    out = _cli(queue + ["--chaos-seed", "7", "--chaos-verify"], tmp_path,
               {"REPRO_CHAOS": "nan=1,slow=1,fail=1,pages=2"})
    assert "chaos-verify: 8/10 fault-free survivors byte-identical" in out
    out = _cli(queue + ["--max-queue", "4", "--deadline-ms", "60000"],
               tmp_path)
    assert "6 error completions" in out and "queue peak 4" in out
    out = _cli(queue + ["--preempt-after", "2", "--snapshot", "m.json"],
               tmp_path)
    assert "preempted after 2 chunks" in out
    out = _cli(["--restore", "m.json", "--restore-verify"], tmp_path)
    assert "restore-verify: 10 completions byte-identical" in out
