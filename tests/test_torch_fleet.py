"""The port's sharded fleet (``launch/fleet.py``, ``distributed/
dispatcher.py``, ``HealthMonitor``) function by function of
``tests/test_fleet.py``, at smoke size in fp32 on the CPU: exactly one
completion per submitted request through shard kills, stalls and dropped
heartbeats, survivors byte-identical to one engine's drain (which equals
the mesh-less reference ``ServeEngine``'s, same weights through
``models/bridge.py``), and ``shard_lost`` only when no replay is possible.

One spawned-worker case runs here (a 2-shard ``mp`` drain equal to one
engine's); the ``mp`` kill runs on the card
(``tests/test_torch_graph_cuda.py``). Tolerance: exact."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.core.mimdram import plan_sharding, use_plan  # noqa: E402
from repro.distributed.dispatcher import Dispatcher as JDispatcher  # noqa: E402
from repro.distributed.fault_tolerance import \
    HealthMonitor as JHealthMonitor  # noqa: E402
from repro.launch.engine import Request as JRequest  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.models import build_model, init_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.distributed import fault_tolerance as ft  # noqa: E402
from repro_torch.distributed.chaos import (ShardChaosConfig,  # noqa: E402
                                           ShardChaosMonkey)
from repro_torch.distributed.dispatcher import Dispatcher  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    HealthMonitor, RestartManifest, ShardState)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.engine import Request  # noqa: E402
from repro_torch.launch.fleet import ServeFleet  # noqa: E402

PS = 4
ENGINE = dict(slots=2, prompt_len=8, gen=8, chunk=4)


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
    np_params = jax.tree_util.tree_map(np.asarray, params)
    model = tserve.load_model("pimref-100m", smoke=True, seed=0,
                              device="cpu", cfg=tcfg, params=np_params)
    return dict(jcfg=jcfg, tcfg=tcfg, plan=plan, jm=jm, params=params,
                np_params=np_params, model=model)


def _engine(ref, page_size=PS):
    return tserve.make_queue_engine(model=ref["model"], page_size=page_size,
                                    device="cpu", **ENGINE)


def _requests(n, prompt_len=8, max_new=8, seed=0, cls=Request):
    """Mixed prompt lengths (the ROADMAP's mixed queue)."""
    cfg = tconfigs.get_config("pimref-100m", smoke=True)
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        ln = int(rng.integers(3, prompt_len + 1))
        reqs.append(cls(
            uid=i, tokens=rng.integers(1, cfg.vocab_size, ln).astype(np.int32),
            max_new_tokens=max_new))
    return reqs


def _fleet(ref, shards=2, chaos=None, page_size=PS, **fleet_kw):
    return ServeFleet(lambda sid: _engine(ref, page_size), shards=shards,
                      chaos=chaos, **fleet_kw)


def _assert_exactly_one_each(fleet, n):
    uids = sorted(c.uid for c in fleet.completions)
    assert uids == list(range(n)), uids


def _assert_identical(fleet, ref_by_uid):
    checked = 0
    for c in fleet.completions:
        if c.finish_reason == "error":
            continue
        assert np.asarray(c.tokens).tolist() == \
            np.asarray(ref_by_uid[c.uid].tokens).tolist(), c.uid
        checked += 1
    return checked


def _drain(eng, n=6):
    eng.run(_requests(n))
    return {c.uid: c for c in eng.completions}


@pytest.fixture(scope="module")
def ref_paged(ref):
    """One port engine's paged drain of the standard queue (the oracle of
    every fleet drain), held equal to the reference engine's."""
    want = _drain(_engine(ref))
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_KV_PAGES", str(PS))
    mp.delenv("REPRO_KV_QUANT", raising=False)
    mp.delenv("REPRO_SPEC_DECODE", raising=False)
    try:
        jeng = JServeEngine(ref["jm"], ref["params"], ref["plan"],
                            slots=2, prompt_len=8, max_new=8, chunk=4)
        jeng.run(_requests(6, cls=JRequest))
    finally:
        mp.undo()
    assert jeng.paged
    assert {c.uid: (c.finish_reason, np.asarray(c.tokens).tolist())
            for c in jeng.completions} == \
        {u: (c.finish_reason, c.tokens.tolist()) for u, c in want.items()}
    return want


# ---------------------------------------------------------------------------
# Control plane units (no engine builds)
# ---------------------------------------------------------------------------
def test_health_monitor_escalation_and_sticky_death():
    logs = []
    for cls in (HealthMonitor, JHealthMonitor):
        m = cls(2, miss_suspect=2, miss_dead=4)
        assert m.state(0) == "live" and m.live_shards == [0, 1]
        assert m.miss(0, 0) == "live"
        assert m.miss(0, 1) == "suspect"
        assert m.beat(0, 2) == "live"
        assert m.recoveries == 1 and m.suspects == 1
        for step in range(4):
            m.miss(0, 3 + step)
        assert m.state(0) == "dead" and m.deaths == 1
        assert m.beat(0, 9) == "dead"                # zombies stay dead
        assert m.dead_shards == [0] and m.live_shards == [1]
        assert m.mark_dead(0, 10, "again") == "dead"
        assert m.deaths == 1                         # idempotent
        logs.append(m.events)
    assert [e["kind"] for e in logs[0]] == ["suspect", "recover", "suspect",
                                            "dead"]
    assert logs[0] == logs[1]                        # the reference's ledger
    assert HealthMonitor(1).state(0) is ShardState.LIVE


def test_dispatcher_least_loaded_with_reservation_tiebreak():
    routes = []
    for disp, mon_cls in ((Dispatcher, HealthMonitor),
                          (JDispatcher, JHealthMonitor)):
        mon = mon_cls(3)
        d = disp(mon)
        r = [d.route()]                              # all idle: lowest sid
        d.assign(10, 0)
        r.append(d.route())
        d.assign(11, 1)
        d.note_reserved(2, 7)
        d.assign(12, 2)
        d.note_reserved(0, 3)
        d.note_reserved(1, 5)
        r += [d.route(), d.route(exclude={0})]       # fewest reserved pages
        mon.states[0] = type(mon.states[0])("suspect")
        r.append(d.route())                          # suspect: no new work
        mon.states[1] = mon.states[2] = type(mon.states[0])("dead")
        r.append(d.route())                          # only suspect left
        mon.states[0] = type(mon.states[0])("dead")
        r.append(d.route())                          # fleet dead
        r.append(d.fail_shard(1))
        r.append(d.outstanding)
        d.complete(10)
        r += [d.outstanding, d.home(12)]
        routes.append(r)
    assert routes[0] == [0, 1, 0, 1, 1, 0, None, [11], 2, 1, 2]
    assert routes[0] == routes[1]


def test_shard_chaos_parse_seeding_and_fire_once():
    cfg = ShardChaosConfig.parse("kill=1@2, stall=0@4,drop=1@3x2", seed=5)
    assert cfg.kill_targets == {1: 2} and cfg.stall_targets == {0: 4}
    assert cfg.drop_targets == {1: (3, 2)} and cfg.armed and cfg.seed == 5
    with pytest.raises(ValueError, match="unknown shard fault"):
        ShardChaosConfig.parse("explode=1@2")
    assert not ShardChaosConfig().armed
    mk = ShardChaosMonkey(cfg, 2)
    assert mk.directive(1, 2)["kind"] == "kill"
    assert mk.directive(1, 2) is None                # fire-once
    assert mk.directive(0, 4)["steps"] == cfg.stall_steps
    assert mk.directive(1, 3)["beats"] == 2
    assert [e["kind"] for e in mk.events] == ["kill", "stall", "drop"]
    seeded = ShardChaosMonkey(ShardChaosConfig.parse("kills=1,seed=3"), 4)
    again = ShardChaosMonkey(ShardChaosConfig.parse("kills=1,seed=3"), 4)
    assert seeded._plan == again._plan and len(seeded._plan) == 1


def test_restart_manifest_save_is_atomic(tmp_path, monkeypatch):
    """A crash mid-save leaves the previous manifest and no tmp file."""
    path = str(tmp_path / "manifest.json")
    RestartManifest(step=1, checkpoint_dir="", mesh_shape=[1],
                    mesh_axes=["data"], data_seed=0).save(path)
    assert RestartManifest.load(path).step == 1

    def torn_dump(obj, f, *a, **kw):
        f.write('{"step": 999, "torn":')
        raise RuntimeError("killed mid-save")

    monkeypatch.setattr(ft.json, "dump", torn_dump)
    with pytest.raises(RuntimeError, match="killed mid-save"):
        RestartManifest(step=2, checkpoint_dir="", mesh_shape=[1],
                        mesh_axes=["data"], data_seed=0).save(path)
    monkeypatch.undo()
    assert RestartManifest.load(path).step == 1
    assert os.listdir(tmp_path) == ["manifest.json"]


# ---------------------------------------------------------------------------
# In-process fleet: identity, failover, health transitions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shards", [2, 1])
def test_fleet_drains_byte_identical_to_one_engine(ref, ref_paged, shards):
    fleet = _fleet(ref, shards=shards)
    fleet.run(_requests(6))
    _assert_exactly_one_each(fleet, 6)
    assert _assert_identical(fleet, ref_paged) == 6
    assert fleet.stats["failovers"] == 0
    assert fleet.stats["error_completions"] == 0
    if shards == 2:                                  # both shards served
        per = fleet.per_shard_stats()
        assert all(r["tokens_out"] > 0 for r in per)
        assert sum(r["tokens_out"] for r in per) == fleet.stats["tokens_out"]


@pytest.mark.parametrize("page_size", [0, PS])
def test_shard_kill_mid_drain_fails_over_exactly_once(ref, ref_paged,
                                                      tmp_path, page_size):
    """A kill at step 1: every request completes once, byte-identical to
    an undisturbed drain (the victim's in-flight requests regenerate on the
    survivor); the per-shard manifests land on disk."""
    want = ref_paged if page_size else _drain(_engine(ref, 0))
    fleet = _fleet(ref, chaos=ShardChaosConfig.parse("kill=1@1"),
                   page_size=page_size, manifest_dir=str(tmp_path))
    fleet.run(_requests(6))
    _assert_exactly_one_each(fleet, 6)
    assert fleet.stats["failovers"] == 1 and fleet.stats["replays"] >= 1
    assert fleet.stats["shard_lost"] == 0
    assert fleet.monitor.state(1) is ShardState.DEAD
    assert _assert_identical(fleet, want) == 6
    man = RestartManifest.load(str(tmp_path / "shard0.json"))
    assert man.shape == "fleet-shard0" and man.serve is not None
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_stalled_shard_escalates_miss_suspect_dead_then_fails_over(
        ref, ref_paged):
    fleet = _fleet(ref, chaos=ShardChaosConfig.parse("stall=1@1"),
                   miss_suspect=2, miss_dead=3)
    fleet.run(_requests(6))
    _assert_exactly_one_each(fleet, 6)
    assert fleet.monitor.state(1) is ShardState.DEAD
    assert fleet.monitor.suspects == 1 and fleet.stats["failovers"] == 1
    assert [e["kind"] for e in fleet.monitor.events] == ["suspect", "dead"]
    assert fleet.stats["heartbeat_misses"] >= 3
    assert _assert_identical(fleet, ref_paged) == 6


def test_dropped_heartbeats_suspect_then_recover_without_failover(
        ref, ref_paged):
    fleet = _fleet(ref, chaos=ShardChaosConfig.parse("drop=1@1x2"),
                   miss_suspect=2, miss_dead=6)
    fleet.run(_requests(6))
    _assert_exactly_one_each(fleet, 6)
    assert fleet.stats["failovers"] == 0
    assert fleet.monitor.suspects == 1 and fleet.monitor.recoveries == 1
    assert fleet.monitor.state(1) is ShardState.LIVE
    assert _assert_identical(fleet, ref_paged) == 6


def test_whole_fleet_dead_yields_typed_shard_lost(ref):
    """No survivor: outstanding requests end ``shard_lost`` with the
    partial tokens of the last checkpoint, and later submissions too."""
    fleet = _fleet(ref, shards=1, chaos=ShardChaosConfig.parse("kill=0@1"))
    fleet.run(_requests(3))
    _assert_exactly_one_each(fleet, 3)
    comps = {c.uid: c for c in fleet.completions}
    assert all(c.reason == "shard_lost" for c in comps.values())
    # the two slot-resident requests got one chunk (step 0) checkpointed
    assert sorted(len(c.tokens) for c in comps.values()) == [0, 4, 4]
    assert fleet.stats["shard_lost"] == 3
    assert not fleet.submit(Request(uid=99, tokens=np.arange(
        1, 5, dtype=np.int32), max_new_tokens=4))
    late = [c for c in fleet.completions if c.uid == 99]
    assert len(late) == 1 and late[0].reason == "shard_lost"


# ---------------------------------------------------------------------------
# Spawned workers (one case on the CPU)
# ---------------------------------------------------------------------------
def test_mp_two_shard_fleet_drains_byte_identical(ref, ref_paged,
                                                  monkeypatch):
    """Two spawned workers, each building its engine from the same weights
    on the device named (the CPU here), drain the mixed queue byte-identical
    to one engine, both serving."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    fleet = tserve.make_fleet(shards=2, backend="mp", device="cpu",
                              cfg=ref["tcfg"], params=ref["np_params"],
                              page_size=PS, **ENGINE)
    try:
        assert [sh.info["device"] for sh in fleet.shards] == ["cpu", "cpu"]
        assert len({sh.info["pid"] for sh in fleet.shards}) == 2
        assert len(fleet.stats["worker_startup_seconds"]) == 2
        fleet.run(_requests(6))
        _assert_exactly_one_each(fleet, 6)
        assert _assert_identical(fleet, ref_paged) == 6
        assert all(r["tokens_out"] > 0 for r in fleet.per_shard_stats())
    finally:
        fleet.close()
    assert not any(sh.proc.is_alive() for sh in fleet.shards)


def test_serve_cli_fleet_verify_after_a_kill(tmp_path):
    """``--shards 2 --fleet-chaos kill=1@2 --fleet-verify`` (in process):
    one completion per request, byte-identical to one engine's drain, and
    the per-shard manifests written under ``--manifest-dir``."""
    import subprocess
    import sys
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--mode", "queue", "--smoke", "--slots", "2", "--requests", "6",
         "--prompt-len", "16", "--gen", "8", "--chunk", "4",
         "--kv-page-size", "8", "--shards", "2", "--fleet-chaos", "kill=1@2",
         "--fleet-verify", "--manifest-dir", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
                 OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "fleet-verify: 6/6 surviving completions byte-identical" \
        in res.stdout and "1 failovers" in res.stdout
    assert sorted(os.listdir(tmp_path)) == ["shard0.json", "shard1.json"]
