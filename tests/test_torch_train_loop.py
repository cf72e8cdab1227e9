"""The port's train loop (repro_torch.launch.train), checkpoints and train
chaos against the mesh-less JAX reference on the CPU: ``train()`` losses,
chaos plans, spike rollback, supervisor restarts, a torn checkpoint falling
back, checkpoints read across the two packages, and the bitwise
resume-identity gate of the port against itself."""
import dataclasses
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.checkpoint import CheckpointManager, load_checkpoint  # noqa: E402
from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.configs.base import RunConfig  # noqa: E402
from repro.core.mimdram import plan_sharding, use_plan  # noqa: E402
from repro.distributed import TrainChaosConfig, TrainChaosMonkey  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model, init_params  # noqa: E402
from repro.optim import make_optimizer  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import distributed as tdist  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

# fp32 losses through a few steps of the smoke model at the default
# learning rate (warm-up 100, so the weights move little): the loss of a
# step within 1e-5 relative, as for one step
LOSS_RTOL = 1e-5
STEPS, BATCH, SEQ = 6, 2, 16


@pytest.fixture(autouse=True)
def _fp32_smoke(monkeypatch):
    """Both packages train the fp32-compute smoke config (bf16 agreement
    depends on each framework's rounding)."""
    monkeypatch.delenv("REPRO_CHAOS", raising=False)
    jcfg = get_config("pimref-100m", smoke=True).replace(
        compute_dtype="float32")
    tcfg = tconfigs.get_config("pimref-100m", smoke=True).replace(
        compute_dtype="float32")
    monkeypatch.setattr(jtrain, "get_config", lambda arch, smoke=True: jcfg)
    monkeypatch.setattr(ttrain, "get_config", lambda arch, smoke=True: tcfg)


def _ref_init(seed=0):
    """The reference train()'s initial parameters, as numpy."""
    jcfg = jtrain.get_config("pimref-100m")
    plan = plan_sharding(jcfg, ShapeConfig("custom", SEQ, BATCH, "train"),
                         None)
    with use_plan(plan):
        p = init_params(build_model(jcfg).param_specs(),
                        jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, p)


def _runs(**kw):
    return RunConfig(total_steps=STEPS, microbatches=1, **kw), \
        tconfigs.RunConfig(total_steps=STEPS, microbatches=1, **kw)


def _common(**kw):
    return dict(smoke=True, batch=BATCH, seq=SEQ, log_every=100, **kw)


def test_chaos_plans_equal_reference():
    cfgs = [dict(seed=7, nan=2, slow=1, spike=1, crash=1, ckpt_fail=1,
                 torn=1, preempt=5), dict(seed=3, nan=3, window=4),
            dict(seed=11, spike=2, crash=2, after_step=3, window=20)]
    for kw in cfgs:
        for total in (6, 12, 40):
            j = TrainChaosMonkey(TrainChaosConfig(**kw), total_steps=total)
            t = tdist.TrainChaosMonkey(tdist.TrainChaosConfig(**kw),
                                       total_steps=total)
            for name in ("nan_steps", "slow_steps", "spike_steps",
                         "crash_steps", "_ckpt_fail", "_torn"):
                assert getattr(t, name) == getattr(j, name), (kw, name)
    spec = "nan=2,slow=1,spike=1,preempt=11,slow_ms=3.5"
    assert dataclasses.asdict(tdist.TrainChaosConfig.parse(spec, seed=4)) == \
        dataclasses.asdict(TrainChaosConfig.parse(spec, seed=4))


def test_train_losses_match_reference(tmp_path):
    jrun, trun = _runs(checkpoint_every=4)
    want = jtrain.train("pimref-100m", steps=STEPS, run=jrun, use_mesh=False,
                        checkpoint_dir=str(tmp_path / "j"), **_common())
    got = ttrain.train("pimref-100m", steps=STEPS, run=trun, device="cpu",
                       params=_ref_init(), checkpoint_dir=str(tmp_path / "t"),
                       **_common())
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    for k in ("first_step", "resumed_at", "preempted", "skipped_steps",
              "rollbacks", "anomalies", "ckpt_failures", "chaos_events"):
        assert got[k] == want[k], k
    # the same checkpoints, with the same loop state
    jm = CheckpointManager(str(tmp_path / "j"))
    tm = tckpt.CheckpointManager(str(tmp_path / "t"))
    assert tm.all_steps() == jm.all_steps() == [4, 6]
    for s in (4, 6):
        a, b = jm.load_extra(s), tm.load_extra(s)
        a["loop"].pop("loss_ewma"), b["loop"].pop("loss_ewma")
        np.testing.assert_allclose(b.pop("loss"), a.pop("loss"),
                                   rtol=LOSS_RTOL)
        assert a == b
    assert sorted(os.listdir(tmp_path / "j" / "step_00000006")) == \
        sorted(os.listdir(tmp_path / "t" / "step_00000006"))


def test_checkpoints_cross_read(tmp_path):
    """A checkpoint the reference writes restores in the port and the port's
    in the reference, leaf for leaf, bit for bit; the port resumes the
    reference's run."""
    jrun, trun = _runs(checkpoint_every=3)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jtrain.train("pimref-100m", steps=3, run=jrun, use_mesh=False,
                 checkpoint_dir=jdir, **_common())
    jp = _ref_init()
    jtemplate = {"params": jp, "opt": make_optimizer("adamw", jrun).init(jp)}
    want = load_checkpoint(os.path.join(jdir, "step_00000003"), jtemplate)
    # reference -> port
    tp = ttrain.initial_params(tconfigs.get_config("pimref-100m", smoke=True),
                               0, "cpu")
    from repro_torch.optim import make_optimizer as tmake
    ttemplate = {"params": tp, "opt": tmake("adamw", trun).init(tp)}
    step, got = tckpt.CheckpointManager(jdir).restore(ttemplate)
    assert step == 3
    wl = jax.tree_util.tree_leaves(want)
    assert len(leaves(got)) == len(wl)
    for a, b in zip(leaves(got), wl):
        assert a.dtype == np.asarray(b).dtype
        assert a.tobytes() == np.asarray(b).tobytes()
    # port -> reference
    tm = tckpt.CheckpointManager(tdir)
    tm.save(5, tree_map(torch.from_numpy, got), extra={"loop": {"step": 5}},
            block=True)
    back = load_checkpoint(os.path.join(tdir, "step_00000005"), jtemplate)
    for a, b in zip(jax.tree_util.tree_leaves(back), wl):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # the port resumes the reference's run; the reference runs on
    got = ttrain.train("pimref-100m", steps=STEPS, run=trun, device="cpu",
                       checkpoint_dir=jdir, resume=True, **_common())
    ref = jtrain.train("pimref-100m", steps=STEPS, run=jrun, use_mesh=False,
                       **_common())
    assert got["resumed_at"] == 3
    np.testing.assert_allclose(got["losses"], ref["losses"][3:],
                               rtol=LOSS_RTOL)


def _events(out):
    return [{k: v for k, v in e.items() if k != "ms"}
            for e in out["chaos_events"]]


@pytest.mark.parametrize("fault", ["spike", "crash_torn"])
def test_faults_handled_as_reference(tmp_path, fault):
    """A loss spike rolls back to the last checkpoint and re-seeds the data;
    a crash restarts the supervisor; a torn checkpoint falls back to the
    one before: the same events, counters and losses as the reference."""
    if fault == "spike":
        kw = dict(seed=1, spike_steps=[4], nan_steps=[2])
    else:
        # the checkpoint of step 4 is torn after its preemption save, the
        # attempt after restarts from step 2; a crash at step 5 restarts
        # the second attempt from step 4's successor
        kw = dict(seed=1, torn_steps=[4], crash_steps=[5], preempt=3)
    jrun, trun = _runs(checkpoint_every=2)
    common = _common(spike_warmup=2, run=None)
    common.pop("run")
    jsup = jtrain.TrainSupervisor(
        "pimref-100m", checkpoint_dir=str(tmp_path / "j"), steps=STEPS,
        max_restarts=3, chaos=TrainChaosConfig(**kw), use_mesh=False,
        run=jrun, **common)
    tsup = ttrain.TrainSupervisor(
        "pimref-100m", checkpoint_dir=str(tmp_path / "t"), steps=STEPS,
        max_restarts=3, chaos=tdist.TrainChaosConfig(**kw), device="cpu",
        params=_ref_init(), run=trun, **common)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jsup.run()
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tsup.run()
    jmsg = [str(w.message).split(" (")[0] for w in jw
            if "checkpoint" in str(w.message)]
    tmsg = [str(w.message).split(" (")[0] for w in tw
            if "checkpoint" in str(w.message)]
    assert tmsg == jmsg
    assert bool(tmsg) == (fault == "crash_torn"), tmsg
    assert _events(got) == _events(want)
    for k in ("restarts", "skipped_steps", "rollbacks", "anomalies",
              "ckpt_failures", "first_step", "preempted"):
        assert got[k] == want[k], k
    assert [a.get("error", "").split("(")[0] for a in tsup.attempts] == \
        [a.get("error", "").split("(")[0] for a in jsup.attempts]
    np.testing.assert_allclose(got["losses_full"], want["losses_full"],
                               rtol=LOSS_RTOL)
    if fault == "spike":
        assert got["rollbacks"] == 1 and got["skipped_steps"] >= 1
    else:
        assert got["restarts"] == 2


def test_resume_identity_port(tmp_path):
    """An interrupted (preempted, crashed, NaN-poisoned) supervised run of
    the port equals its uninterrupted run byte for byte."""
    _, trun = _runs(checkpoint_every=2)
    # preempted after step 2 (saved at 3); the next attempt crashes before
    # its first step (a crashed attempt's losses are not stitched, as in
    # the reference); NaN gradients at a step of the seed's plan
    chaos = tdist.TrainChaosConfig(seed=5, nan=1, crash_steps=[3],
                                   preempt=2)
    res = ttrain.verify_resume_identity(
        "pimref-100m", steps=STEPS, work_dir=str(tmp_path), chaos=chaos,
        max_restarts=3, device="cpu", run=trun, **_common())
    assert res["identical"], res
    assert res["restarts"] == 2 and res["skipped_steps"] == 1


def test_diverged_run_raises(tmp_path):
    _, trun = _runs()
    chaos = tdist.TrainChaosConfig(nan_steps=[1, 2, 3])
    with pytest.raises(ttrain.TrainDivergedError):
        ttrain.train("pimref-100m", steps=STEPS, run=trun, device="cpu",
                     chaos=chaos, max_bad_steps=3, **_common())


def test_cli_mirrors_reference_flags(monkeypatch):
    """The port's CLI has the reference's flags and defaults, less
    ``--attn-impl`` / ``--kv-quant``, plus ``--device`` (cuda by
    default)."""
    import argparse
    import sys

    class Parsed(Exception):
        pass

    seen = {}

    def grab(self, *a, **k):
        seen.clear()
        seen.update({act.dest: (tuple(act.option_strings), act.default)
                     for act in self._actions})
        raise Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    monkeypatch.setattr(sys, "argv", ["train"])
    flags = {}
    for name, mod in (("ref", jtrain), ("port", ttrain)):
        with pytest.raises(Parsed):
            mod.main()
        flags[name] = dict(seen)
    j, t = flags["ref"], flags["port"]
    for dest in ("attn_impl", "kv_quant"):
        j.pop(dest)
    assert t.pop("device") == (("--device",), "cuda")
    assert t == j
