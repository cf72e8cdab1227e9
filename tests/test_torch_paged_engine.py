"""The port's serving engine over the paged and the quantized KV caches
against the JAX ``ServeEngine`` with the same weights, in fp32 on the CPU:
the page allocator, prefix sharing, copy-on-write on a ring wrap, page
reuse, the ``page_pool`` rejection and the HBM accounting. Completions must
be byte-identical."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.core.mimdram import plan_sharding, use_plan  # noqa: E402
from repro.launch.engine import Request as JRequest  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.models import build_model, init_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.engine import Request  # noqa: E402

KNOBS = ("REPRO_KV_PAGES", "REPRO_KV_QUANT", "REPRO_SPEC_DECODE")
PS = 4
# both engines' straggler watchdog off (a threshold no chunk reaches): a
# loaded host's slow chunks would halve the chunk and move the statistics
# these tests hold equal (ROADMAP §C)
NO_WATCHDOG = dict(straggler_threshold=1e9)
STATS = ("prefills", "prefix_hits", "kv_pages_peak", "kv_pages_in_use",
         "kv_hbm_bytes_peak", "kv_bytes_per_token", "tokens_out",
         "decode_dispatches", "error_completions", "admission_blocked")


@pytest.fixture(scope="module")
def ref():
    jcfg = get_config("pimref-100m", smoke=True).replace(
        compute_dtype="float32")
    tcfg = tconfigs.get_config("pimref-100m", smoke=True).replace(
        compute_dtype="float32")
    plan = plan_sharding(jcfg, ShapeConfig("serve", 32, 4, "decode"), None)
    jm = build_model(jcfg)
    with use_plan(plan):
        params = init_params(jm.param_specs(), jax.random.PRNGKey(0))
    return dict(jcfg=jcfg, tcfg=tcfg, plan=plan, jm=jm, params=params,
                np_params=jax.tree_util.tree_map(np.asarray, params))


@pytest.fixture
def layout(monkeypatch):
    """Sets the reference's knobs; returns the port's explicit arguments."""
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)

    def set_layout(kv_quant="off", pages=PS):
        monkeypatch.setenv("REPRO_KV_QUANT", kv_quant)
        monkeypatch.setenv("REPRO_KV_PAGES", str(pages))
        return dict(kv_quant=kv_quant, page_size=pages)
    return set_layout


def _engines(ref, lay, **kw):
    """(reference engine, port engine) over one layout and bucket, both
    with the watchdog off."""
    jeng = JServeEngine(ref["jm"], ref["params"], ref["plan"], **kw,
                        **NO_WATCHDOG)
    teng = tserve.make_queue_engine(
        slots=kw["slots"], prompt_len=kw["prompt_len"], gen=kw["max_new"],
        chunk=kw["chunk"], page_pool_pages=kw.get("page_pool_pages"),
        device="cpu", cfg=ref["tcfg"], params=ref["np_params"], **lay,
        **NO_WATCHDOG)
    assert teng.paged == jeng.paged == (lay["page_size"] > 0)
    return jeng, teng


def _drain_both(jeng, teng, prompts, max_new):
    caps = ([max_new] * len(prompts) if isinstance(max_new, int)
            else max_new)
    jc = {c.uid: c for c in jeng.run(
        [JRequest(uid=i, tokens=p, max_new_tokens=n)
         for i, (p, n) in enumerate(zip(prompts, caps))])}
    tc = {c.uid: c for c in teng.run(
        [Request(uid=i, tokens=p, max_new_tokens=n)
         for i, (p, n) in enumerate(zip(prompts, caps))])}
    assert sorted(tc) == sorted(jc) == list(range(len(prompts)))
    for uid in jc:
        assert (tc[uid].finish_reason, tc[uid].reason) == \
            (jc[uid].finish_reason, jc[uid].reason), uid
        np.testing.assert_array_equal(tc[uid].tokens, jc[uid].tokens)
    return jc, tc


def _check_drained(eng):
    """Every page back on the free list, no registration, tables on the
    trash page."""
    assert eng.stats["kv_pages_in_use"] == 0 and eng._alloc.used == 0
    assert not eng._alloc.registry
    assert sorted(eng._alloc.free) == list(range(1, eng.n_phys_pages))
    assert not eng._host_table.any()
    assert not eng.cache["k"].table.any() and not eng.cache["v"].table.any()


@pytest.mark.parametrize("kv_quant,pages", [("off", PS), ("int8", PS),
                                            ("int8", 0)])
def test_mixed_queue_with_shared_prefix(ref, layout, kv_quant, pages):
    """tests/test_paged_kv.py's mixed queue (4x prompt-length spread, two
    concurrent prompts sharing a page), paged, paged int8 and contiguous
    int8: completions and the page and HBM accounting equal the
    reference's."""
    lay = layout(kv_quant, pages)
    prompt_len, max_new, chunk, slots = 8, 10, 4, 2
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, ref["jcfg"].vocab_size, size=n).astype(np.int32)
               for n in [8, 8, 2, 3, 2, 5]]
    prompts[1][:PS] = prompts[0][:PS]
    jeng, teng = _engines(ref, lay, slots=slots, prompt_len=prompt_len,
                          max_new=max_new, chunk=chunk)
    _drain_both(jeng, teng, prompts, max_new)
    for key in STATS:
        assert teng.stats[key] == jeng.stats[key], key
    if pages:
        assert teng.stats["prefix_hits"] > 0
        assert 0 < teng.stats["kv_pages_peak"] < slots * teng.n_logical_pages
        _check_drained(teng)


def test_synth_queue_with_shared_prefix_matches_reference(ref, layout):
    """serve_queue's request stream with a shared prefix (the reference's
    rng stream), paged int8: the README's kind of queue."""
    from repro.launch.serve import synth_requests as jsynth
    lay = layout("int8", PS)
    kw = dict(requests=6, prompt_len=12, gen=6, seed=2, shared_prefix=PS)
    want = jsynth("pimref-100m", **kw)
    got = tserve.synth_requests("pimref-100m", **kw)
    for a, b in zip(got, want):
        assert (a.uid, a.max_new_tokens) == (b.uid, b.max_new_tokens)
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert all((r.tokens[:PS] == got[0].tokens[:PS]).all() for r in got)
    jeng, teng = _engines(ref, lay, slots=3, prompt_len=12, max_new=6,
                          chunk=3)
    jc = {c.uid: c for c in jeng.run(want)}
    tc = {c.uid: c for c in teng.run(got)}
    for uid in jc:
        np.testing.assert_array_equal(tc[uid].tokens, jc[uid].tokens)
    assert teng.stats["prefix_hits"] == jeng.stats["prefix_hits"] > 0
    assert teng.stats["kv_bytes_per_token"] == jeng.stats["kv_bytes_per_token"]
    _check_drained(teng)


def test_cow_on_ring_wrap(ref, layout):
    """Two slots share a prefix page, then one ring-wraps into it within
    its over-run chunk: copy-on-write forks the page so the other slot's
    completion still equals the reference's (tests/test_paged_kv.py)."""
    lay = layout("off", PS)
    prompt_len, max_new, chunk = 8, 4, 8         # T = 12: wraps in chunk 1
    rng = np.random.default_rng(4)
    base = rng.integers(1, ref["jcfg"].vocab_size,
                        size=prompt_len).astype(np.int32)
    other = base.copy()
    other[PS:] = rng.integers(1, ref["jcfg"].vocab_size, size=prompt_len - PS)
    jeng, teng = _engines(ref, lay, slots=2, prompt_len=prompt_len,
                          max_new=max_new, chunk=chunk)
    forks = []
    alloc = teng._alloc.alloc
    teng._alloc.alloc = lambda what="alloc": forks.append(what) or alloc(what)
    _drain_both(jeng, teng, [base, other], max_new)
    assert "copy-on-write" in forks
    assert teng.stats["prefix_hits"] == jeng.stats["prefix_hits"] > 0
    _check_drained(teng)


def test_pages_freed_and_reused(ref, layout):
    """One slot, three requests: each admission reuses the pages the last
    retirement freed, and the retired slot's table row is the trash page."""
    lay = layout("off", PS)
    eng = tserve.make_queue_engine(slots=1, prompt_len=8, gen=6, chunk=3,
                                   device="cpu", cfg=ref["tcfg"],
                                   params=ref["np_params"], **lay)
    rng = np.random.default_rng(5)
    rows = []
    retire = eng._retire

    def spy(slot, *a, **k):
        rows.append(eng._host_table[slot].copy())
        retire(slot, *a, **k)
        assert not eng.cache["k"].table[:, slot].any()
    eng._retire = spy
    eng.run([Request(uid=i, tokens=rng.integers(
        1, ref["tcfg"].vocab_size, 6).astype(np.int32), max_new_tokens=6)
        for i in range(3)])
    assert len(eng.completions) == 3
    # the free list is LIFO: the same pool rows come back in another order
    assert all(sorted(r) == sorted(rows[0]) for r in rows) and rows[0].all()
    _check_drained(eng)


def test_page_pool_rejects_what_never_fits(ref, layout):
    """A pool smaller than one request's worst case rejects it with a
    page_pool error; one that fits a single request at a time blocks
    admission until a retirement frees pages. Both as the reference."""
    lay = layout("off", PS)
    prompt_len, max_new = 8, 8
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, ref["jcfg"].vocab_size, size=n).astype(np.int32)
               for n in (8, 2, 3, 2)]
    caps = [8, 2, 3, 2]
    # worst case: prompt + cap - 1 + one chunk of over-run, in pages of 4:
    # 4 pages for the first request (> the pool's 3), then 2, 3 and 2
    jeng, teng = _engines(ref, lay, slots=2, prompt_len=prompt_len,
                          max_new=max_new, chunk=4, page_pool_pages=3)
    jc, tc = _drain_both(jeng, teng, prompts, caps)
    assert tc[0].reason == "page_pool" and len(tc[0].tokens) == 0
    assert "pool holds 3" in tc[0].error
    assert [tc[i].finish_reason for i in (1, 2, 3)] == ["length"] * 3
    assert teng.stats["admission_blocked"] == jeng.stats["admission_blocked"] > 0
    _check_drained(teng)


def test_over_long_prompt_paged(ref, layout):
    """An over-long prompt retires with an explicit error, never a silent
    truncation, and the paged engine drains on."""
    lay = layout("int8", PS)
    jeng, teng = _engines(ref, lay, slots=2, prompt_len=8, max_new=4, chunk=4)
    prompts = [np.arange(1, 11, dtype=np.int32), np.arange(1, 5, dtype=np.int32)]
    jc, tc = _drain_both(jeng, teng, prompts, 4)
    assert tc[0].reason == "prompt_too_long" and len(tc[0].tokens) == 0
    assert tc[1].finish_reason == "length" and len(tc[1].tokens) == 4
    _check_drained(teng)


@pytest.mark.parametrize("cell,kv_quant,pages", [
    ("mixed_queue", "off", 0), ("mixed_queue_paged_ps8", "off", 8),
    ("mixed_queue_paged_ps8_kvq8", "int8", 8)])
def test_kv_bytes_per_token_reproduces_bench_serve(cell, kv_quant, pages):
    """The KV bytes per served token of benchmarks/bench_serve.py's mixed
    queue (the figures README.md quotes from BENCH_serve.json) are a count
    of pages and bytes, so the port's engine reproduces them exactly."""
    import json
    import os
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    with open(os.path.join(root, "BENCH_serve.json")) as f:
        want = json.load(f)["kv_bytes_per_token"][f"engine/{cell}"]
    eng = tserve.serve_queue(slots=4, requests=8, prompt_len=16, gen=16,
                             chunk=4, shared_prefix=8, kv_quant=kv_quant,
                             page_size=pages, device="cpu")
    assert round(eng.stats["kv_bytes_per_token"], 1) == want
