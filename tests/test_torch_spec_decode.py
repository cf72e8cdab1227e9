"""Speculative decoding in the port (``repro_torch.launch``: ``spec_config``,
``ngram_draft``, the spec chunk of ``make_generate_step``, ``ServeEngine``
and ``serve()``) against the JAX reference with the same weights, in fp32 on
the CPU at smoke size: the drafter's integers, the gates, every output of
the spec chunk in the six KV layouts (``ngram`` and ``draft``, k 3), greedy
tokens with speculation on and off, EOS inside a verify block, a NaN slot,
the engine's completions and accepted-length histogram, and the sampled
masks. Integers are held exact. The chunk's CUDA graph runs on the card:
``tests/test_torch_graph_cuda.py``."""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.core.mimdram import plan_sharding, use_plan  # noqa: E402
from repro.distributed.chaos import nan_logits_hook  # noqa: E402
from repro.kernels import common as jcommon  # noqa: E402
from repro.launch.engine import Request as JRequest  # noqa: E402
from repro.launch.engine import ServeEngine as JServeEngine  # noqa: E402
from repro.launch.steps import make_generate_step as jmake  # noqa: E402
from repro.launch.steps import ngram_draft as jngram  # noqa: E402
from repro.launch.steps import spec_config as jspec_config  # noqa: E402
from repro.models import build_model, init_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import common as tcommon  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.engine import Request  # noqa: E402
from repro_torch.launch.steps import (cache_tensors,  # noqa: E402
                                      make_generate_step, ngram_draft,
                                      spec_config, spec_decode_chunk)

KNOBS = ("REPRO_KV_PAGES", "REPRO_KV_QUANT", "REPRO_SPEC_DECODE",
         "REPRO_SPEC_K", "REPRO_SPEC_DRAFT_LAYERS")
PS = 4
K = 3
# both engines' straggler watchdog off (a threshold no chunk reaches): a
# loaded host's slow chunks would shed speculation and move the statistics
# these tests hold equal (ROADMAP §C)
NO_WATCHDOG = dict(straggler_threshold=1e9)
# the six KV layouts: (kv_quant, page_size)
LAYOUTS = [("off", 0), ("int8", 0), ("int4", 0), ("auto", 0), ("off", PS),
           ("int8", PS)]
IDS = [f"{q}-{p}" for q, p in LAYOUTS]
B, P, GEN, CHUNK = 4, 16, 16, 4
SYNCS = ("item", "__bool__", "__int__", "__float__", "__index__", "tolist",
         "numpy", "cpu")


@pytest.fixture(autouse=True)
def _plain_reference(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture
def layout(monkeypatch):
    """Sets the reference's knobs; returns the port's explicit arguments."""
    def set_layout(kv_quant="off", pages=0):
        monkeypatch.setenv("REPRO_KV_QUANT", kv_quant)
        monkeypatch.setenv("REPRO_KV_PAGES", str(pages))
        return dict(kv_quant=kv_quant, page_size=pages)
    return set_layout


@pytest.fixture(scope="module")
def ref():
    """The mesh-less fp32 smoke reference, its weights as numpy arrays."""
    jcfg = get_config("pimref-100m", smoke=True).replace(
        compute_dtype="float32")
    tcfg = tconfigs.get_config("pimref-100m", smoke=True).replace(
        compute_dtype="float32")
    plan = plan_sharding(jcfg, ShapeConfig("serve", 40, B, "decode"), None)
    jm = build_model(jcfg)
    with use_plan(plan):
        params = init_params(jm.param_specs(), jax.random.PRNGKey(0))
    return dict(jcfg=jcfg, tcfg=tcfg, plan=plan, jm=jm, params=params,
                np_params=jax.tree_util.tree_map(np.asarray, params))


def _port(ref, kv_quant="off", page_size=0):
    return tserve.load_model("pimref-100m", smoke=True, seed=0, device="cpu",
                             cfg=ref["tcfg"], params=ref["np_params"],
                             kv_quant=kv_quant, page_size=page_size)


def _prompts(vocab, batch=B, prompt_len=P, seed=0):
    """Half the rows a period-4 tile (the n-gram drafter finds them), half
    random, as the reference's spec tests mix them."""
    rng = np.random.default_rng(seed)
    toks = np.empty((batch, prompt_len), np.int32)
    for r in range(batch):
        if r < batch // 2:
            toks[r] = np.tile(rng.integers(1, vocab, 4), prompt_len // 4)
        else:
            toks[r] = rng.integers(1, vocab, prompt_len)
    return toks


def _hist(toks, gen, chunk, k):
    b, p = toks.shape
    h = np.zeros((b, p + gen + chunk * (k + 1)), np.int32)
    h[:, :p] = toks
    return h, np.full((b,), p, np.int32)


def _eq(t, j, what=""):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j), err_msg=what)


# ---------------------------------------------------------------------------
# the drafter and the gates
# ---------------------------------------------------------------------------
NGRAM_CASES = {
    # t0 7 after hist[8] = 5: the bigram (5, 7) occurs at 1 and 5; the
    # latest, 5, wins and drafts hist[6:8]
    "bigram_latest": ([[5, 7, 2, 9, 5, 7, 4, 1, 5, 0]], [9], [7], 2),
    # a bigram at 1 preferred over a later unigram match at 6
    "bigram_over_unigram": ([[3, 7, 2, 9, 4, 4, 7, 8, 3, 0]], [9], [7], 2),
    # t0 absent: a miss drafts hist[0:k]
    "miss": ([[5, 7, 2, 9, 5, 7, 4, 1, 5, 0]], [9], [6], 3),
    # the continuation runs past hist_len into the zero tail and clips at H
    "past_hist_len": ([[4, 6, 1, 4, 6, 0, 0, 0]], [5], [6], 4),
    # hist_len past the row (a slot running ahead): indices clamp
    "hist_len_past_row": ([[2, 3, 2, 3, 2, 3]], [9], [2], 3),
    "empty": ([[0, 0, 0, 0]], [0], [5], 2),
}


@pytest.mark.parametrize("case", sorted(NGRAM_CASES))
def test_ngram_draft_matches_reference(case):
    """Drafts equal the reference's as integers (exact)."""
    hist, hist_len, t0, k = NGRAM_CASES[case]
    h = np.asarray(hist, np.int32)
    hl = np.asarray(hist_len, np.int32)
    t = np.asarray(t0, np.int32)
    got = ngram_draft(torch.from_numpy(h), torch.from_numpy(hl),
                      torch.from_numpy(t), k)
    want = jngram(jnp.asarray(h), jnp.asarray(hl), jnp.asarray(t), k)
    _eq(got, want, case)
    assert got.dtype == torch.int32 and got.shape == (h.shape[0], k)
    if case == "bigram_over_unigram":
        assert got.tolist() == [[2, 9]]


@pytest.mark.parametrize("b,h,k", [(1, 2, 1), (4, 11, 3), (3, 23, 4)])
def test_ngram_draft_random_histories_match_reference(b, h, k):
    """60 random batches over a 6-token vocabulary (many matches), every
    hist_len from 0 to past the row: exact."""
    rng = np.random.default_rng(h)
    draft = jax.jit(jngram, static_argnums=3)
    for _ in range(60):
        hist = rng.integers(0, 6, (b, h)).astype(np.int32)
        hl = rng.integers(0, h + 4, b).astype(np.int32)
        t0 = rng.integers(0, 6, b).astype(np.int32)
        _eq(ngram_draft(torch.from_numpy(hist), torch.from_numpy(hl),
                        torch.from_numpy(t0), k),
            draft(jnp.asarray(hist), jnp.asarray(hl), jnp.asarray(t0), k))


class _Stub:
    def __init__(self, cfg):
        self.cfg = cfg


def test_spec_config_gates():
    """The reference's gates: off is (off, 0), an unknown mode and k < 1
    raise, k defaults to 3, the hybrid family and sliding attention warn
    and fall back to off; the mode names and defaults are the
    reference's."""
    assert tcommon.SPEC_DECODE_MODES == jcommon.SPEC_DECODE_MODES
    assert tcommon.SPEC_K_DEFAULT == jcommon.spec_draft_len()
    dense = _Stub(tconfigs.get_config("pimref-100m", smoke=True))
    jdense = _Stub(get_config("pimref-100m", smoke=True))
    for mode, k in (("ngram", 3), ("draft", 5), ("off", 3), ("ngram", None)):
        assert spec_config(dense, mode, k) == jspec_config(jdense, mode, k)
    assert spec_config(dense, "ngram") == ("ngram", 3)
    assert spec_config(dense, "off", 3) == ("off", 0)
    with pytest.raises(ValueError, match="spec"):
        spec_config(dense, "bogus", 3)
    with pytest.raises(ValueError, match="spec_k"):
        spec_config(dense, "ngram", 0)
    sliding = _Stub(dense.cfg.replace(attention_kind="sliding",
                                      sliding_window=8))
    with pytest.warns(UserWarning, match="sliding"):
        assert spec_config(sliding, "ngram", 3) == ("off", 0)
    griffin = _Stub(tconfigs.get_config("recurrentgemma-2b", smoke=True))
    with pytest.warns(UserWarning, match="family"):
        assert spec_config(griffin, "draft", 3) == ("off", 0)
    with pytest.raises(ValueError, match="draft_layers"):
        tcommon.check_draft_layers(-1)


def test_generate_step_takes_history_with_speculation_only(ref):
    """A spec step needs hist and hist_len, a plain step refuses them; the
    draft budget defaults to half the layers and is clamped to them."""
    tm = _port(ref)
    toks = torch.from_numpy(_prompts(256))
    logits, cache = tm.prefill(toks, max_len=P + GEN + K)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    with pytest.raises(ValueError, match="required"):
        make_generate_step(tm, chunk=2, spec="ngram", spec_k=K)(
            cache, tok, None, -1)
    with pytest.raises(ValueError, match="not taken"):
        make_generate_step(tm, chunk=2)(cache, tok, None, -1, cache["pos"],
                                        cache["pos"])
    L = tm.cfg.num_layers
    assert make_generate_step(tm, chunk=2, spec="draft",
                              spec_k=K).draft_layers == max(1, L // 2)
    assert make_generate_step(tm, chunk=2, spec="draft", spec_k=K,
                              draft_layers=9).draft_layers == L
    assert make_generate_step(tm, chunk=2, spec="ngram",
                              spec_k=K).span == 2 * (K + 1)


# ---------------------------------------------------------------------------
# the spec chunk against the reference's fused spec step
# ---------------------------------------------------------------------------
def _both(ref, lay, mode, *, eos=-1, chunk=CHUNK, chunks=3, arm=None,
          poison=None, seed=0, hist0=None):
    """Run ``chunks`` spec chunks through the reference's jitted fused step
    and the port's ``make_generate_step`` from the same prompts (and the
    history ``hist0`` in place of the prompts, if given); every output of
    every chunk equal (exact). Returns the port's outputs."""
    jm, params, plan = ref["jm"], ref["params"], ref["plan"]
    tm = _port(ref, **lay)
    toks = _prompts(ref["jcfg"].vocab_size, seed=seed)
    max_len = P + GEN + K
    with use_plan(plan):
        jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                            max_len=max_len)
    tl, tc = tm.prefill(torch.from_numpy(toks), max_len=max_len)
    jtok = jnp.argmax(jl[:, -1:], axis=-1).astype(jnp.int32)
    ttok = torch.argmax(tl[:, -1:], dim=-1).to(torch.int32)
    _eq(ttok, jtok, "first token")
    h, hl = _hist(toks if hist0 is None else hist0, GEN, chunk, K)
    jh, jhl = jnp.asarray(h), jnp.asarray(hl)
    th, thl = torch.from_numpy(h.copy()), torch.from_numpy(hl.copy())
    hook = nan_logits_hook if arm is not None else None
    jgen = jax.jit(jmake(jm, plan, chunk=chunk, spec=mode, spec_k=K,
                         logits_hook=hook))
    step = make_generate_step(tm, chunk=chunk, spec=mode, spec_k=K)
    if poison is not None:
        tm.decode_step = poison(tm.decode_step)
    key = jax.random.PRNGKey(0)
    names = ("tok", "done", "n_valid", "toks", "hist", "hist_len", "acc",
             "failed")
    outs = []
    for c in range(chunks):
        extra = (jnp.asarray(arm, jnp.int32),) if arm is not None else ()
        jo = jgen(params, jc, jtok, key, jnp.int32(eos), jh, jhl, *extra)
        to = step(tc, ttok, None, eos, th, thl)
        assert to[0] is tc and to[6] is th and to[7] is thl
        for name, t, j in zip(names, (to[1],) + to[3:], (jo[1],) + jo[3:]):
            _eq(t, j, f"chunk {c}: {name}")
        _eq(tc["pos"], jo[0]["pos"], f"chunk {c}: pos")
        _eq(tc["pos_ids"], jo[0]["pos_ids"], f"chunk {c}: pos_ids")
        outs.append(tuple(x.clone() for x in to[1:] if torch.is_tensor(x)))
        jc, jtok, key, jh, jhl = jo[0], jo[1], jo[2], jo[6], jo[7]
        ttok = to[1]
    return outs


@pytest.mark.parametrize("mode", ["ngram", "draft"])
@pytest.mark.parametrize("kv_quant,pages", LAYOUTS, ids=IDS)
def test_spec_chunk_matches_reference(ref, layout, mode, kv_quant, pages):
    """Three chunks of 4 draft-verify iterations, k 3, on two periodic and
    two random prompts (the periodic rows run past the cache's positions
    and the history's end): tok, done, n_valid, toks, hist, hist_len, acc,
    failed, pos and pos_ids equal the reference's spec step's, exact."""
    outs = _both(ref, layout(kv_quant, pages), mode)
    acc = torch.cat([o[6] for o in outs], 1)
    assert ((acc >= 1) & (acc <= K + 1)).all()


def _greedy_tokens(tm, toks, spec, gen=GEN, chunk=CHUNK):
    """serve()'s drain through make_generate_step: the first ``gen``
    tokens of every row."""
    k = K if spec != "off" else 0
    logits, cache = tm.prefill(torch.from_numpy(toks),
                               max_len=toks.shape[1] + gen + k)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    step = make_generate_step(tm, chunk=chunk, spec=spec, spec_k=k)
    state = ()
    if spec != "off":
        state = tuple(torch.from_numpy(a) for a in _hist(toks, gen, chunk, k))
    rows = [[] for _ in range(toks.shape[0])]
    while min(len(r) for r in rows) < gen:
        out = step(cache, tok, None, -1, *state)
        tok, n = out[1], out[4] if spec != "off" else None
        for r in range(len(rows)):
            rows[r] += out[5][r, :n[r] if n is not None else None].tolist()
    return np.asarray([r[:gen] for r in rows])


@pytest.mark.parametrize("kv_quant,pages", [l for l in LAYOUTS
                                            if l[0] != "auto"])
def test_spec_on_equals_off(ref, kv_quant, pages):
    """Greedy tokens with speculation on (both drafters) equal those with
    it off, in every layout whose codes are per row (auto picks one grid
    over each whole write, a verify block's rejected drafts included)."""
    tm = _port(ref, kv_quant, pages)
    toks = _prompts(ref["tcfg"].vocab_size, seed=1)
    want = _greedy_tokens(tm, toks, "off")
    for mode in ("ngram", "draft"):
        np.testing.assert_array_equal(_greedy_tokens(tm, toks, mode), want,
                                      err_msg=mode)


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_eos_inside_a_verify_block(ref, layout, mode):
    """An EOS id that a row first commits as a draft inside a multi-token
    block: the block is cut after it, the slot is done and re-feeds it,
    every output as the reference's (exact). The n-gram drafter is handed a
    history that holds each row's greedy continuation (random smoke
    weights rarely repeat a prompt), so its drafts are accepted."""
    lay = layout()
    hist0 = None
    if mode == "ngram":
        outs = _both(ref, lay, mode, chunks=4)
        rows = [sum((o[3][r, :int(o[2][r])].tolist() for o in outs), [])
                for r in range(B)]
        hist0 = np.asarray([row[:P] for row in rows], np.int32)
    free = _both(ref, lay, mode, chunks=3, hist0=hist0)
    picks, seen = [], [[] for _ in range(B)]
    for c, out in enumerate(free):
        acc, toks, n_valid = out[6], out[3], out[2]
        for r in range(B):
            start = 0
            for n in acc[r].tolist():
                eos = int(toks[r, start + 1]) if n > 1 else None
                if eos is not None and eos not in \
                        seen[r] + toks[r, :start + 1].tolist():
                    picks.append((c, r, start, eos))
                start += n
            seen[r] += toks[r, :int(n_valid[r])].tolist()
    assert picks, "no iteration accepted a draft"
    c, r, start, eos = picks[0]
    outs = _both(ref, lay, mode, eos=eos, chunks=c + 1, hist0=hist0)
    done, n_valid, toks = outs[c][1], outs[c][2], outs[c][3]
    assert bool(done[r]) and int(n_valid[r]) == start + 2
    assert int(toks[r, start + 1]) == eos
    assert int(outs[c][0][r, 0]) == eos            # the frozen re-feed


def _poison(slot, position):
    """A ``decode_step`` wrapper that turns the verify logits of ``slot``
    at absolute position ``position`` into NaN (the draft steps pass),
    as the reference's ``nan_logits_hook`` does."""
    def wrap(real):
        def poisoned(cache, tokens, layers=None):
            pos0 = cache["pos"].clone()
            logits, cache = real(cache, tokens, layers)
            if layers is None:
                row = pos0[:, None] + torch.arange(tokens.shape[1])
                hit = torch.zeros_like(row, dtype=torch.bool)
                hit[slot] = row[slot] == position
                logits = torch.where(hit[..., None], float("nan"), logits)
            return logits, cache
        return poisoned
    return wrap


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_nan_slot_matches_reference(ref, layout, mode):
    """Slot 2's verify logits go NaN at position P + 5: every output of
    every chunk equals the reference's (its logits_hook armed there); the
    slot fails with the tokens at positions P .. P + 5 counted, the last
    of them sampled from finite logits, and no other slot fails."""
    arm = [-1, -1, P + 5, -1]
    outs = _both(ref, layout(), mode, chunks=3, arm=arm,
                 poison=_poison(2, P + 5))
    at = [c for c, o in enumerate(outs) if bool(o[7][2])]
    assert at, "slot 2 never failed"
    assert sum(int(o[2][2]) for o in outs[:at[0] + 1]) == 6
    assert not any(bool(o[7][[0, 1, 3]].any()) for o in outs)


@pytest.mark.parametrize("mode", ["ngram", "draft"])
@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 5)])
@pytest.mark.parametrize("kv_quant,pages", LAYOUTS, ids=IDS)
def test_spec_chunk_reads_nothing_back(ref, monkeypatch, mode, temperature,
                                       top_k, kv_quant, pages):
    """The spec body with every host read of a tensor patched to raise
    (what a CUDA graph capture refuses); the cache, hist and hist_len keep
    their objects and addresses."""
    tm = _port(ref, kv_quant, pages)
    toks = _prompts(256)
    logits, cache = tm.prefill(torch.from_numpy(toks), max_len=P + GEN + K)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    hist, hist_len = (torch.from_numpy(a) for a in _hist(toks, GEN, 2, K))
    eos = torch.tensor(7, dtype=torch.int32)
    gen = torch.Generator().manual_seed(1)
    before = [(t, t.data_ptr()) for t in cache_tensors([cache, hist,
                                                        hist_len])]

    def refuse(self, *args, **kwargs):
        raise AssertionError("a host read of a tensor in the spec chunk")

    for name in SYNCS:
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out = spec_decode_chunk(tm, cache, tok, gen, eos, hist, hist_len,
                            chunk=2, k=K, mode=mode, draft_layers=1,
                            temperature=temperature, top_k=top_k)
    monkeypatch.undo()
    assert out[3].shape == (B, 2 * (K + 1)) and out[6].shape == (B, 2)
    assert out[4] is hist and out[5] is hist_len
    now = list(cache_tensors([cache, hist, hist_len]))
    assert all(t is t0 and t.data_ptr() == p
               for t, (t0, p) in zip(now, before))


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_sampled_spec_masks(ref, mode):
    """Sampled speculation: top-k 1 at temperature 1 gives the greedy
    tokens; at temperature 0.8 and top-k 5 every committed token after the
    first lies in its position's top 5 (teacher-forced logits), and each
    iteration commits 1..k + 1 tokens."""
    tm = _port(ref)
    toks = _prompts(256, seed=2)
    greedy = _greedy_tokens(tm, toks, mode)

    def sampled(temperature, top_k):
        logits, cache = tm.prefill(torch.from_numpy(toks),
                                   max_len=P + GEN + K)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        hist, hist_len = (torch.from_numpy(a) for a in _hist(toks, GEN,
                                                             CHUNK, K))
        step = make_generate_step(tm, chunk=CHUNK, temperature=temperature,
                                  top_k=top_k, spec=mode, spec_k=K)
        gen = torch.Generator().manual_seed(3)
        rows, accs = [[] for _ in range(B)], []
        while min(len(r) for r in rows) < GEN:
            out = step(cache, tok, gen, -1, hist, hist_len)
            tok = out[1]
            accs.append(out[8])
            for r in range(B):
                rows[r] += out[5][r, :out[4][r]].tolist()
        return np.asarray([r[:GEN] for r in rows]), torch.cat(accs, 1)

    top1, _ = sampled(1.0, 1)
    np.testing.assert_array_equal(top1, greedy)
    got, acc = sampled(0.8, 5)
    assert ((acc >= 1) & (acc <= K + 1)).all()
    logits, cache = tm.prefill(torch.from_numpy(toks), max_len=P + GEN)
    for i in range(GEN - 1):
        logits, cache = tm.decode_step(cache, torch.from_numpy(got[:, i:i + 1]))
        top = torch.topk(logits[:, -1], 5, dim=-1).indices
        assert bool((top == torch.from_numpy(got[:, i + 1:i + 2])).any(-1)
                    .all()), i


# ---------------------------------------------------------------------------
# the engine and serve()
# ---------------------------------------------------------------------------
def _mixed_queue(vocab, prompt_len, budgets, seed=0):
    """The reference's spec-test queue, every third prompt a period-2 tile
    of the whole bucket."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i, n in enumerate(budgets):
        t = rng.integers(1, vocab, int(rng.integers(3, prompt_len + 1)))
        if i % 3 == 1:
            t = np.tile(t[:2], prompt_len)[:prompt_len]
        reqs.append((i, t.astype(np.int32), n))
    return reqs


@pytest.mark.parametrize("mode,kv_quant,pages", [
    ("ngram", "off", 0), ("ngram", "off", PS), ("ngram", "int8", PS),
    ("ngram", "int8", 0), ("draft", "off", 0), ("draft", "int8", PS)])
def test_engine_spec_matches_reference(ref, layout, mode, kv_quant, pages):
    """A mixed queue (slot reuse, partial budgets) through 2 slots:
    completions and the accepted-length statistics equal the reference
    engine's with the same drafter, completions equal the port's own
    speculation-off drain, no more dispatches than it, and every page back
    in the pool."""
    lay = layout(kv_quant, pages)
    kw = dict(slots=2, prompt_len=8, max_new=10, chunk=4)
    queue = _mixed_queue(ref["jcfg"].vocab_size, 8, [3, 10, 5, 2, 7, 9])
    jeng = JServeEngine(ref["jm"], ref["params"], ref["plan"], spec=mode,
                        spec_k=K, **kw, **NO_WATCHDOG)
    jc = {c.uid: c for c in jeng.run([JRequest(u, t, n)
                                      for u, t, n in queue])}

    def port(spec):
        eng = tserve.make_queue_engine(
            slots=2, prompt_len=8, gen=10, chunk=4, device="cpu",
            cfg=ref["tcfg"], params=ref["np_params"], spec=spec, spec_k=K,
            **lay, **NO_WATCHDOG)
        eng.run([Request(u, t, n) for u, t, n in queue])
        return eng
    teng, off = port(mode), port("off")
    tc = {c.uid: c for c in teng.completions}
    oc = {c.uid: c for c in off.completions}
    assert sorted(tc) == sorted(jc) == sorted(oc) == list(range(len(queue)))
    for uid in jc:
        assert tc[uid].finish_reason == jc[uid].finish_reason
        _eq(tc[uid].tokens, jc[uid].tokens, f"request {uid}")
        _eq(tc[uid].tokens, oc[uid].tokens, f"request {uid} vs off")
    for key in ("spec_accept_hist", "spec_draft_iters", "spec_emitted_tokens",
                "spec_accepted_len_per_draft", "decode_dispatches",
                "prefills", "tokens_out"):
        assert teng.stats[key] == jeng.stats[key], key
    s = teng.stats
    assert sum(s["spec_accept_hist"]) == s["spec_draft_iters"] > 0
    assert s["decode_dispatches"] <= off.stats["decode_dispatches"]
    assert teng.chunk_span == 4 * (K + 1)
    if mode == "draft":
        assert s["draft_steps"] == K * s["decode_steps"]
    if pages:
        assert teng.cache_pos_len == jeng.cache_pos_len
        assert s["kv_pages_in_use"] == 0 and teng._alloc.used == 0
        assert sorted(teng._alloc.free) == list(range(1, teng.n_phys_pages))
        assert not teng._host_table.any()


def test_engine_spec_draft_accepts(ref, layout):
    """The reference's draft-acceptance queue: the layer-skip drafter lands
    drafts (accepted length per draft above 1.0) as the reference's."""
    layout()
    kw = dict(slots=2, prompt_len=8, max_new=10, chunk=4)
    rng = np.random.default_rng(0)
    queue = [(i, rng.integers(1, ref["jcfg"].vocab_size,
                              rng.integers(3, 9)).astype(np.int32), n)
             for i, n in enumerate([3, 10, 5, 2, 7])]
    jeng = JServeEngine(ref["jm"], ref["params"], ref["plan"], spec="draft",
                        spec_k=K, **kw, **NO_WATCHDOG)
    jeng.run([JRequest(u, t, n) for u, t, n in queue])
    teng = tserve.make_queue_engine(slots=2, prompt_len=8, gen=10, chunk=4,
                                    device="cpu", cfg=ref["tcfg"],
                                    params=ref["np_params"], spec="draft",
                                    spec_k=K, **NO_WATCHDOG)
    teng.run([Request(u, t, n) for u, t, n in queue])
    assert teng.stats["spec_accept_hist"] == jeng.stats["spec_accept_hist"]
    assert teng.stats["spec_accepted_len_per_draft"] > 1.0


@pytest.mark.parametrize("kv_quant,pages", [("off", 0), ("int8", 0),
                                            ("int4", 0), ("off", PS),
                                            ("int8", PS)])
def test_serve_spec_equals_off(ref, kv_quant, pages):
    """serve() with either drafter returns the tokens of serve() with
    speculation off; the per-token loop ignores spec; its counts add up."""
    kw = dict(batch=3, prompt_len=9, gen=10, chunk=4, seed=1, device="cpu",
              cfg=ref["tcfg"], params=ref["np_params"], kv_quant=kv_quant,
              page_size=pages)
    want = tserve.serve(**kw)["tokens"]
    for mode in ("ngram", "draft"):
        out = tserve.serve(spec=mode, spec_k=K, **kw)
        np.testing.assert_array_equal(out["tokens"], want, err_msg=mode)
        assert out["accepted_len_per_draft"] >= 1.0
        assert out["decode_steps"] == CHUNK * (out["dispatches"] + 1)
        assert out["draft_steps"] == (K * out["decode_steps"]
                                      if mode == "draft" else 0)
    loop = tserve.serve(engine="loop", spec="ngram", **kw)
    np.testing.assert_array_equal(loop["tokens"], want)
    assert "accepted_len_per_draft" not in loop


def test_griffin_serves_with_speculation_off(ref):
    """recurrentgemma-2b asked to speculate warns and serves as without."""
    cfg = tconfigs.get_config("recurrentgemma-2b", smoke=True).replace(
        compute_dtype="float32")
    kw = dict(arch="recurrentgemma-2b", batch=2, prompt_len=6, gen=4,
              chunk=2, device="cpu", cfg=cfg)
    want = tserve.serve(**kw)["tokens"]
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = tserve.serve(spec="ngram", **kw)
    assert any("family" in str(w.message) for w in seen)
    np.testing.assert_array_equal(got["tokens"], want)
    assert "accepted_len_per_draft" not in got
