"""The fused decode chunk as a CUDA graph replay against the same chunk run
eagerly, on a card, at smoke size with head_dim 64 (a width the kernels
take): ``pimref-100m`` in its six KV layouts, ``recurrentgemma-2b``
across a window wrap (contiguous, int8 codes, pages of 16), the
encoder-decoder in four layouts and xLSTM, the
engine, EOS set between chunks, a weight load
after the capture, sampled decoding, speculative decoding (both drafters;
contiguous, int8 and pages of 16; a new history; the engine), and the
robust-serving layer (the NaN hook as a static input of the graph, a shed
level's capture, a spawned worker killed by ``terminate()`` on the card).
Imports neither jax nor the reference package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_graph_cuda.py

Without a card every test skips."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.chaos import (ShardChaosConfig,  # noqa: E402
                                           nan_logits_hook)
from repro_torch.kernels import launch_counters  # noqa: E402
from repro_torch.launch import engine as engine_mod  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import (GenerateStep, cache_tensors,  # noqa: E402
                                      clone_cache, decode_chunk,
                                      make_generate_step, sample_tokens)

PAGE = 8
LAYOUTS = [("off", 0), ("int8", 0), ("int4", 0), ("auto", 0), ("off", PAGE),
           ("int8", PAGE)]
DECODE_KERNEL = {("off", 0): "flash_decode_fwd",
                 ("off", PAGE): "flash_decode_paged_fwd",
                 ("int8", PAGE): "flash_decode_paged_quant_fwd"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


class EagerChunk(GenerateStep):
    """The chunk body run eagerly on the card: the graph's yardstick."""

    def prepare(self, cache, tok, generator, hist=None, hist_len=None, *,
                arm=None):
        self._warm_up(cache, tok, self._state(hist, hist_len),
                      self._arm(arm))

    def __call__(self, cache, tok, generator, eos_id, hist=None,
                 hist_len=None, *, arm=None):
        return self._eager(cache, tok, generator, eos_id,
                           *self._state(hist, hist_len), arm=self._arm(arm))


def _model(arch, dev, kv_quant="off", page_size=0, seed=0):
    cfg = get_config(arch, smoke=True).replace(head_dim=64)
    return tserve.load_model(arch, smoke=True, seed=seed, device=dev, cfg=cfg,
                             kv_quant=kv_quant, page_size=page_size)


def _prefill(model, dev, B=2, S=20, max_len=32, seed=3):
    toks = np.random.default_rng(seed).integers(
        0, model.cfg.vocab_size, (B, S)).astype(np.int32)
    logits, cache = model.prefill(torch.from_numpy(toks).to(dev),
                                  max_len=max_len)
    return cache, torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)


def _reset():
    for counter in launch_counters():
        for name in counter:
            counter[name] = 0


def _launches():
    return {n: c for counter in launch_counters() for n, c in counter.items()}


def _run(step, cache, tok, chunks, gen=None, eos=-1):
    out = []
    for _ in range(chunks):
        cache, tok, gen, done, n_valid, toks, failed = step(cache, tok, gen,
                                                            eos)
        out.append(torch.cat([toks, done[:, None].int(), n_valid[:, None],
                              failed[:, None].int()], 1).cpu())
    torch.cuda.synchronize()
    return torch.cat(out, 1), cache


def _same_cache(a, b):
    for x, y in zip(cache_tensors(a), cache_tensors(b)):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant,page_size", LAYOUTS)
def test_graph_equals_eager_chunk(cuda, kv_quant, page_size):
    """Three chunks of 4: tokens, flags, counts and the cache byte for
    byte; one capture; every replay counted one chunk of decode launches;
    the cache tensors and ``tok`` are the caller's."""
    model = _model("pimref-100m", cuda, kv_quant, page_size)
    cache, tok = _prefill(model, cuda)
    eager_cache, eager_tok = clone_cache(cache), tok.clone()
    want, eager_cache = _run(EagerChunk(model, chunk=4), eager_cache,
                             eager_tok, 3)
    step = make_generate_step(model, chunk=4)
    ptrs = [t.data_ptr() for t in cache_tensors(cache)]
    step.prepare(cache, tok, None)
    _reset()
    got, cache_out = _run(step, cache, tok, 3)
    assert torch.equal(got, want)
    _same_cache(cache, eager_cache)
    assert cache_out is cache
    assert [t.data_ptr() for t in cache_tensors(cache)] == ptrs
    assert step.captures == 1
    kernel = DECODE_KERNEL.get((kv_quant, page_size), "flash_decode_quant_fwd")
    want_launches = dict.fromkeys(_launches(), 0)
    want_launches[kernel] = 3 * 4 * model.cfg.num_layers
    assert _launches() == want_launches


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant,page_size", [("off", 0), ("int8", 0),
                                                ("off", PAGE), ("int8", PAGE)])
def test_encdec_graph_equals_eager_chunk(cuda, kv_quant, page_size):
    """The encoder-decoder (seamless-m4t-large-v2 at smoke width, heads of
    64) in four layouts: three chunks of 4 replayed equal the eager body
    (tokens, flags, counts, the self and cross caches byte for byte); each
    step launched the self cache's decode kernel and the cross cache's
    contiguous one once per layer."""
    model = _model("seamless-m4t-large-v2", cuda, kv_quant, page_size)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size, (2, 20))
                            .astype(np.int32)).to(cuda)
    src = torch.from_numpy(rng.standard_normal((2, 24, model.cfg.d_model))
                           .astype(np.float32)).to(cuda)
    logits, cache = model.prefill(toks, max_len=32, src_embeds=src)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    assert tuple(cache["xk"].shape if kv_quant == "off"
                 else cache["xk"].codes.shape)[2] == 24
    eager_cache, eager_tok = clone_cache(cache), tok.clone()
    want, eager_cache = _run(EagerChunk(model, chunk=4), eager_cache,
                             eager_tok, 3)
    step = make_generate_step(model, chunk=4)
    step.prepare(cache, tok, None)
    _reset()
    got, _ = _run(step, cache, tok, 3)
    assert torch.equal(got, want)
    _same_cache(cache, eager_cache)
    assert step.captures == 1
    self_kernel = {("off", 0): "flash_decode_fwd",
                   ("int8", 0): "flash_decode_quant_fwd",
                   ("off", PAGE): "flash_decode_paged_fwd",
                   ("int8", PAGE): "flash_decode_paged_quant_fwd"}
    cross = "flash_decode_quant_fwd" if kv_quant != "off" else \
        "flash_decode_fwd"
    L = model.cfg.num_layers
    want_l = {n: 0 for n in _launches()}
    want_l[self_kernel[(kv_quant, page_size)]] += 12 * L
    want_l[cross] += 12 * L
    assert _launches() == want_l


@pytest.mark.cuda
def test_xlstm_graph_equals_eager_chunk(cuda):
    """xlstm-125m at smoke size (layer 3 sLSTM): three chunks of 4 replayed
    equal the eager body, tokens and every block's state byte for byte; no
    kernel launched."""
    model = tserve.load_model("xlstm-125m", smoke=True, seed=0, device=cuda)
    toks = np.random.default_rng(3).integers(
        0, model.cfg.vocab_size, (3, 32)).astype(np.int32)
    logits, cache = model.prefill(torch.from_numpy(toks).to(cuda))
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    eager_cache, eager_tok = clone_cache(cache), tok.clone()
    want, eager_cache = _run(EagerChunk(model, chunk=4), eager_cache,
                             eager_tok, 3)
    step = make_generate_step(model, chunk=4)
    ptrs = [t.data_ptr() for t in cache_tensors(cache)]
    step.prepare(cache, tok, None)
    _reset()
    got, _ = _run(step, cache, tok, 3)
    assert torch.equal(got, want)
    _same_cache(cache, eager_cache)
    assert [t.data_ptr() for t in cache_tensors(cache)] == ptrs
    assert step.captures == 1
    assert not any(_launches().values())


@pytest.mark.cuda
def test_tok_copied_into_the_graph(cuda):
    """A caller that hands in a fresh ``tok`` tensor every chunk gets the
    eager body's tokens from one capture: ``tok`` is copied in."""
    model = _model("pimref-100m", cuda)
    cache, tok = _prefill(model, cuda)
    want, _ = _run(EagerChunk(model, chunk=4), clone_cache(cache),
                   tok.clone(), 3)
    step = make_generate_step(model, chunk=4)
    got = []
    for _ in range(3):
        out = step(cache, tok.clone(), None, -1)
        tok = out[1].clone()
        got.append(torch.cat([out[5], out[3][:, None].int(), out[4][:, None],
                              out[6][:, None].int()], 1).cpu())
    assert torch.equal(torch.cat(got, 1), want)
    assert step.captures == 1


@pytest.mark.cuda
def test_griffin_graph_across_window_wrap(cuda):
    """Griffin (window 32) from a 30-token prompt, four chunks of 4: every
    decode write past position 31 wraps the ring. Graph == eager."""
    model = _model("recurrentgemma-2b", cuda)
    cache, tok = _prefill(model, cuda, S=30, max_len=46)
    assert model.cache_len(46) == 32
    want, eager_cache = _run(EagerChunk(model, chunk=4), clone_cache(cache),
                             tok.clone(), 4)
    step = make_generate_step(model, chunk=4)
    got, _ = _run(step, cache, tok, 4)
    assert torch.equal(got, want)
    _same_cache(cache, eager_cache)
    assert step.captures == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant,page_size,kernel", [
    ("int8", 0, "flash_decode_quant_fwd"),
    ("off", 16, "flash_decode_paged_fwd")])
def test_griffin_layout_graph_equals_eager(cuda, kv_quant, page_size, kernel):
    """Griffin over int8 codes and over pages of 16, from a 30-token
    prompt across the window wrap, four chunks of 4: graph == eager chunk,
    the cache byte for byte, one capture, and every replay one chunk's
    launches of the layout's decode kernel (one a step per attention
    layer), none of another kernel."""
    model = _model("recurrentgemma-2b", cuda, kv_quant, page_size)
    cache, tok = _prefill(model, cuda, S=30, max_len=46)
    assert model.cache_len(46) == 32
    want, eager_cache = _run(EagerChunk(model, chunk=4), clone_cache(cache),
                             tok.clone(), 4)
    step = make_generate_step(model, chunk=4)
    step.prepare(cache, tok, None)
    _reset()
    got, _ = _run(step, cache, tok, 4)
    assert torch.equal(got, want)
    _same_cache(cache, eager_cache)
    assert step.captures == 1
    want_launches = dict.fromkeys(_launches(), 0)
    want_launches[kernel] = 4 * 4 * (model.cfg.num_layers // 3)
    assert _launches() == want_launches


def _requests(vocab, n=7, prompt_len=16):
    rng = np.random.default_rng(1)
    prefix = rng.integers(1, vocab, 8).astype(np.int32)
    reqs = []
    for i in range(n):
        t = rng.integers(1, vocab, int(rng.integers(9, prompt_len + 1)))
        t[:8] = prefix
        reqs.append(tserve.Request(uid=i, tokens=t.astype(np.int32),
                                   max_new_tokens=int(rng.integers(3, 13))))
    return reqs


@pytest.mark.cuda
@pytest.mark.parametrize("kv_quant,page_size", [("off", 0), ("off", PAGE),
                                                ("int8", PAGE)])
def test_engine_drain_graph_equals_eager(cuda, kv_quant, page_size,
                                         monkeypatch):
    """A mixed queue with a shared prefix through 3 slots: one capture per
    engine, the completions of an engine running the eager body, and
    exact launches (the capture's warm-up chunk included)."""
    model = _model("pimref-100m", cuda, kv_quant, page_size)
    kw = dict(model=model, slots=3, prompt_len=16, gen=12, chunk=4,
              kv_quant=kv_quant, page_size=page_size)
    reqs = _requests(model.cfg.vocab_size)
    monkeypatch.setattr(engine_mod, "make_generate_step", EagerChunk)
    want = tserve.make_queue_engine(**kw).run(list(reqs))
    monkeypatch.undo()
    eng = tserve.make_queue_engine(**kw)
    _reset()
    got = eng.run(list(reqs))
    torch.cuda.synchronize()
    key = lambda c: c.uid  # noqa: E731
    assert [(c.uid, c.finish_reason, list(c.tokens))
            for c in sorted(got, key=key)] == \
        [(c.uid, c.finish_reason, list(c.tokens))
         for c in sorted(want, key=key)]
    s = eng.stats
    assert s["graph_captures"] == 1 and s["capture_seconds"] > 0
    assert s["decode_steps"] == 4 * (s["decode_dispatches"] + 1)
    kernel = DECODE_KERNEL.get((kv_quant, page_size))
    n_layers = model.cfg.num_layers
    want_launches = dict.fromkeys(_launches(), 0)
    want_launches[kernel] = n_layers * s["decode_steps"]
    want_launches["flash_attention_fwd"] = n_layers * s["prefills"]
    assert _launches() == want_launches


@pytest.mark.cuda
def test_eos_set_between_chunks(cuda):
    """``eng.eos_id`` set after the first (captured) chunk stops the
    request at its next occurrence; no second capture."""
    model = _model("pimref-100m", cuda)
    kw = dict(model=model, slots=2, prompt_len=8, gen=12, chunk=3)
    req = dict(uid=0, tokens=np.arange(1, 7, dtype=np.int32),
               max_new_tokens=12)
    stream = list(tserve.make_queue_engine(**kw).run(
        [tserve.Request(**req)])[0].tokens)
    eng = tserve.make_queue_engine(**kw)
    eng.submit(tserve.Request(**req))
    eng.step()
    eng.eos_id = int(stream[4])
    eng.run()
    got = eng.completions[0]
    assert got.finish_reason == "eos"
    assert list(got.tokens) == stream[:stream.index(stream[4], 3) + 1]
    assert eng.stats["graph_captures"] == 1


@pytest.mark.cuda
def test_weight_load_recaptures(cuda):
    """Weights loaded in place after the capture: the next chunk captures
    again and its tokens are those of the eager body on the new
    weights."""
    model = _model("pimref-100m", cuda)
    other = _model("pimref-100m", cuda, seed=5)
    cache, tok = _prefill(model, cuda)
    step = make_generate_step(model, chunk=4)
    _run(step, cache, tok, 1)
    assert step.captures == 1
    model.load_state_dict(other.state_dict())
    eager_cache, eager_tok = clone_cache(cache), tok.clone()
    want, _ = _run(EagerChunk(model, chunk=4), eager_cache, eager_tok, 2)
    got, _ = _run(step, cache, tok, 2)
    assert step.captures == 2
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_sampled_graph(cuda):
    """Top-k sampling: two graph runs from one seed are identical, every
    token lies in the top k of its step's logits, and the graph draws what
    the eager body draws from the same generator state."""
    model = _model("pimref-100m", cuda)
    cache0, tok0 = _prefill(model, cuda)
    runs = []
    for _ in range(2):
        gen = torch.Generator(device=cuda).manual_seed(11)
        step = make_generate_step(model, chunk=4, temperature=0.9, top_k=5)
        runs.append(_run(step, clone_cache(cache0), tok0.clone(), 3, gen)[0])
    assert torch.equal(runs[0], runs[1])
    gen = torch.Generator(device=cuda).manual_seed(11)
    eager, _ = _run(EagerChunk(model, chunk=4, temperature=0.9, top_k=5),
                    clone_cache(cache0), tok0.clone(), 3, gen)
    assert torch.equal(runs[0], eager)
    # every emitted token after the first is a top-5 token of its step
    cache, tok = clone_cache(cache0), tok0.clone()
    toks = runs[0][:, [c * 7 + i for c in range(3) for i in range(4)]]
    for i in range(toks.shape[1] - 1):
        logits, cache = model.decode_step(cache, toks[:, i:i + 1].to(cuda))
        top = torch.topk(logits[:, -1].float(), 5, dim=-1).indices.cpu()
        assert bool((top == toks[:, i + 1:i + 2]).any(-1).all())


@pytest.mark.cuda
def test_sampler_draws_as_multinomial(cuda):
    """On the card too, the exponential race draws what
    ``torch.multinomial`` draws from the same generator state."""
    logits = torch.randn((8, 1, 32768), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(0))
    for seed in range(4):
        g1 = torch.Generator(device=cuda).manual_seed(seed)
        g2 = torch.Generator(device=cuda).manual_seed(seed)
        got = sample_tokens(logits, g1, temperature=0.8, top_k=0)
        want = torch.multinomial(torch.softmax(logits[:, 0] / 0.8, -1), 1,
                                 generator=g2)
        assert torch.equal(got[:, 0], want[:, 0].int())


@pytest.mark.cuda
def test_decode_chunk_under_sync_debug_mode(cuda):
    """One eager chunk per layout with CUDA's sync debug mode set to
    raise on any synchronising call."""
    for kv_quant, page_size in LAYOUTS:
        model = _model("pimref-100m", cuda, kv_quant, page_size)
        cache, tok = _prefill(model, cuda)
        eos = torch.tensor(5, dtype=torch.int32, device=cuda)
        gen = torch.Generator(device=cuda).manual_seed(0)
        torch.cuda.set_sync_debug_mode("error")
        try:
            decode_chunk(model, cache, tok, gen, eos, chunk=2,
                         temperature=0.7, top_k=4)
        finally:
            torch.cuda.set_sync_debug_mode("default")


# ---------------------------------------------------------------------------
# speculative decoding: the draft-verify chunk as one graph replay
# ---------------------------------------------------------------------------
K = 3
SPEC_LAYOUTS = [("off", 0), ("int8", 0), ("off", 16)]
SPEC_KERNEL = {("off", 0): "flash_decode_fwd",
               ("int8", 0): "flash_decode_quant_fwd",
               ("off", 16): "flash_decode_paged_fwd"}


def _spec_inputs(model, dev, B=4, S=20, gen=16, chunk=4, seed=3):
    """Half the rows a period-4 tile, half random; the cache sized for the
    k-ahead writes; the drafter's history seeded with the prompts."""
    rng = np.random.default_rng(seed)
    V = model.cfg.vocab_size
    toks = np.stack([np.tile(rng.integers(1, V, 4), S // 4) if r < B // 2
                     else rng.integers(1, V, S) for r in range(B)])
    toks = torch.from_numpy(toks.astype(np.int32)).to(dev)
    logits, cache = model.prefill(toks, max_len=S + gen + K)
    hist = torch.zeros((B, S + gen + chunk * (K + 1)), dtype=torch.int32,
                       device=dev)
    hist[:, :S] = toks
    hist_len = torch.full((B,), S, dtype=torch.int32, device=dev)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    return cache, tok, hist, hist_len


def _spec_run(step, cache, tok, hist, hist_len, chunks, gen=None, eos=-1):
    out = []
    for _ in range(chunks):
        (cache, tok, gen, done, n_valid, toks, hist, hist_len, acc,
         failed) = step(cache, tok, gen, eos, hist, hist_len)
        out.append(torch.cat([toks, done[:, None].int(), n_valid[:, None],
                              acc, failed[:, None].int(), hist_len[:, None]],
                             1).cpu())
    torch.cuda.synchronize()
    return torch.cat(out, 1)


def _spec_launches(step, chunks):
    """Decode-kernel launches of ``chunks`` spec chunks: per iteration one
    verify block through every layer and, for ``draft``, k steps through
    the first draft_layers."""
    L = step.model.cfg.num_layers
    return chunks * step.chunk * (L + step.spec_k * step.draft_layers)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ngram", "draft"])
@pytest.mark.parametrize("kv_quant,page_size", SPEC_LAYOUTS)
def test_spec_graph_equals_eager_chunk(cuda, mode, kv_quant, page_size):
    """Three spec chunks of 4 iterations, k 3: tokens, flags, counts,
    accepted lengths, the history and the cache byte for byte against the
    eager body; one capture; every replay counted one chunk's decode
    launches (the verify blocks and the draft steps) and nothing else."""
    model = _model("pimref-100m", cuda, kv_quant, page_size)
    cache, tok, hist, hist_len = _spec_inputs(model, cuda)
    eager = (clone_cache(cache), tok.clone(), hist.clone(), hist_len.clone())
    want = _spec_run(EagerChunk(model, chunk=4, spec=mode, spec_k=K),
                     *eager, 3)
    step = make_generate_step(model, chunk=4, spec=mode, spec_k=K)
    step.prepare(cache, tok, None, hist, hist_len)
    _reset()
    got = _spec_run(step, cache, tok, hist, hist_len, 3)
    assert torch.equal(got, want)
    _same_cache(cache, eager[0])
    assert torch.equal(hist, eager[2]) and torch.equal(hist_len, eager[3])
    assert step.captures == 1
    want_launches = dict.fromkeys(_launches(), 0)
    want_launches[SPEC_KERNEL[(kv_quant, page_size)]] = _spec_launches(step,
                                                                       3)
    assert _launches() == want_launches


@pytest.mark.cuda
def test_spec_recaptures_for_a_new_history(cuda):
    """A new ``hist`` tensor (the same values) makes the next chunk capture
    again, on it; its tokens are the eager body's."""
    model = _model("pimref-100m", cuda)
    cache, tok, hist, hist_len = _spec_inputs(model, cuda)
    step = make_generate_step(model, chunk=4, spec="ngram", spec_k=K)
    _spec_run(step, cache, tok, hist, hist_len, 1)
    assert step.captures == 1
    hist2 = hist.clone()
    eager = (clone_cache(cache), tok.clone(), hist.clone(), hist_len.clone())
    want = _spec_run(EagerChunk(model, chunk=4, spec="ngram", spec_k=K),
                     *eager, 2)
    got = _spec_run(step, cache, tok, hist2, hist_len, 2)
    assert step.captures == 2
    assert torch.equal(got, want) and torch.equal(hist2, eager[2])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_spec_sampled_graph(cuda, mode):
    """Sampled speculation (top-k 5): the generator is registered with the
    graph, so two graph runs from one seed are identical and equal the
    eager body from the same generator state; every iteration commits 1
    .. k + 1 tokens."""
    model = _model("pimref-100m", cuda)
    inputs = _spec_inputs(model, cuda)
    runs = []
    for cls in (make_generate_step, make_generate_step, EagerChunk):
        gen = torch.Generator(device=cuda).manual_seed(11)
        step = cls(model, chunk=4, temperature=0.9, top_k=5, spec=mode,
                   spec_k=K)
        state = (clone_cache(inputs[0]),) + tuple(t.clone()
                                                  for t in inputs[1:])
        runs.append(_spec_run(step, *state, 3, gen))
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    span = 4 * (K + 1)
    for c in range(3):
        acc = runs[0][:, c * (span + 8) + span + 2:c * (span + 8) + span + 6]
        assert ((acc >= 1) & (acc <= K + 1)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ngram", "draft"])
@pytest.mark.parametrize("kv_quant,page_size", [("off", 0), ("int8", 16)])
def test_engine_spec_drain(cuda, mode, kv_quant, page_size):
    """A mixed queue through 3 slots with speculation: the completions of
    the same engine with speculation off, one capture, exact launches and
    every page back in the pool."""
    model = _model("pimref-100m", cuda, kv_quant, page_size)
    kw = dict(model=model, slots=3, prompt_len=16, gen=12, chunk=4,
              kv_quant=kv_quant, page_size=page_size)
    reqs = _requests(model.cfg.vocab_size)
    want = tserve.make_queue_engine(**kw).run(list(reqs))
    eng = tserve.make_queue_engine(spec=mode, spec_k=K, **kw)
    _reset()
    got = eng.run(list(reqs))
    torch.cuda.synchronize()
    key = lambda c: c.uid  # noqa: E731
    assert [(c.uid, c.finish_reason, list(c.tokens))
            for c in sorted(got, key=key)] == \
        [(c.uid, c.finish_reason, list(c.tokens))
         for c in sorted(want, key=key)]
    s = eng.stats
    assert s["graph_captures"] == 1
    L = model.cfg.num_layers
    want_launches = dict.fromkeys(_launches(), 0)
    want_launches[DECODE_KERNEL.get((kv_quant, page_size),
                                    "flash_decode_paged_quant_fwd")] = (
        L * s["decode_steps"] + eng._generate.draft_layers * s["draft_steps"])
    want_launches["flash_attention_fwd"] = L * s["prefills"]
    assert _launches() == want_launches
    assert sum(s["spec_accept_hist"]) == s["spec_draft_iters"] > 0
    if page_size:
        assert s["kv_pages_in_use"] == 0 and not eng._host_table.any()


# ---------------------------------------------------------------------------
# robust serving: the NaN hook in the graph, shedding, a spawned worker
# ---------------------------------------------------------------------------
def _hook_run(step, cache, tok, hist, hist_len, arm, chunks):
    """``chunks`` chunks with the hook armed by ``arm``, read as ``_run``
    (or, with speculation, ``_spec_run``) reads them."""
    out = []
    state = () if hist is None else (hist, hist_len)
    for _ in range(chunks):
        res = step(cache, tok, None, -1, *state, arm=arm)
        tok = res[1]
        cols = [res[5], res[3][:, None].int(), res[4][:, None]]
        if state:
            cols.append(res[8])
        cols.append(res[-1][:, None].int())
        if state:
            cols.append(res[7][:, None])
        out.append(torch.cat(cols, 1).cpu())
    torch.cuda.synchronize()
    return torch.cat(out, 1)


def _hook_inputs(model, dev, spec):
    if spec == "off":
        cache, tok = _prefill(model, dev, B=4, S=20, max_len=40)
        return cache, tok, None, None
    return _spec_inputs(model, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["off", "ngram"])
def test_hooked_graph_equals_hooked_eager_body(cuda, spec):
    """The NaN hook inside the captured chunk (the verify block with
    ``ngram``): armed rows 1 and 3 at positions inside the first and second
    chunk, the graph's tokens, flags, counts and cache equal the hooked
    eager body's; the armed slots fail, the others decode on; one capture;
    a hooked replay launches what a clean one does."""
    model = _model("pimref-100m", cuda)
    kw = dict(chunk=4, logits_hook=nan_logits_hook)
    if spec != "off":
        kw.update(spec=spec, spec_k=K)
    cache, tok, hist, hist_len = _hook_inputs(model, cuda, spec)
    arm = torch.tensor([-1, 22, -1, 26], dtype=torch.int32, device=cuda)
    eager = (clone_cache(cache), tok.clone(),
             None if hist is None else hist.clone(),
             None if hist is None else hist_len.clone())
    want = _hook_run(EagerChunk(model, **kw), *eager, arm.clone(), 3)
    step = make_generate_step(model, **kw)
    step.prepare(cache, tok, None, *(() if hist is None else
                                     (hist, hist_len)), arm=arm)
    _reset()
    got = _hook_run(step, cache, tok, hist, hist_len, arm, 3)
    assert torch.equal(got, want)
    _same_cache(cache, eager[0])
    assert step.captures == 1
    col = step.span + 2 + (4 if hist is not None else 0)
    failed = sum(c[:, col] for c in got.split(got.shape[1] // 3, 1))
    assert failed.tolist() == [0, 1, 0, 1]         # each in its chunk
    want_launches = dict.fromkeys(_launches(), 0)
    want_launches["flash_decode_fwd"] = (
        3 * 4 * model.cfg.num_layers if spec == "off"
        else _spec_launches(step, 3))
    assert _launches() == want_launches


@pytest.mark.cuda
@pytest.mark.parametrize("spec", ["off", "ngram"])
def test_disarmed_hooked_graph_equals_unhooked_graph(cuda, spec):
    """Every slot disarmed (-1): the hooked graph's tokens, flags, counts
    and cache are bitwise the unhooked graph's."""
    model = _model("pimref-100m", cuda)
    kw = dict(chunk=4)
    if spec != "off":
        kw.update(spec=spec, spec_k=K)
    cache, tok, hist, hist_len = _hook_inputs(model, cuda, spec)
    plain = (clone_cache(cache), tok.clone(),
             None if hist is None else hist.clone(),
             None if hist is None else hist_len.clone())
    if spec == "off":
        want, want_cache = _run(make_generate_step(model, **kw), plain[0],
                                plain[1], 3)
    else:
        want = _spec_run(make_generate_step(model, **kw), *plain, 3)
        want_cache = plain[0]
    arm = torch.full((tok.shape[0],), -1, dtype=torch.int32, device=cuda)
    got = _hook_run(make_generate_step(model, logits_hook=nan_logits_hook,
                                       **kw), cache, tok, hist, hist_len,
                    arm, 3)
    assert torch.equal(got, want)
    _same_cache(cache, want_cache)


@pytest.mark.cuda
def test_shed_program_captures_once(cuda):
    """A shed level is a new program: its first chunk captures its graph
    once (recorded in ``shed_capture_seconds``), the level-0 program keeps
    its graph, and the drain's tokens equal an unshed engine's."""
    model = _model("pimref-100m", cuda)
    kw = dict(model=model, slots=3, prompt_len=16, gen=12, chunk=4)
    reqs = _requests(model.cfg.vocab_size)
    want = tserve.make_queue_engine(**kw).run(list(reqs))

    class FlagOnce:
        flagged = []

        def step_start(self):
            pass

        def step_end(self, idx):
            return {"step": idx} if idx == 1 else None

    eng = tserve.make_queue_engine(shed_after=1, **kw)
    eng._straggler = FlagOnce()
    got = eng.run(list(reqs))
    s = eng.stats
    assert s["shed_events"] == 1 and eng._gen_shed.chunk == 2
    assert eng._gen_shed.captures == 1 and eng._generate.captures == 1
    assert eng._generate._captured is not None
    assert s["graph_captures"] == 2
    assert len(s["shed_capture_seconds"]) == 1
    assert s["shed_capture_seconds"][0] > 0
    key = lambda c: c.uid  # noqa: E731
    assert [(c.uid, list(c.tokens)) for c in sorted(got, key=key)] == \
        [(c.uid, list(c.tokens)) for c in sorted(want, key=key)]


@pytest.mark.cuda
def test_mp_shard_kill_is_a_real_terminate_and_fails_over(cuda):
    """Two spawned workers, each building its engine on the card from the
    same seed; a kill at fleet step 2 terminates worker 1's process; the
    fleet notices, fails over, and every request completes once, equal to
    one engine's drain on the card."""
    cfg = get_config("pimref-100m", smoke=True).replace(head_dim=64)
    kw = dict(slots=3, prompt_len=16, gen=12, chunk=4, page_size=PAGE,
              cfg=cfg, seed=0)
    reqs = _requests(cfg.vocab_size)
    want = tserve.make_queue_engine(device="cuda", **kw).run(list(reqs))
    fleet = tserve.make_fleet(backend="mp", shards=2, device="cuda",
                              fleet_chaos=ShardChaosConfig.parse("kill=1@2"),
                              **kw)
    try:
        assert all(sh.info["device"].startswith("cuda")
                   for sh in fleet.shards)
        got = fleet.run(list(reqs))
        assert sorted(c.uid for c in got) == [r.uid for r in reqs]
        assert fleet.stats["failovers"] == 1
        assert not fleet.shards[1].proc.is_alive()
        key = lambda c: c.uid  # noqa: E731
        assert [(c.uid, list(c.tokens)) for c in sorted(got, key=key)] == \
            [(c.uid, list(c.tokens)) for c in sorted(want, key=key)]
    finally:
        fleet.close()
