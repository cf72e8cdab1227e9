"""The attention kernels' head dims 80 and 112 on the CPU: stablelm-3b's
(2560 / 32, MHA) and kimi-k2-1t-a32b's (112, 64 q heads on 8 kv heads).

* the decode layouts' plain versions (contiguous values, int8 and int4
  codes, pages, pages of codes) against the reference's Pallas kernels in
  interpret mode, in fp32, at both head dims;
* the copy alignment the CUDA decode kernel asks of K/V rows: 8 bytes for
  int4 rows of 40 and 56 bytes, whose odd rows start 8 bytes off a 16-byte
  boundary, 16 for every other row, checked exactly;
* the ``meta`` path that the dry-run and DAMOV count through: the kernel
  entries take D 80 and 112 and still refuse D 96;
* greedy tokens of both smoke models at their published head dims against
  the reference's, in fp32, in the contiguous, int8, int4 and paged16
  layouts.
* the attention libraries' translation units (one a head dim, compiled in
  parallel and linked) and the chunked init of kimi-k2's expert leaves.

The CUDA kernels at these head dims are held to their plain versions on a
card by test_torch_kernels_cuda.py; the prefill routes' emulations at these
head dims are in test_torch_flash_attention.py."""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.core.mimdram import plan_sharding, use_plan  # noqa: E402
from repro.kernels.flash_attention import ops as jops  # noqa: E402
from repro.models import build_model, init_params  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models.layers import ring_position_ids  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import accounting  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as tk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

ATOL = 1e-5
KNOBS = ("REPRO_KV_PAGES", "REPRO_KV_QUANT", "REPRO_SPEC_DECODE")
# head dim: (arch, kv heads, q heads a kv head) of the shapes tested here,
# the archs' own grouping (stablelm-3b MHA, kimi-k2 eight q heads a kv head)
# at a few heads
HEADS = {80: ("stablelm-3b", 3, 1), 112: ("kimi-k2-1t-a32b", 2, 8)}


@pytest.fixture(autouse=True)
def _plain_reference(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().cpu().float().numpy(),
                               np.asarray(j, np.float32), atol=atol, rtol=0)


def _ring(depths, S, T):
    qp = np.stack([np.arange(d, d + S) for d in depths]).astype(np.int32)
    kp = np.concatenate([np.asarray(ring_position_ids(1, d + S, T))
                         for d in depths]).astype(np.int32)
    return qp, kp


def _codes(rng, shape, mode):
    q = jl.kv_quantize(jnp.asarray(_np(rng, *shape)), mode)
    return np.array(q.codes), np.array(q.scale)


def _table(rng, B, NP, kp, ps):
    table = (rng.permutation(B * NP) + 1).astype(np.int32).reshape(B, NP)
    table[1, 0] = table[0, 0]
    table[0][(kp[0].reshape(NP, ps) < 0).all(axis=1)] = 0
    return table


# ---------------------------------------------------------------------------
# decode layouts against the reference's kernels in interpret mode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", [80, 112])
@pytest.mark.parametrize("layout,mode", [
    ("dense", "off"), ("dense", "int8"), ("dense", "int4"), ("paged", "off"),
    ("paged", "int8"), ("paged", "int4")])
def test_decode_layouts_match_reference(D, layout, mode):
    """Every decode layout in the model's layout (ops), one token a slot
    over a ring of 48 rows (slot 1 past it: wrapped), a window of 40, the
    int4 caches' odd rows 8 bytes off a 16-byte boundary: the plain
    versions within ATOL of the reference kernels (fp32, summation order);
    paged equal to dense on the gathered pages."""
    rng = np.random.default_rng(D + 3 * len(layout) + len(mode))
    _, Hkv, G = HEADS[D]
    B, ps, NP = 2, 16, 3
    T = NP * ps
    q = _np(rng, B, 1, Hkv * G, D)
    qp, kp = _ring([21, 70], 1, T)
    kw = dict(causal=True, window=40, softcap=0.0)
    jnps = lambda *a: [jnp.asarray(x) for x in a]  # noqa: E731
    if layout == "dense":
        if mode == "off":
            ops = (_np(rng, B, T, Hkv, D), _np(rng, B, T, Hkv, D))
            want = jops.flash_decode(*jnps(q, *ops, qp, kp), block_k=16,
                                     interpret=True, **kw)
            got = tops.flash_decode(*_t(q, *ops, qp, kp), **kw)
        else:
            ops = (_codes(rng, (B, T, Hkv, D), mode)
                   + _codes(rng, (B, T, Hkv, D), mode))
            want = jops.flash_decode_quant(*jnps(q, *ops, qp, kp),
                                           block_k=16, interpret=True, **kw)
            got = tops.flash_decode_quant(*_t(q, *ops, qp, kp), **kw)
        if mode == "int4":
            assert ops[0].shape[-1] * ops[0].itemsize == D // 2
    else:
        P = 1 + B * NP
        table = _table(rng, B, NP, kp, ps)
        if mode == "off":
            ops = (_np(rng, P, ps, Hkv, D), _np(rng, P, ps, Hkv, D))
            jfn, tfn = jops.flash_decode_paged, tops.flash_decode_paged
        else:
            ops = (_codes(rng, (P, ps, Hkv, D), mode)
                   + _codes(rng, (P, ps, Hkv, D), mode))
            jfn = jops.flash_decode_paged_quant
            tfn = tops.flash_decode_paged_quant
        want = jfn(*jnps(q, *ops, table, qp, kp), interpret=True, **kw)
        got = tfn(*_t(q, *ops, table, qp, kp), **kw)
        gathered = [ref.gather_pages(p, torch.from_numpy(table)
                                     ).transpose(1, 2) for p in _t(*ops)]
        dense = (tops.flash_decode(_t(q)[0], *gathered, *_t(qp, kp), **kw)
                 if mode == "off" else
                 tops.flash_decode_quant(_t(q)[0], *gathered, *_t(qp, kp),
                                         **kw))
        assert torch.equal(got, dense)
    assert got.shape == (B, 1, Hkv * G, D)
    _close(got, want)


# ---------------------------------------------------------------------------
# the decode kernel's copy alignment
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", [64, 80, 112, 128, 256])
def test_copy_alignment_by_row(D):
    """A row is copied in 16-byte chunks where its bytes allow, else in
    8-byte ones: only int4 codes at D 80 and 112 (40 and 56 bytes)."""
    rows = {"fp32": 4 * D, "bf16": 2 * D, "int8": D, "int4": D // 2}
    want = {k: 16 for k in rows}
    if D in (80, 112):
        want["int4"] = 8
    assert {k: tk.copy_align(n) for k, n in rows.items()} == want


@pytest.mark.parametrize("D", [80, 112])
@pytest.mark.parametrize("paged", [False, True])
def test_int4_cache_rows_pass_the_exact_alignment(D, paged):
    """The model's int4 cache (contiguous (B, T, Hkv, D / 2) codes, or
    pools (P, ps, Hkv, D / 2)), as the decode wrappers receive it: its odd
    rows and heads start 8 bytes off a 16-byte boundary, so it passes the
    8-byte rule the kernel copies by and would fail a 16-byte one; a view
    4 bytes off fails the 8-byte rule."""
    Hkv = HEADS[D][1]
    cache = tl.kv_cache_init((2, 32, Hkv, D), torch.float32, "int4",
                             16 if paged else 0)
    codes = cache.pages.codes if paged else cache.codes
    view = codes if paged else codes.transpose(1, 2)   # the kernel layout
    assert view.shape[-1] == D // 2 and view.dtype == torch.int8
    align = tk.copy_align(view.shape[-1] * view.element_size())
    assert align == 8
    tk._check_aligned((("k", view),), "decode", align)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tk._check_aligned((("k", view),), "decode", 16)
    flat = torch.zeros(view.numel() + 16, dtype=torch.int8)
    start = (-flat.data_ptr()) % 8 + 4                 # 4 bytes off
    off = flat[start:start + view.numel()].view(view.shape)
    with pytest.raises(ValueError, match="8-byte aligned"):
        tk._check_aligned((("k", off),), "decode", align)


# ---------------------------------------------------------------------------
# the meta path (dry-run, DAMOV)
# ---------------------------------------------------------------------------
class _Counter:
    """A step counter that records the kernel reports."""

    def __init__(self):
        self.kernels = {}

    def kernel_report(self, name, flops, nbytes):
        self.kernels[name] = self.kernels.get(name, 0) + 1

    @contextlib.contextmanager
    def paused(self):
        yield


@pytest.mark.parametrize("D", [80, 112, 96])
def test_meta_entries_take_the_new_head_dims(D):
    """On ``meta`` under a counter every entry answers at D 80 and 112
    (int4 codes included) with outputs of the kernel's shapes; D 96, which
    no kernel takes, raises ValueError as on the card."""
    meta = dict(device="meta")
    B, H, G, S, T, ps = 2, 2, 4, 3, 32, 16
    q = torch.zeros(B, H, G, S, D, **meta)
    kv = torch.zeros(B, H, T, D, **meta)
    qp = torch.zeros(B, S, dtype=torch.int32, **meta)
    kp = torch.zeros(B, T, dtype=torch.int32, **meta)
    codes = torch.zeros(B, H, T, D // 2, dtype=torch.int8, **meta)
    scale = torch.zeros(B, H, T, **meta)
    pool = torch.zeros(1 + B * 2, ps, H, D, **meta)
    pcodes = torch.zeros(1 + B * 2, ps, H, D // 2, dtype=torch.int8, **meta)
    pscale = torch.zeros(1 + B * 2, ps, H, **meta)
    table = torch.zeros(B, 2, dtype=torch.int32, **meta)
    calls = {
        "flash_attention_fwd": lambda: tk.flash_attention_fwd(q, kv, kv, qp,
                                                              kp)[0],
        "flash_decode_fwd": lambda: tk.flash_decode_fwd(q, kv, kv, qp, kp),
        "flash_decode_quant_fwd": lambda: tk.flash_decode_quant_fwd(
            q, codes, scale, codes, scale, qp, kp),
        "flash_decode_paged_fwd": lambda: tk.flash_decode_paged_fwd(
            q, pool, pool, table, qp, kp),
        "flash_decode_paged_quant_fwd": lambda: tk.flash_decode_paged_quant_fwd(
            q, pcodes, pscale, pcodes, pscale, table, qp, kp)}
    with accounting.counting(_Counter()) as counter:
        for name, call in calls.items():
            if D in tk.KERNEL_HEAD_DIMS:
                out = call()
                assert out.shape == q.shape and out.device.type == "meta"
            else:
                with pytest.raises(ValueError, match="head_dim 96"):
                    call()
    assert counter.kernels == dict.fromkeys(calls, 1)


# ---------------------------------------------------------------------------
# greedy tokens of the two models at their published head dims
# ---------------------------------------------------------------------------
_REFS = {}


def _ref(arch):
    """The smoke config at the published head dim, fp32: the reference
    (mesh-less) with its weights, and the port's config."""
    if arch not in _REFS:
        D = tconfigs.get_config(arch).resolved_head_dim
        kw = dict(compute_dtype="float32", head_dim=D)
        jcfg = get_config(arch, smoke=True).replace(**kw)
        tcfg = tconfigs.get_config(arch, smoke=True).replace(**kw)
        plan = plan_sharding(jcfg, ShapeConfig("serve", 32, 2, "decode"),
                             None)
        jm = build_model(jcfg)
        with use_plan(plan):
            params = init_params(jm.param_specs(), jax.random.PRNGKey(0))
        _REFS[arch] = (jm, params, plan, tcfg,
                       jax.tree_util.tree_map(np.asarray, params))
    return _REFS[arch]


@pytest.mark.parametrize("kv_quant,pages", [
    ("off", 0), ("int8", 0), ("int4", 0), ("off", 16)])
@pytest.mark.parametrize("arch", ["stablelm-3b", "kimi-k2-1t-a32b"])
def test_greedy_tokens_at_published_head_dim(arch, kv_quant, pages,
                                             monkeypatch):
    """Prefill of 2 x 11 tokens, then 10 greedy steps (a ring of 16 or
    pages of 16 over 32 positions), the port's layout arguments against
    the reference under REPRO_KV_QUANT / REPRO_KV_PAGES: identical tokens
    and positions, logits within 1e-3 (the int codes may tip on a rounding
    edge in another summation order), the cache's head dim the published
    one."""
    jm, params, plan, tcfg, np_params = _ref(arch)
    assert tcfg.resolved_head_dim == {"stablelm-3b": 80,
                                      "kimi-k2-1t-a32b": 112}[arch]
    monkeypatch.setenv("REPRO_KV_QUANT", kv_quant)
    monkeypatch.setenv("REPRO_KV_PAGES", str(pages))
    tm = tserve.load_model(arch, smoke=True, seed=0, device="cpu", cfg=tcfg,
                           params=np_params, kv_quant=kv_quant,
                           page_size=pages)
    max_len, steps = (32 if pages else 16), 10
    assert tm.cache_len(max_len) == jm.cache_len(max_len)
    toks = np.random.default_rng(11).integers(
        0, tcfg.vocab_size, (2, 11)).astype(np.int32)
    decode = jax.jit(jm.decode_step)
    with use_plan(plan):
        jlg, jc = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                             max_len=max_len)
        tlg, tc = tm.prefill(torch.from_numpy(toks), max_len=max_len)
        jout, tout = [], []
        for _ in range(steps):
            jt = jnp.argmax(jlg[:, -1:], axis=-1).astype(jnp.int32)
            tt = torch.argmax(tlg[:, -1:], dim=-1).to(torch.int32)
            jout.append(np.asarray(jt))
            tout.append(tt.numpy())
            jlg, jc = decode(params, jc, jt)
            tlg, tc = tm.decode_step(tc, tt)
        _close(tlg, jlg, 1e-3)
    np.testing.assert_array_equal(np.concatenate(tout, 1),
                                  np.concatenate(jout, 1))
    np.testing.assert_array_equal(tc["pos_ids"].numpy(),
                                  np.asarray(jc["pos_ids"]))
    k = tc["k"].pages if pages else tc["k"]
    k = k if kv_quant == "off" else k.codes
    assert k.shape[-1] == (tcfg.resolved_head_dim // 2 if kv_quant == "int4"
                           else tcfg.resolved_head_dim)


# ---------------------------------------------------------------------------
# the attention libraries' translation units and the chunked init
# ---------------------------------------------------------------------------
def test_attention_sources_split_by_head_dim():
    """Both attention libraries are a source plus one part a head dim the
    kernels take (their instantiations compile in parallel); a part is no
    library of its own, and the library's name covers every part."""
    from repro_torch.kernels import build
    srcs = build.sources()
    assert not [n for n in srcs if "." in n]
    for name in ("flash_decode", "flash_prefill"):
        units = [p.name for p in build.parts(srcs[name])]
        assert units == [f"{name}.cu"] + sorted(
            f"{name}.d{d}.cu" for d in tk.KERNEL_HEAD_DIMS)
    assert build.parts(srcs["rglru"]) == [srcs["rglru"]]


def test_build_compiles_parts_then_links(monkeypatch, tmp_path):
    """Every translation unit, a library's source and each of its parts:
    one ``nvcc -c``, all started together, then one link of a library's
    objects into it (a library of one unit too); the objects are removed
    and the units' times recorded."""
    from repro_torch.kernels import build
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {calls}\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then touch \"$2\"; fi; shift\n"
        "done\n"
        "echo 'ptxas info    : Used 32 registers'\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "BUILD_INFO", {})
    info = build.build_all(["flash_decode", "rglru"])
    lines = calls.read_text().splitlines()
    srcs = build.sources()
    units = build.parts(srcs["flash_decode"])
    compiled = [ln for ln in lines if " -c " in f" {ln} "]
    assert sorted(ln.split()[-1] for ln in compiled) == sorted(
        str(u) for u in [*units, srcs["rglru"]])
    assert all("-shared" not in ln.split() for ln in compiled)
    links = [ln for ln in lines if "-shared" in ln.split()]
    assert sorted(len([w for w in ln.split() if w.endswith(".o")])
                  for ln in links) == [1, len(units)]
    assert lines[-len(links):] == links          # after every compile
    assert sorted(info["flash_decode"]["parts"]) == sorted(
        u.name for u in units)
    assert list(info["rglru"]["parts"]) == ["rglru.cu"]
    assert "registers" in info["flash_decode"]["log"]
    assert "registers" in info["rglru"]["log"]
    for name in ("flash_decode", "rglru"):
        assert build.library_path(srcs[name]).exists()
    assert not list((tmp_path / "kernels").glob("*.o"))


def test_huge_normal_leaf_is_drawn_in_chunks(monkeypatch):
    """A "normal" leaf past INIT_CHUNK elements is drawn INIT_CHUNK at a
    time, each part scaled and cast as a whole leaf is, so no fp32 copy of
    the whole leaf is made (kimi-k2's expert leaves take 22.5 GB as one); a
    smaller leaf gets the values of one draw of its shape, as before. A
    CUDA generator draws the parts the same way, with values of its own;
    no test here holds them (no card)."""
    from repro_torch.models import module
    monkeypatch.setattr(module, "INIT_CHUNK", 1000)
    spec = module.ParamSpec((3, 700), torch.bfloat16, ("a", "b"))
    got = module.init_tensor(spec, torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    scale = 1.0 / np.sqrt(3)      # fan axis 0
    want = torch.cat([torch.randn(n, generator=g) * scale
                      for n in (1000, 1000, 100)]).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 700)
    assert torch.equal(got.view(-1), want)
    small = module.ParamSpec((10, 100), torch.float32, ("a", "b"))
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    assert torch.equal(module.init_tensor(small, g1),
                       torch.randn((10, 100), generator=g2)
                       * (1.0 / np.sqrt(10)))
