"""The port's RG-LRU recurrence (repro_torch.kernels.rglru and
repro_torch.models.rglru) against the JAX reference, in fp32 on the CPU:
the plain version of the recurrence kernel against the reference's
associative-scan oracle and its Pallas kernel in interpret mode, the
folding of an initial state, the gates, the causal conv and the recurrent
block with and without a carried state; the recurrence under autograd
(``RglruScanFn``: the op run backwards in time) against ``jax.grad`` of the
reference's associative scan and autograd through the plain loop, in
float64 by ``gradcheck``, and bit for bit against ``rglru_scan_bwd_ref``.
Inputs are seeded numpy."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.kernels.rglru import rglru_scan as jrglru_kernel  # noqa: E402
from repro.kernels.rglru import rglru_scan_ref as jrglru_ref  # noqa: E402
from repro.models import rglru as jr  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels.rglru import (LAUNCHES, RglruScanFn,  # noqa: E402
                                       rglru_scan, rglru_scan_bwd_ref,
                                       rglru_scan_kernel, rglru_scan_ref)
from repro_torch.kernels.rglru import kernel as rk  # noqa: E402
from repro_torch.models import rglru as tr  # noqa: E402

# the recurrence in fp32: the sequential loop and the associative scan
# round in another order; |h| stays below ~3 for these inputs
SCAN_ATOL = 1e-5
# the block: a_t close to 1 makes sqrt(1 - a_t^2) turn one-ulp differences
# between XLA's and PyTorch's exp / sigmoid into ~1e-5 relative
# differences of the gated input
BLOCK_RTOL, BLOCK_ATOL = 1e-4, 1e-5


def _ab(seed, B, T, D):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.7, 0.999, (B, T, D)).astype(np.float32)
    b = (rng.standard_normal((B, T, D)) * 0.1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("B,T,D,bt", [(1, 256, 64, 128), (2, 512, 128, 128),
                                      (1, 128, 256, 64)])
def test_plain_scan_matches_reference_and_interpret_kernel(B, T, D, bt):
    a, b = _ab(0, B, T, D)
    got = rglru_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jrglru_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=SCAN_ATOL, rtol=0)
    kern = np.asarray(jrglru_kernel(jnp.asarray(a), jnp.asarray(b),
                                    block_t=bt, interpret=True))
    np.testing.assert_allclose(got, kern, atol=SCAN_ATOL, rtol=0)


@pytest.mark.parametrize("B,T,D", [(1, 1, 64), (2, 3, 100), (1, 1000, 100)])
def test_plain_scan_edge_shapes(B, T, D):
    """T 1, T odd, D off any block multiple: against the associative scan,
    and bit for bit against the elementwise update written out."""
    a, b = _ab(1, B, T, D)
    got = rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jrglru_ref(jnp.asarray(a), jnp.asarray(b))),
        atol=SCAN_ATOL, rtol=0)
    h = np.zeros((B, D), np.float32)
    want = np.empty_like(b)
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_wrapper_takes_only_card_tensors():
    """The CUDA wrapper raises for tensors on the CPU (ops dispatches those
    to the plain version) and for mismatched shapes; it counts nothing."""
    a = torch.rand(2, 5, 8)
    n = LAUNCHES["rglru_scan"]
    with pytest.raises(ValueError, match="card"):
        rglru_scan_kernel(a, a)
    with pytest.raises(ValueError, match="one shape"):
        rglru_scan_kernel(a, a[:, :4])
    assert LAUNCHES["rglru_scan"] == n
    torch.testing.assert_close(rglru_scan(a, a), rglru_scan_ref(a, a),
                               atol=0, rtol=0)
    assert LAUNCHES["rglru_scan"] == n


@pytest.mark.parametrize("B,T,D", [(8, 512, 2560), (2, 2100, 2560),
                                   (1, 2100, 99), (3, 5, 2500), (1, 1, 4),
                                   (16, 4096, 4096)])
@pytest.mark.parametrize("aligned", [True, False])
def test_kernel_plan(B, T, D, aligned):
    """The CUDA kernel's plan: every channel of every batch row in exactly
    one block, the ring within the card's shared memory, TMA (16-byte
    rows) only where rows are 16-byte aligned; both Griffin prefill shapes
    give at least one block an SM and keep at least 3.5 MB in flight."""
    p = rk.plan(B, T, D, aligned=aligned)
    tiles = -(-D // p.tile)
    assert p.blocks == B * tiles and (tiles - 1) * p.tile < D <= tiles * p.tile
    assert p.smem <= rk.SMEM_LIMIT
    assert p.vec == (16 if aligned and D % 4 == 0 else 4)
    if (B, T, D) in ((8, 512, 2560), (2, 2100, 2560)):
        assert p.blocks >= 132
        assert p.blocks * (p.stages - 1) * p.rows * p.tile * 2 * 4 >= 3.5e6


@pytest.fixture(scope="module")
def cfgs():
    jcfg = get_config("recurrentgemma-2b", smoke=True).replace(
        compute_dtype="float32")
    tcfg = tconfigs.get_config("recurrentgemma-2b", smoke=True).replace(
        compute_dtype="float32")
    return jcfg, tcfg


def _params(tcfg, seed=0):
    """RG-LRU block weights from numpy: normal / sqrt(fan_in), lam the
    logit of U[0.9, 0.999], a non-zero conv bias."""
    rng = np.random.default_rng(seed)
    p = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
             ).astype(np.float32)
         for k, s in tr.rglru_param_specs(tcfg, torch.float32).items()}
    u = rng.uniform(0.9, 0.999, tcfg.d_model)
    p["lam"] = (np.log(u) - np.log1p(-u)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=BLOCK_RTOL,
                               atol=BLOCK_ATOL)


def test_gates_match(cfgs):
    jcfg, tcfg = cfgs
    jp, tp = _params(tcfg)
    xb = _x(2, (2, 9, tcfg.d_model))
    jl, jb = jr._gates(jcfg, jp, jnp.asarray(xb))
    tl, tb = tr._gates(tcfg, tp, torch.from_numpy(xb))
    _close(tl, jl)
    _close(tb, jb)


@pytest.mark.parametrize("S", [1, 7])
def test_scan_folds_initial_state(cfgs, S):
    """h0 folds into b[:, 0]: the scan from h0 matches the reference's, and
    a prefix then the rest from its state matches one scan over the whole."""
    jcfg, tcfg = cfgs
    jp, tp = _params(tcfg)
    xb = _x(3, (2, 12 + S, tcfg.d_model))
    h0 = _x(4, (2, tcfg.d_model))
    jy, jh = jr.rglru_scan(jcfg, jp, jnp.asarray(xb), jnp.asarray(h0))
    ty, th = tr.rglru_scan(tcfg, tp, torch.from_numpy(xb),
                           torch.from_numpy(h0))
    _close(ty, jy)
    _close(th, jh)
    assert th.dtype == torch.float32
    whole, h_whole = tr.rglru_scan(tcfg, tp, torch.from_numpy(xb))
    y1, h1 = tr.rglru_scan(tcfg, tp, torch.from_numpy(xb[:, :12]))
    y2, h2 = tr.rglru_scan(tcfg, tp, torch.from_numpy(xb[:, 12:]), h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), whole, atol=SCAN_ATOL,
                               rtol=0)
    torch.testing.assert_close(h2, h_whole, atol=SCAN_ATOL, rtol=0)


@pytest.mark.parametrize("S,with_state", [(6, False), (1, True), (5, True)])
def test_causal_conv_matches(cfgs, S, with_state):
    _, tcfg = cfgs
    jp, tp = _params(tcfg)
    x = _x(5, (2, S, tcfg.d_model))
    st = _x(6, (2, tcfg.conv_width - 1, tcfg.d_model)) if with_state else None
    jo, js = jr.causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"],
                            None if st is None else jnp.asarray(st))
    to, ts = tr.causal_conv(torch.from_numpy(x), tp["conv_w"], tp["conv_b"],
                            None if st is None else torch.from_numpy(st))
    # the same fp32 products summed in the same order
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("S,with_state", [(9, False), (1, True), (6, True)])
def test_recurrent_block_matches(cfgs, S, with_state):
    """No state (prefill), a one-token step and an S > 1 block from a
    carried state: output and new state."""
    jcfg, tcfg = cfgs
    jp, tp = _params(tcfg)
    x = _x(7, (2, S, tcfg.d_model))
    jst = tst = None
    if with_state:
        h = _x(8, (2, tcfg.d_model))
        conv = _x(9, (2, tcfg.conv_width - 1, tcfg.d_model))
        jst = {"h": jnp.asarray(h), "conv": jnp.asarray(conv)}
        tst = {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv)}
    jo, js = jr.recurrent_block(jcfg, jp, jnp.asarray(x), jst)
    to, ts = tr.recurrent_block(tcfg, tp, torch.from_numpy(x), tst)
    _close(to, jo)
    _close(ts["h"], js["h"])
    _close(ts["conv"], js["conv"])


def test_init_rglru_state_matches(cfgs):
    jcfg, tcfg = cfgs
    j = jr.init_rglru_state(jcfg, 3)
    t = tr.init_rglru_state(tcfg, 3)
    for n in ("h", "conv"):
        assert tuple(t[n].shape) == j[n].shape
        assert str(t[n].dtype).split(".")[-1] == str(j[n].dtype)
        assert not t[n].any()


# ---------------------------------------------------------------------------
# the recurrence under autograd
# ---------------------------------------------------------------------------
def _abg(seed, B, T, D):
    a, b = _ab(seed, B, T, D)
    dh = np.random.default_rng(seed + 7).standard_normal((B, T, D)).astype(
        np.float32)
    return a, b, dh


def _fn_grads(a, b, dh):
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    h = RglruScanFn.apply(ta, tb)
    return (h.detach(),) + torch.autograd.grad(h, (ta, tb),
                                               torch.from_numpy(dh))


@pytest.mark.parametrize("B,T,D", [(1, 1, 8), (2, 37, 64), (1, 512, 96)])
def test_scan_grads_match_reference_and_autograd_of_loop(B, T, D):
    """da, db of the Function against ``jax.grad`` of the reference's
    associative scan (``repro.models.rglru.rglru_scan``'s combine) and
    against autograd through the plain loop."""
    a, b, dh = _abg(2, B, T, D)
    h, da, db = _fn_grads(a, b, dh)

    def scan(a_, b_):
        def op(e1, e2):
            return e1[0] * e2[0], e2[0] * e1[1] + e2[1]
        return jax.lax.associative_scan(op, (a_, b_), axis=1)[1]

    jh, vjp = jax.vjp(scan, jnp.asarray(a), jnp.asarray(b))
    jda, jdb = vjp(jnp.asarray(dh))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=SCAN_ATOL,
                               rtol=0)
    # the adjoint sums dh over up to T steps of decay a <= 0.999
    scale = max(np.abs(np.asarray(jdb)).max(), 1.0)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb),
                               atol=SCAN_ATOL * scale, rtol=0)
    np.testing.assert_allclose(da.numpy(), np.asarray(jda),
                               atol=SCAN_ATOL * scale, rtol=0)
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    la, lb = torch.autograd.grad(rglru_scan_ref(ta, tb), (ta, tb),
                                 torch.from_numpy(dh))
    np.testing.assert_allclose(db.numpy(), lb.numpy(),
                               atol=SCAN_ATOL * scale, rtol=0)
    np.testing.assert_allclose(da.numpy(), la.numpy(),
                               atol=SCAN_ATOL * scale, rtol=0)


def test_scan_gradcheck_float64():
    a, b, _ = _abg(3, 2, 9, 5)
    args = (torch.from_numpy(a.astype(np.float64)).requires_grad_(True),
            torch.from_numpy(b.astype(np.float64)).requires_grad_(True))
    assert torch.autograd.gradcheck(RglruScanFn.apply, args, eps=1e-6,
                                    atol=1e-7)


@pytest.mark.parametrize("B,T,D", [(1, 1, 8), (2, 37, 64), (1, 300, 100)])
def test_scan_backward_bitwise_bwd_ref(B, T, D):
    """The Function's backward on the CPU (the plain loop over the
    reversed sequences) equals ``rglru_scan_bwd_ref`` bit for bit, -0.0
    included: the card's kernel backward is held to the same function. No
    kernel launched, so neither count moves."""
    a, b, dh = _abg(4, B, T, D)
    dh[0, -1, :3] = -0.0
    before = dict(LAUNCHES)
    h, da, db = _fn_grads(a, b, dh)
    assert LAUNCHES == before
    wa, wb = rglru_scan_bwd_ref(*(torch.from_numpy(x) for x in (a, h.numpy(),
                                                                dh)))
    assert da.numpy().tobytes() == wa.numpy().tobytes()
    assert db.numpy().tobytes() == wb.numpy().tobytes()


def test_block_grads_match_reference(cfgs):
    """Gradients of the recurrent block (gates, conv, the recurrence)
    through the Function against ``jax.grad`` of the reference's block."""
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(9)
    D = jcfg.d_model
    x = (rng.standard_normal((2, 24, D)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((2, 24, D)).astype(np.float32)
    from repro_torch.models.module import init_tensor
    specs = tr.rglru_param_specs(tcfg, torch.float32)
    gen = torch.Generator().manual_seed(0)
    p = {k: init_tensor(s, gen).numpy() for k, s in specs.items()}

    def jblock(p_, x_):
        return jr.recurrent_block(jcfg, p_, x_)[0]

    _, vjp = jax.vjp(jblock, {k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(dy))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tr.recurrent_block(tcfg, tp, tx)[0]
    names = sorted(tp)
    grads = torch.autograd.grad(y, [tp[k] for k in names] + [tx],
                                torch.from_numpy(dy))
    for name, g, jg in zip(names + ["x"], grads,
                           [jgp[k] for k in names] + [jgx]):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=BLOCK_RTOL * np.abs(jg).max(),
                                   err_msg=name)
