"""The port's data stream, cross-entropy, optimizers, schedule and clipping
(repro_torch.data, repro_torch.models.layers.softmax_xent,
repro_torch.optim) against the JAX reference on the same numpy inputs, on
the CPU. The stream must be byte-identical; the fp32 arithmetic within the
tolerances stated below."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ShapeConfig, get_config  # noqa: E402
from repro.configs.base import RunConfig  # noqa: E402
from repro.data import make_batch_fn, pack_documents  # noqa: E402
from repro.launch.train import _salted_seed  # noqa: E402
from repro.models.layers import softmax_xent  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.layers import softmax_xent as tsoftmax_xent  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

# fp32 optimizer arithmetic: the same operations in the same order, so the
# two sides differ only where XLA and PyTorch round a transcendental (the
# schedule's cosine, the bias corrections' powers) or a reduction
# differently: a few ulp of a tensor's largest value
OPT_RTOL = 2e-6
XENT_TOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(t, j, rtol=OPT_RTOL):
    """Within ``rtol`` of the largest |value| of the reference's tensor."""
    want = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# data stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("salt", [0, 1, 3])
@pytest.mark.parametrize("seed", [0, 7])
def test_batch_stream_byte_identical(seed, salt):
    jcfg = get_config("pimref-100m", smoke=True)
    tcfg = tconfigs.get_config("pimref-100m", smoke=True)
    s = _salted_seed(seed, salt)
    assert ttrain._salted_seed(seed, salt) == s
    jshape = ShapeConfig("custom", seq_len=48, global_batch=3, mode="train")
    tshape = tconfigs.ShapeConfig("custom", seq_len=48, global_batch=3,
                                  mode="train")
    jfn, tfn = make_batch_fn(jcfg, jshape, seed=s), tdata.make_batch_fn(
        tcfg, tshape, seed=s)
    for step in (0, 1, 5, 123):
        a, b = jfn(step), tfn(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), (step, k)


def test_pack_documents_identical():
    rng = np.random.default_rng(4)
    docs = [list(rng.integers(1, 50, rng.integers(1, 20))) for _ in range(9)]
    for a, b in zip(pack_documents(docs, 16, eos=0),
                    tdata.pack_documents(docs, 16, eos=0)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# cross-entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_xent(masked, dtype):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 11, 97)) * 4).astype(np.float32)
    labels = rng.integers(0, 97, (3, 11)).astype(np.int32)
    mask = (rng.random((3, 11)) < 0.6).astype(np.float32) if masked else None
    jl = jnp.asarray(logits).astype(dtype)
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    want = softmax_xent(jl, jnp.asarray(labels),
                        None if mask is None else jnp.asarray(mask))
    got = tsoftmax_xent(tl, torch.from_numpy(labels),
                        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=XENT_TOL)


def test_softmax_xent_all_masked_is_zero():
    logits = torch.zeros(1, 4, 8)
    got = tsoftmax_xent(logits, torch.zeros(1, 4, dtype=torch.int32),
                        torch.zeros(1, 4))
    assert got.item() == 0.0


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
def _tree(rng, scale=1.0):
    """A parameter-like tree: stacked blocks, vectors, a matrix."""
    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"blocks": {"ln1": a(3, 8), "attn": {"w_q": a(3, 8, 2, 4)},
                       "mlp": {"wo": a(3, 16, 8)}},
            "embed": a(32, 8), "final_norm": a(8), "head": a(8, 32)}


def _run(name, **kw):
    jrun = RunConfig(learning_rate=1e-2, warmup_steps=2, total_steps=7, **kw)
    trun = tconfigs.RunConfig(learning_rate=1e-2, warmup_steps=2,
                              total_steps=7, **kw)
    return jopt.make_optimizer(name, jrun), topt.make_optimizer(name, trun)


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_optimizer_steps_match_reference(name, clip):
    rng = np.random.default_rng(2)
    jo, to = _run(name, grad_clip=clip)
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(rng))
    tp = tree_map(_t, jax.tree_util.tree_map(np.asarray, jp))
    js, ts = jo.init(jp), to.init(tp)
    assert [tuple(x.shape) for x in leaves(ts)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(js)]
    for step in range(6):
        g = _tree(rng, scale=0.5 + step)
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = to.update(tree_map(_t, g), ts, tp)
        for a, b in zip(leaves(tp), jax.tree_util.tree_leaves(jp)):
            _close(a, b)
        for a, b in zip(leaves(ts), jax.tree_util.tree_leaves(js)):
            if a.dtype == torch.int32:
                assert a.item() == int(b)
            else:
                _close(a, b)


def test_cosine_schedule_matches_reference():
    jl = jopt.cosine_schedule(3e-4, 10, 100)
    tl = topt.cosine_schedule(3e-4, 10, 100)
    steps = np.arange(0, 120, 3, dtype=np.int32)
    want = np.asarray([float(jl(jnp.int32(s))) for s in steps])
    got = np.asarray([tl(torch.tensor(int(s), dtype=torch.int32)).item()
                      for s in steps])
    np.testing.assert_allclose(got, want, rtol=OPT_RTOL, atol=0)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(np.random.default_rng(3))
    jg, jn = jopt.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g),
                                      max_norm)
    tg, tn = topt.clip_by_global_norm(tree_map(_t, g), max_norm)
    np.testing.assert_allclose(tn.item(), float(jn), rtol=OPT_RTOL)
    np.testing.assert_allclose(topt.global_norm(tree_map(_t, g)).item(),
                               float(jopt.global_norm(g)), rtol=OPT_RTOL)
    for a, b in zip(leaves(tg), jax.tree_util.tree_leaves(jg)):
        _close(a, b)


def test_make_optimizer_rejects_unknown():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("lamb", tconfigs.RunConfig())
