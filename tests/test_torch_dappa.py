"""The port's DaPPA framework (``repro_torch.core.dappa``) against the
reference's (``repro.core.dappa``) on the CPU, with the same numpy inputs.

The cases of ``tests/test_core.py``'s DaPPA section run on both packages:
streams (``map``, ``zip``, ``window``, ``filter``) must agree bit for bit
(elementwise ops in fp32 on both); reductions within ``REDUCE_RTOL`` of
the reduction's scale (``sum |v|``): the port sums in torch's order, the
reference in XLA's, both in fp32. The reference's 8-device
``dappa_distributed`` pipelines run on 8 gloo ranks (``torch_dist_worker.py
dappa``): the port's mesh run equals its local run and the reference's
local run within 1e-5, the worker's own limit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_dist_worker as worker  # noqa: E402
from repro.core import dappa as jdappa  # noqa: E402
from repro_torch.core import dappa  # noqa: E402

# an fp32 sum of n terms in another order: within n ulps of sum |v|
REDUCE_RTOL = 2 ** -23
DIST_TOL = 1e-5


def _both(build, **inputs):
    """``build(pkg)`` -> outputs, compiled and run by both packages on the
    same numpy inputs; returns (port, reference) as numpy trees."""
    mine = dappa.compile_pipeline(build(dappa))(
        **{k: torch.from_numpy(v) for k, v in inputs.items()})
    ref = jdappa.compile_pipeline(build(jdappa))(
        **{k: jnp.asarray(v) for k, v in inputs.items()})
    return mine, ref


def _reduction_close(got, want, scale, n):
    assert abs(float(got) - float(want)) <= n * REDUCE_RTOL * scale, \
        (float(got), float(want))


def test_map_reduce():
    xs = np.arange(16.0, dtype=np.float32)
    got, want = _both(lambda p: p.input_stream("x").map(
        lambda v: v * 2).reduce("sum"), x=xs)
    assert float(got) == float(want) == float(2 * xs.sum())


def test_zip_filter_mean():
    xs = np.arange(-4.0, 4.0, dtype=np.float32)
    ys = np.full(8, 2.0, np.float32)

    def build(p):
        x, y = p.input_stream("x"), p.input_stream("y")
        prod = x.zip(y).map(lambda t: t[..., 0] * t[..., 1])
        return prod.filter(lambda v: v > 0).reduce("mean")
    got, want = _both(build, x=xs, y=ys)
    ref = xs * 2
    assert float(got) == float(want) == pytest.approx(ref[ref > 0].mean())


def test_window_sum():
    xs = np.arange(8.0, dtype=np.float32)
    got, want = _both(lambda p: p.input_stream("x").window(
        3, lambda w: w.sum(-1)), x=xs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got.numpy()[:6], np.convolve(
        xs, np.ones(3), mode="valid"))
    assert (got.numpy()[6:] == 0).all()


@pytest.mark.parametrize("w,shape", [(2, (16,)), (5, (16,)), (4, (12, 3))])
def test_window_gather(w, shape):
    """The single-gather window equals the reference's, bit for bit, for
    scalar and multi-dim stream elements (the masked tail filled with 0)."""
    xs = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got, want = _both(lambda p: p.input_stream("x").window(w, lambda v: v),
                      x=xs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n = shape[0]
    ext = np.concatenate([xs, np.zeros((w - 1,) + shape[1:], np.float32)])
    ref = np.stack([ext[i:i + n] for i in range(w)], axis=-1)
    valid = np.arange(n) <= n - w
    np.testing.assert_array_equal(got.numpy()[valid], ref[valid])
    assert (got.numpy()[~valid] == 0).all()


def test_every_reduction_and_tree_outputs():
    """sum / max / min / mean / count over a masked stream, a filter with
    a fill over 2-D elements (keep reduced by ``all``), outputs in a list
    and a dict."""
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((64, 3)).astype(np.float32)
    ys = rng.standard_normal(64).astype(np.float32)

    def build(p):
        x, y = p.input_stream("x"), p.input_stream("y")
        kept = x.filter(lambda v: v > -1.0, fill=-7.0)
        yv = y.window(5, lambda w: (w[..., 0] - w[..., 4]) * 0.5).filter(
            lambda v: v < 1.0)
        return [kept, {k: yv.reduce(k) for k in
                       ("sum", "max", "min", "mean", "count")},
                kept.reduce("sum")]
    got, want = _both(build, x=xs, y=ys)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    scale = float(np.abs(ys).sum())
    for k in ("sum", "mean"):
        _reduction_close(got[1][k], want[1][k], scale, 64)
    for k in ("max", "min", "count"):
        assert float(got[1][k]) == float(want[1][k]), k
    _reduction_close(got[2], want[2], float(np.abs(xs).sum()), xs.size)
    assert dappa.map_(dappa.input_stream("a"), abs).kind == "map"
    assert dappa.zip_(dappa.input_stream("a"),
                      dappa.input_stream("b")).kind == "zip"
    with pytest.raises(KeyError, match="missing inputs"):
        dappa.compile_pipeline(dappa.input_stream("z").reduce())(
            x=torch.ones(2))


def test_distributed_pipelines_gloo(tmp_path):
    """``dappa_distributed`` on 8 gloo ranks: the dot product, the moving
    max (the window's halo crosses every shard boundary by a ring of
    batch_isend_irecv) and the filtered mean, reductions replicated on
    every rank, the stream sharded; equal to the port's local run and to
    the reference's local run within 1e-5."""
    outs = worker.run_ranks("dappa", 8, tmp_path)
    x = jdappa.input_stream("x")
    y = jdappa.input_stream("y")
    ref = jdappa.compile_pipeline({
        "d": x.zip(y).map(lambda t: t[..., 0] * t[..., 1]).reduce("sum"),
        "m": x.window(4, lambda w: w.max(-1)),
        "f": x.filter(lambda v: v > 0).reduce("mean")})(
            x=jnp.linspace(-3, 3, 64), y=jnp.linspace(1, 2, 64))
    mov = np.concatenate([o["mesh_m"] for o in outs])
    np.testing.assert_allclose(mov, outs[0]["local_m"], atol=DIST_TOL,
                               rtol=DIST_TOL)
    np.testing.assert_allclose(mov, np.asarray(ref["m"]), atol=DIST_TOL,
                               rtol=DIST_TOL)
    for o in outs:
        # damov's step counter over the mesh run: three fp32 all-reduces
        # (the dot, the mean's sum and count: 4 bytes each, a ring's wire
        # 2 x 7/8 of that) and the halo, 3 rows sent to the previous rank
        np.testing.assert_array_equal(o["coll"], [4, 24, 33])
        assert list(o["kind_names"]) == ["all-reduce", "collective-permute"]
        np.testing.assert_array_equal(o["kind_bytes"], [12, 12])
        for k in ("d", "f"):
            for got in (o[f"mesh_{k}"], o[f"local_{k}"]):
                np.testing.assert_allclose(got, np.asarray(ref[k]),
                                           atol=DIST_TOL, rtol=DIST_TOL)
