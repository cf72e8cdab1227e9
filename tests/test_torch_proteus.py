"""The port's Proteus host layer (repro_torch.core.proteus) against the
reference's repro.core.proteus on the CPU: block statistics, the integer
width under jax's default 32-bit types, block-scaled quantization, the
payload size, collective buckets and the cost model's choices. Inputs are
seeded numpy."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.core import proteus as jp  # noqa: E402
from repro_torch.core import proteus as tp  # noqa: E402
from repro_torch.kernels import common  # noqa: E402

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def _normal(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape,block", [((1024,), 256), ((37, 19), 128),
                                         ((5, 7, 11), 64), ((3,), 256)])
def test_block_statistics_match_reference(shape, block):
    x = _normal(sum(shape), shape, 10.0)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(tp.block_maxabs(xt, block).numpy(),
                                  np.asarray(jp.block_maxabs(xj, block)))
    for got, want in zip(tp.block_stats(xt, block), jp.block_stats(xj, block)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("vals", [
    [0, 0], [3], [-129], [1], [-1], [2 ** 21], [2 ** 21 + 1], [2 ** 23],
    [2 ** 23 + 7], [2 ** 23 + 8], [2 ** 24 + 1], [2 ** 30], [INT32_MAX],
    [INT32_MIN], [INT32_MIN, 5], [INT32_MIN, INT32_MIN], [-1000, 70000]])
def test_required_bits_int_matches_reference(vals):
    """The reference's own values, INT32_MIN's 1 and 2^23's 24 included."""
    x = np.asarray(vals, np.int64).astype(np.int32)
    got = tp.required_bits_int(torch.from_numpy(x))
    want = int(jp.required_bits_int(jnp.asarray(x)))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == want


def test_required_bits_int_edges_pinned():
    width = lambda v: int(tp.required_bits_int(torch.tensor([v],  # noqa: E731
                                                            dtype=torch.int32)))
    assert width(INT32_MIN) == 1 and width(2 ** 23) == 24
    assert width(0) == 1 and width(-129) == 9 and width(INT32_MAX) == 32


@pytest.mark.parametrize("shape,bits,block", [((1024,), 8, 256),
                                              ((37, 19), 8, 128),
                                              ((37, 19), 4, 128),
                                              ((4, 300), 4, 256)])
def test_quantize_dequantize_match_reference(shape, bits, block):
    x = _normal(bits * block, shape, 10.0)
    x.reshape(-1)[:block] = 0.0                # an all-zero block: scale 1
    qt = tp.quantize(torch.from_numpy(x), bits=bits, block=block)
    qj = jp.quantize(jnp.asarray(x), bits=bits, block=block)
    assert qt.values.dtype == torch.int8 and qt.scale.dtype == torch.float32
    np.testing.assert_array_equal(qt.values.numpy(), np.asarray(qj.values))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qj.scale))
    assert (qt.bits, qt.block, qt.shape) == (qj.bits, qj.block, qj.shape)
    assert qt.nbytes_payload == qj.nbytes_payload
    y = tp.dequantize(qt)
    assert y.shape == shape and y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), np.asarray(jp.dequantize(qj)))


def test_quantize_refuses_other_widths():
    with pytest.raises(ValueError):
        tp.quantize(torch.zeros(8), bits=2)


def test_int4_pair_is_reexported():
    assert tp.pack_int4 is common.pack_int4
    assert tp.unpack_int4 is common.unpack_int4


def test_cost_model_latency_and_select_match_reference():
    for kw in ({}, {"link_bw": 12.5e9, "vpu_rate": 1e12}):
        ct, cj = tp.CostModel(**kw), jp.CostModel(**kw)
        for n in (1, 1_000, 10 ** 5, 10 ** 6, 3 * 10 ** 7, 10 ** 9):
            for rt, rj in zip(tp.REPRESENTATIONS, jp.REPRESENTATIONS):
                assert (rt.name, rt.bits, rt.rel_err) == (rj.name, rj.bits,
                                                          rj.rel_err)
                assert ct.latency(n, rt) == pytest.approx(
                    cj.latency(n, rj), rel=1e-12)
            for budget in (1e-6, 1e-3, 4e-3, 1e-2, 0.05, 0.1):
                assert ct.select(n, budget).name == cj.select(n, budget).name


@pytest.mark.parametrize("kind", ["uniform", "spiky", "normal", "zeros"])
@pytest.mark.parametrize("budget", [5e-3, 5e-2, 1.0])
def test_select_for_tensor_matches_reference(kind, budget):
    n = 1 << 16
    x = {"uniform": np.full(n, 3.0, np.float32),
         "spiky": _normal(1, (n,)) ** 5,
         "normal": _normal(2, (n,)),
         "zeros": np.zeros(n, np.float32)}[kind]
    got = tp.CostModel().select_for_tensor(torch.from_numpy(x),
                                           err_budget=budget)
    want = jp.CostModel().select_for_tensor(jnp.asarray(x), err_budget=budget)
    assert got.name == want.name


def _names(path):
    """A reference pytree path as the port's tuple of keys and indices."""
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


@pytest.mark.parametrize("bucket_bytes", [1 << 20, 4 << 20, 1 << 30, 1])
def test_bucketize_matches_reference(bucket_bytes):
    shapes = {"a": (1024, 256), "b": (8,), "c": (2048, 512)}    # test_core's
    nested = {"z": [(64, 64), (3,)], "m": {"w": (300, 300), "b": (300,)},
              "e": (10, 10)}
    for tree in (shapes, nested):
        def build(t, f):
            if isinstance(t, dict):
                return {k: build(v, f) for k, v in t.items()}
            if isinstance(t, list):
                return [build(v, f) for v in t]
            return f(t)
        bt = tp.bucketize(build(tree, torch.zeros), bucket_bytes)
        bj = jp.bucketize(build(tree, jnp.zeros), bucket_bytes)
        assert [len(b) for b in bt] == [len(b) for b in bj]
        assert [[p for p, _ in b] for b in bt] == \
            [[_names(p) for p, _ in b] for b in bj]
        assert [[tuple(x.shape) for _, x in b] for b in bt] == \
            [[x.shape for _, x in b] for b in bj]
