"""The port's distribution layer against the reference's on the CPU: the
Proteus quantized collectives and train step (``repro_torch.core.proteus``,
``repro_torch.launch.steps.make_train_step_proteus``), the GPipe pipeline
(``repro_torch.distributed.pipeline``); the production mesh is held to the
reference's in ``test_torch_dryrun.py``.

The reference runs on 8 placeholder host devices in a subprocess of its
own (``torch_dist_reference.py``), which saves its inputs and results as
numpy arrays; the port runs the same inputs on 8 gloo ranks
(``torch_dist_worker.py``, one process a rank). Tolerances:

* ``proteus_psum`` at 8 and 4 bits, and the exact sum (added in rank order,
  as the reference's ``psum`` adds): bitwise, on a length that is a multiple
  of the block and on one that is not;
* the Proteus train step on (2, 2, 2) (fp32 smoke pimref, one SGD step of
  learning rate 1, no warmup, no clipping, block 128): the loss within
  1e-5 relative; the update (new parameters less the initial ones) and
  SGD's momentum (the reduced gradient) held leaf by leaf to the
  reference's, relative to the leaf's largest |update|: within 1e-4 (ten
  times the fp32 noise measured between the two frameworks, 9e-6) at all
  but 1% of the elements, and within two int8 code steps (2 / 127) at
  those, where the two frameworks' fp32 gradients straddle a rounding edge
  and a pod's code flips by one (measured: at most 18 of 8192 elements of
  a leaf, 7e-3); every rank ends with the same parameters, bitwise;
* on one rank the Proteus step equals the plain step whose gradients pass
  through ``quantize`` and ``dequantize``, bitwise, over three AdamW steps
  (losses, parameters, both moments, the step count);
* ``pipelined_forward`` over two stages: within 1e-6 of the reference's,
  and bitwise equal to the port's sequential stack microbatch by
  microbatch.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_reference as ref_worker  # noqa: E402
import torch_dist_worker as worker  # noqa: E402
from repro.distributed import pipeline as jpipe  # noqa: E402
from repro_torch.core import proteus  # noqa: E402
from repro_torch.core.mimdram import Plan  # noqa: E402
from repro_torch.distributed import pipeline  # noqa: E402

TRAIN_LOSS_RTOL = 1e-5
TRAIN_UPDATE_TOL = 1e-4
TRAIN_FLIP_TOL = 2 / 127
TRAIN_FLIP_SHARE = 0.01
PIPE_ATOL = 1e-6


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's three modes, run once for the module."""
    return ref_worker.run_references(
        ("proteus_psum", "proteus_train", "pipeline"),
        tmp_path_factory.mktemp("reference"))


def test_proteus_psum_matches_reference(reference, tmp_path):
    ref = dict(np.load(reference["proteus_psum"]))
    outs = worker.run_ranks("proteus", 8, tmp_path,
                            inputs=reference["proteus_psum"])
    for name in ("g", "odd"):
        gmax = np.abs(ref[f"{name}_in"]).max()
        for r, o in enumerate(outs):
            for tag in ("exact", "q8", "q4"):
                np.testing.assert_array_equal(o[f"{name}_{tag}"],
                                              ref[f"{name}_{tag}"][r],
                                              err_msg=f"{name} {tag} {r}")
            # the reference's error bound: n scale / 2 an element
            for bits, qmax in ((8, 127), (4, 7)):
                err = np.abs(o[f"{name}_q{bits}"] - o[f"{name}_exact"])
                assert err.max() <= 8 * (gmax / qmax) / 2 * 1.01 + 1e-6
            # the mesh from the active plan; the tree wrapper's mean
            np.testing.assert_array_equal(o[f"{name}_q8_plan"],
                                          o[f"{name}_q8"])
            np.testing.assert_array_equal(o[f"{name}_tree"],
                                          o[f"{name}_q8"] / 8)


def test_div_by_is_the_true_quotient():
    """``div_by`` rounds the quotient once, as numpy's fp32 division (and
    the reference's) does; multiplying by the rounded reciprocal, what
    CUDA's division by a Python number does, differs for some values."""
    from repro_torch.kernels.common import div_by
    x = np.random.default_rng(0).random(1 << 16).astype(np.float32) * 8
    for q in (127.0, 7.0):
        got = div_by(torch.from_numpy(x), q).numpy()
        np.testing.assert_array_equal(got, x / np.float32(q))
        assert (x * (np.float32(1) / np.float32(q)) != got).any()


def test_maybe_compress_grads_disabled_returns_the_tree():
    grads = {"a": torch.ones(3), "b": [torch.zeros(2)]}
    assert proteus.maybe_compress_grads(grads, False, "pod") is grads
    assert proteus.maybe_compress_grads(grads, True, None) is grads


def test_collectives_need_a_mesh():
    with pytest.raises(ValueError, match="needs a mesh"):
        proteus.proteus_psum(torch.ones(4), "pod")
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.launch.steps import make_train_step_proteus
    from repro_torch.models.model import training_model
    from repro_torch.optim import make_optimizer
    cfg = get_config("pimref-100m", smoke=True)
    with pytest.raises(ValueError, match="pod"):
        make_train_step_proteus(training_model(cfg),
                                make_optimizer("sgd", RunConfig()),
                                Plan(rules={}), RunConfig())


def test_proteus_train_step_matches_reference(reference, tmp_path):
    ref = dict(np.load(reference["proteus_train"]))
    outs = worker.run_ranks("proteus_train", 8, tmp_path, timeout=240.0,
                            inputs=reference["proteus_train"])
    got = outs[0]
    assert list(got["rules_batch"]) == ["pod", "data"]
    for o in outs[1:]:
        for k in got:
            np.testing.assert_array_equal(o[k], got[k], err_msg=k)
    loss, want = float(got["loss"]), float(ref["loss"])
    assert abs(loss - want) <= TRAIN_LOSS_RTOL * abs(want), (loss, want)
    keys = sorted(k[4:] for k in ref if k.startswith("new/"))
    assert keys == sorted(k[4:] for k in got if k.startswith("new/"))
    for k in keys:
        init = ref[f"param/{k}"]
        want = ref[f"new/{k}"] - init
        limit = np.abs(want).max()
        assert limit > 1e-3 * np.abs(init).max(), (k, limit)
        for name, a, b in (("update", got[f"new/{k}"] - init, want),
                           ("momentum", got[f"mu/{k}"], ref[f"mu/{k}"])):
            err = np.abs(a - b) / limit
            flipped = int((err > TRAIN_UPDATE_TOL).sum())
            assert flipped <= TRAIN_FLIP_SHARE * err.size, (name, k, flipped)
            assert err.max() <= TRAIN_FLIP_TOL, (name, k, err.max())


def test_proteus_step_on_one_rank_is_the_hooked_plain_step(tmp_path):
    (o,) = worker.run_ranks("proteus_one", 1, tmp_path, timeout=240.0)
    pairs = [(k, "hooked" + k[len("proteus"):]) for k in o
             if k.startswith("proteus")]
    assert len(pairs) > 30
    for a, b in pairs:
        np.testing.assert_array_equal(o[a], o[b], err_msg=a)
    assert int(o["proteus_step"]) == 3


def test_pipeline_matches_reference(reference, tmp_path):
    ref = dict(np.load(reference["pipeline"]))
    outs = worker.run_ranks("pipeline", 8, tmp_path,
                            inputs=reference["pipeline"])
    for o in outs:
        np.testing.assert_array_equal(o["out"], o["seq"])
        np.testing.assert_allclose(o["out"], ref["out"], rtol=0,
                                   atol=PIPE_ATOL)
        assert "do not split" in str(o["refused"])


@pytest.mark.parametrize("stages,micro", [(1, 1), (2, 4), (4, 8), (2, 1),
                                          (8, 3)])
def test_bubble_fraction(stages, micro):
    assert pipeline.bubble_fraction(stages, micro) == \
        jpipe.bubble_fraction(stages, micro)


def test_stage_slice():
    w = {"a": torch.arange(12.0).reshape(6, 2), "b": [torch.arange(6)]}
    s = pipeline._stage_slice(w, 1, 3)
    assert torch.equal(s["a"], w["a"][3:6])
    assert torch.equal(s["b"][0], torch.arange(3, 6))


def test_mesh_module_touches_no_process_group():
    import subprocess
    import sys
    code = ("import torch.distributed as dist\n"
            "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
            "import repro_torch.distributed.pipeline\n"
            "assert not dist.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
