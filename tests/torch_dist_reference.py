"""The reference's multi-device results that the port's distribution tests
hold the port to, computed on 8 placeholder host devices in a process of
their own (``XLA_FLAGS`` must be set before jax is imported):

    python torch_dist_reference.py <mode> OUT.npz

with ``mode`` one of ``proteus_psum`` (``tests/distributed_worker.py``'s
inputs, plus a length that is not a multiple of the block), ``proteus_train``
(one Proteus step of the fp32 smoke pimref on a (2, 2, 2) pod x data x
model mesh: the new parameters and SGD's momentum, the reduced gradient) and ``pipeline`` (the two-stage GPipe forward of
``distributed_worker.py``'s pipeline mode). Inputs and outputs go to
``OUT.npz`` as numpy arrays; a parameter tree's leaves under
``param/<key>/<key>...``.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the proteus_train cell: pimref smoke at fp32 compute, batch 8 x 32, one
# SGD step with no warmup, a learning rate of 1 and no clipping (the limit
# is never reached), so that the update is the reduced gradient itself, at
# its own scale: a step that applied no update, summed where it should
# average, or took the wrong rows, changes it by a whole gradient
TRAIN_SHAPE = (8, 32)
TRAIN_BLOCK = 128
TRAIN_RUN = dict(total_steps=10, warmup_steps=0, learning_rate=1.0,
                 grad_clip=1e9, microbatches=1, proteus_enabled=True,
                 proteus_grad_bits=8, proteus_block=TRAIN_BLOCK)
# the pipeline mode's sizes: layers, width, microbatches, rows a microbatch
PIPE = (4, 16, 4, 8)
PSUM_BLOCK = 128


def run_references(modes, out_dir: str, timeout: float = 600.0) -> dict:
    """``modes`` each in a subprocess of its own, all at once; returns the
    path of each one's npz. A mode that fails or outlives ``timeout`` fails
    the call (every process is killed)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    paths = {m: os.path.join(str(out_dir), f"{m}.npz") for m in modes}
    procs = {m: subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                  m, paths[m]], env=env, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT) for m in modes}
    try:
        for m, p in procs.items():
            log = p.communicate(timeout=timeout)[0]
            assert p.returncode == 0, f"{m}:\n{log[-3000:]}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return paths


def flat_tree(tree, prefix: str = "param") -> dict:
    """A nested dict / list tree's leaves as ``prefix/key/...`` arrays."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat_tree(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat_tree(v, f"{prefix}/{i}"))
    else:
        out[prefix] = np.asarray(tree)
    return out


def nested(flat: dict, prefix: str = "param") -> dict:
    """``flat_tree``'s inverse for dict trees."""
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        if parts[0] != prefix:
            continue
        node = tree
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _main(mode: str, out: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import make_mesh, shard_map
    assert len(jax.devices()) == 8, jax.devices()
    res = {}
    if mode == "proteus_psum":
        from repro.core import proteus
        mesh = make_mesh((8,), ("pod",))

        def worker(g):
            return (jax.lax.psum(g, "pod"),
                    proteus.proteus_psum(g, "pod", bits=8, block=PSUM_BLOCK),
                    proteus.proteus_psum(g, "pod", bits=4, block=PSUM_BLOCK))

        f = shard_map(worker, mesh=mesh, in_specs=P("pod"),
                      out_specs=(P("pod"),) * 3, check_vma=False)
        g = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 1024),
                                         jnp.float32))
        odd = np.random.default_rng(1).standard_normal(
            (8, 1000)).astype(np.float32)
        for name, x in (("g", g), ("odd", odd)):
            res[f"{name}_in"] = x
            for tag, y in zip(("exact", "q8", "q4"), f(jnp.asarray(x))):
                res[f"{name}_{tag}"] = np.asarray(y)
    elif mode == "proteus_train":
        from repro.configs import RunConfig, ShapeConfig, get_config
        from repro.core.mimdram import plan_sharding
        from repro.data import make_batch_fn
        from repro.launch.steps import make_train_step_proteus
        from repro.models import build_model, init_params
        from repro.optim import make_optimizer
        cfg = get_config("pimref-100m", smoke=True).replace(
            compute_dtype="float32")
        model = build_model(cfg)
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
        shape = ShapeConfig("t", seq_len=TRAIN_SHAPE[1],
                            global_batch=TRAIN_SHAPE[0], mode="train")
        plan = plan_sharding(cfg, shape, mesh)
        run = RunConfig(**TRAIN_RUN)
        params = init_params(model.param_specs(), jax.random.PRNGKey(0))
        opt = make_optimizer("sgd", run)
        batch = make_batch_fn(cfg, shape)(0)
        res.update(flat_tree(jax.tree_util.tree_map(np.asarray, params)))
        res.update({f"batch/{k}": np.asarray(v) for k, v in batch.items()})
        step = jax.jit(make_train_step_proteus(model, opt, plan, run))
        p1, s1, m1 = step(params, opt.init(params),
                          {k: jnp.asarray(v) for k, v in batch.items()})
        res.update(flat_tree(jax.tree_util.tree_map(np.asarray, p1), "new"))
        # SGD's momentum after one step: the reduced gradient
        res.update(flat_tree(jax.tree_util.tree_map(np.asarray, s1["mu"]),
                             "mu"))
        res["loss"] = np.asarray(m1["loss"])
    elif mode == "pipeline":
        from repro.distributed.pipeline import pipelined_forward
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
        L, D, M, mb = PIPE
        w = jax.random.normal(jax.random.PRNGKey(0), (L, D, D)) * 0.3
        x = jax.random.normal(jax.random.PRNGKey(1), (M, mb, D))
        y = jax.jit(lambda w, x: pipelined_forward(
            lambda wl, h: jnp.tanh(h @ wl), w, x, mesh=mesh, n_stages=2,
            n_layers=L))(w, x)
        res.update(w=np.asarray(w), x=np.asarray(x), out=np.asarray(y))
    else:
        raise SystemExit(f"unknown mode {mode}")
    np.savez(out, **res)


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2])
