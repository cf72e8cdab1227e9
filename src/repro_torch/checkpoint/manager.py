"""Checkpointing: atomic, verified step snapshots, async save (counterpart:
``repro/checkpoint/manager.py``, with its on-disk layout).

Layout:  <dir>/step_00000100/  leaf files `<flat-key>.npy` + manifest.json,
the flat key being jax's ``keystr`` of the leaf's path in the saved tree
(``['params']['blocks']['attn']['w_q']``), so a checkpoint written by the
reference restores here and the reverse. Writes go to a tmp dir renamed
into place (atomic on POSIX) with every leaf file, the manifest, and the
directory fsync'd first, so a crash mid-save never corrupts the latest
checkpoint. The manifest records a per-leaf CRC32; ``restore`` verifies
shape, dtype, and checksum and *falls back to the previous checkpoint* (with
a warning) when the latest is torn or corrupt. Async-writer exceptions are
captured and re-raised at the next ``save()``/``wait()``.

Leaves may be tensors (on any device) or numpy arrays; they are copied to
the host before the writer starts, and ``restore`` returns numpy arrays.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import warnings
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, tree_map, unflatten


class CheckpointError(RuntimeError):
    """Base class for typed checkpoint failures."""


class CheckpointWriteError(CheckpointError):
    """A checkpoint write failed (sync, or captured from the async writer
    and re-raised at the next ``save()``/``wait()``)."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint on disk is torn or corrupt: unreadable manifest/leaf,
    or a leaf whose CRC32/shape/dtype disagrees with its manifest entry."""


class CheckpointMismatchError(CheckpointError, ValueError):
    """The checkpoint is intact but does not match the restore *template*
    (missing leaf, or shape/dtype mismatch). Subclasses ``ValueError`` so
    pre-existing shape-mismatch handling keeps working."""


def _flatten(tree: Any) -> Dict[str, Any]:
    return dict(leaves_with_path(tree))


def _host(x: Any) -> np.ndarray:
    """A leaf as a numpy array on the host, a copy of a tensor (a CPU
    tensor's ``numpy()`` is a view of its storage, which a donated train
    step overwrites while the writer thread reads it)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.numpy().copy() if x.device.type == "cpu" else \
            x.cpu().numpy()
    return np.asarray(x)


def _key_sanitize(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.\-]", "_", key)


def _crc(arr: np.ndarray) -> int:
    # tobytes() copies to C order itself; ascontiguousarray would promote
    # 0-d leaves (optimizer step counters) to shape (1,) on some numpys.
    return zlib.crc32(arr.tobytes())


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # platform without directory fds — rename is still atomic
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _rmtree_atomic(path: str, suffix: str) -> None:
    """Delete a checkpoint dir without ever exposing a half-deleted step:
    rename out of the ``step_NNN`` namespace first, then rmtree. A crash
    between the two leaves only a ``.trash``/``.old`` dir that ``all_steps``
    ignores and the next write sweeps."""
    side = path + suffix
    shutil.rmtree(side, ignore_errors=True)
    try:
        os.rename(path, side)
    except OSError:
        return
    shutil.rmtree(side, ignore_errors=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True,
                 fault_hook: Optional[Callable[[int, str], None]] = None):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        # chaos injection point: called as fault_hook(step, leaf_key) before
        # each leaf write; raising simulates a mid-save I/O failure.
        self.fault_hook = fault_hook
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             block: bool = False) -> None:
        # materialize on host before handing to the writer thread
        host_tree = tree_map(_host, tree)
        self.wait()  # re-raises a captured async-write failure
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host_tree, extra or {}))
            self._thread.start()
        else:
            try:
                self._write(step, host_tree, extra or {})
            except Exception as e:
                raise CheckpointWriteError(
                    f"checkpoint write for step {step} failed: {e}") from e

    def _write_guarded(self, step: int, host_tree: Any, extra: Dict) -> None:
        try:
            self._write(step, host_tree, extra)
        except BaseException as e:  # noqa: BLE001 — surfaced at next wait()
            self._error = e

    def _write(self, step: int, host_tree: Any, extra: Dict) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = _flatten(host_tree)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        for key, arr in flat.items():
            if self.fault_hook is not None:
                self.fault_hook(step, key)
            arr = np.asarray(arr)
            fname = _key_sanitize(key) + ".npy"
            with open(os.path.join(tmp, fname), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape),
                "dtype": str(arr.dtype), "crc32": _crc(arr)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(final):
            # swap, never delete-then-rename: a crash in between must leave
            # either the old step (as .old, swept below) or the new one.
            old = final + ".old"
            shutil.rmtree(old, ignore_errors=True)
            os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.rename(tmp, final)
        _fsync_dir(self.dir)
        self._gc()

    def wait(self) -> None:
        """Join the async writer; re-raise any failure it captured."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointWriteError(
                f"async checkpoint write failed: {err}") from err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            _rmtree_atomic(os.path.join(self.dir, f"step_{s:08d}"), ".trash")

    # -- load -----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load_extra(self, step: int) -> Dict[str, Any]:
        """The ``extra`` payload saved with ``step`` (loop state, loss, ...)."""
        path = os.path.join(self.dir, f"step_{step:08d}", "manifest.json")
        try:
            with open(path) as f:
                return json.load(f).get("extra", {})
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(
                f"unreadable manifest for step {step}: {e}") from e

    def restore(self, template: Any,
                step: Optional[int] = None) -> Tuple[int, Any]:
        """Restore into the structure of ``template`` (a tree whose leaves
        have ``shape`` and ``dtype``), verifying checksums; returns (step,
        a tree of numpy arrays).

        Without an explicit ``step``, candidates are tried newest -> oldest:
        a torn or corrupt checkpoint is skipped with a warning and the
        previous one restores instead (``CheckpointCorruptError`` only when
        *no* intact checkpoint remains). An explicit ``step`` never falls
        back. Template mismatches (``CheckpointMismatchError``) always raise
        — a wrong template is a caller bug, not disk corruption.
        """
        candidates = [step] if step is not None else \
            list(reversed(self.all_steps()))
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        last_err: Optional[Exception] = None
        for s in candidates:
            path = os.path.join(self.dir, f"step_{s:08d}")
            try:
                tree = load_checkpoint(path, template)
            except (CheckpointCorruptError, OSError) as e:
                if step is not None:
                    raise
                last_err = e
                warnings.warn(f"checkpoint step {s} is torn/corrupt ({e}); "
                              "falling back to the previous checkpoint")
                continue
            return s, tree
        raise CheckpointCorruptError(
            f"no intact checkpoint under {self.dir}") from last_err


def load_checkpoint(path: str, template: Any) -> Any:
    """Load one checkpoint dir into ``template``'s structure, verifying each
    leaf's CRC32/shape against the manifest and shape+dtype against the
    template (typed ``CheckpointCorruptError`` / ``CheckpointMismatchError``
    naming the offending leaf)."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(
            f"{path}: unreadable manifest ({e})") from e
    leaves_meta = manifest["leaves"]
    vals = []
    for key, leaf in leaves_with_path(template):
        if key not in leaves_meta:
            raise CheckpointMismatchError(f"checkpoint missing leaf {key}")
        meta = leaves_meta[key]
        try:
            arr = np.load(os.path.join(path, meta["file"]))
        except Exception as e:  # torn file, truncated header, bad magic, ...
            raise CheckpointCorruptError(
                f"{path}: leaf {key} unreadable ({e})") from e
        if tuple(arr.shape) != tuple(meta["shape"]) or \
                str(arr.dtype) != meta["dtype"]:
            raise CheckpointCorruptError(
                f"{path}: leaf {key} disagrees with its manifest entry "
                f"({arr.shape}/{arr.dtype} vs "
                f"{tuple(meta['shape'])}/{meta['dtype']})")
        crc = meta.get("crc32")  # absent in pre-CRC checkpoints
        if crc is not None and _crc(arr) != crc:
            raise CheckpointCorruptError(
                f"{path}: leaf {key} checksum mismatch")
        expect = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise CheckpointMismatchError(
                f"shape mismatch for {key}: {arr.shape} vs {expect}")
        want_dtype = _dtype_name(getattr(leaf, "dtype", None))
        if want_dtype is not None and str(arr.dtype) != want_dtype:
            raise CheckpointMismatchError(
                f"dtype mismatch for {key}: {arr.dtype} vs {want_dtype}")
        vals.append(arr)
    return unflatten(template, vals)


def _dtype_name(dtype: Any) -> Optional[str]:
    """numpy's name of a leaf's dtype (``torch.float32`` -> ``float32``)."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(dtype)
