"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``<stem>.cu`` source under ``repro_torch/kernels/**/csrc/`` is
compiled by ``nvcc`` for ``sm_90a`` into a shared library of its own with a
plain C interface, ``build/kernels/lib<stem>-<hash>.so`` at the repository
root, where ``<hash>`` covers the source, its parts, the headers beside it
and the flags: a changed source builds a new library, an unchanged one is
loaded as it is. A source may have parts, ``<stem>.<part>.cu`` beside it
(translation units that share a ``.cuh`` header, so that one library's
template instantiations compile in parallel). Every translation unit, the
source and each of its parts, compiles to an object, and a library's
objects link into it. A plain C interface builds in seconds, where a
source that includes PyTorch's headers takes minutes. :func:`build_all`
starts one ``nvcc -c`` per translation unit, all at once, waits for every
one of them, then links each library.

Callers set ``argtypes`` on the functions they use (``c_void_p`` for every
pointer and for the stream) and raise when a function returns a CUDA error
code other than 0; :func:`check` does the raising.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# where nvcc is looked for after PATH
CUDA_ROOTS = ("CUDA_HOME", "CUDA_PATH")
DEFAULT_CUDA_ROOT = "/usr/local/cuda"

# per library: seconds of its nvcc run, its path, nvcc's register report
BUILD_INFO: Dict[str, Dict[str, Any]] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """``stem -> path`` of the CUDA source of every kernel module (its
    parts, ``<stem>.<part>.cu``, are :func:`parts`')."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("**/csrc/*.cu"))
            if "." not in p.stem}


def parts(src: Path) -> List[Path]:
    """The translation units of ``src``'s library: the source, then its
    parts in name order."""
    return [src, *sorted(src.parent.glob(f"{src.stem}.*.cu"))]


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [*parts(src), *sorted(src.parent.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    """``nvcc`` from ``PATH``, ``$CUDA_HOME/bin``, ``$CUDA_PATH/bin`` or
    ``/usr/local/cuda/bin``."""
    roots = [os.environ.get(v) for v in CUDA_ROOTS] + [DEFAULT_CUDA_ROOT]
    cands = [shutil.which("nvcc")] + [os.path.join(r, "bin", "nvcc")
                                      for r in roots if r]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "cannot build the repro_torch CUDA kernels: the CUDA compiler 'nvcc' "
        "was not found on PATH, in $CUDA_HOME/bin, $CUDA_PATH/bin or "
        f"{DEFAULT_CUDA_ROOT}/bin")


def _run_all(cmds: Dict[Any, List[str]]) -> Dict[Any, Tuple[int, str, float]]:
    """Run every command at once, each read by a thread of its own;
    ``key -> (return code, output, seconds until it ended)``."""
    t0 = time.perf_counter()

    def run(cmd):
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        return res.returncode, res.stdout, time.perf_counter() - t0

    if not cmds:
        return {}
    with ThreadPoolExecutor(max_workers=len(cmds)) as pool:
        futs = {k: pool.submit(run, c) for k, c in cmds.items()}
        return {k: f.result() for k, f in futs.items()}


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Dict[str, Any]]:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc -c`` per translation unit, all started together, then link each
    library from its objects; returns ``BUILD_INFO``."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    pending, cmds = {}, {}
    for name in names:
        out = library_path(srcs[name])
        if out.exists():
            continue
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        objs = []
        for i, u in enumerate(parts(srcs[name])):
            objs.append(tmp.with_name(f"{out.stem}.{os.getpid()}.{i}.o"))
            cmds[(name, i)] = [nvcc, *NVCC_FLAGS, "-c", "-o", str(objs[i]),
                               str(u)]
        pending[name] = (tmp, out, objs)
    ran = _run_all(cmds)
    failed = []
    for name, (tmp, out, objs) in pending.items():
        units = [(k, ran[k]) for k in sorted(ran) if k[0] == name]
        bad = [f"nvcc failed ({rc}):\n{' '.join(cmds[k])}\n{log}"
               for k, (rc, log, _) in units if rc != 0]
        log = "".join(log for _, (_, log, _) in units)
        seconds = max(sec for _, (_, _, sec) in units)
        if not bad:
            t0 = time.perf_counter()
            link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
            res = subprocess.run(link, capture_output=True, text=True)
            seconds += time.perf_counter() - t0
            if res.returncode != 0:
                bad.append(f"link failed ({res.returncode}):\n"
                           f"{' '.join(link)}\n{res.stdout}{res.stderr}")
        for o in objs:
            o.unlink(missing_ok=True)
        if bad:
            failed.extend(bad)
            continue
        os.replace(tmp, out)          # atomic: concurrent builders agree
        BUILD_INFO[name] = {"seconds": seconds, "path": str(out), "log": log,
                            "parts": {parts(srcs[name])[k[1]].name: sec
                                      for k, (_, _, sec) in units}}
    if failed:
        raise RuntimeError("\n".join(failed))
    return BUILD_INFO


def library(name: str) -> ctypes.CDLL:
    """The kernel library built from ``csrc/<name>.cu``: built at first use,
    loaded once per process."""
    if name in _LIBS:
        return _LIBS[name]
    srcs = sources()
    if name not in srcs:
        raise RuntimeError(f"no CUDA source {name}.cu under "
                           f"{KERNELS_DIR}/**/csrc")
    path = library_path(srcs[name])
    if not path.exists():
        build_all([name])
    lib = ctypes.CDLL(str(path))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
