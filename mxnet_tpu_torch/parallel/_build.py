"""Build and load the port's CUDA kernels (``parallel/csrc/*.cu``).

Each source compiles on its own with ``nvcc`` into a shared library with
a plain C interface, loaded with :mod:`ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib> <source>

The libraries land in ``mxnet_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that carries the first 16 hex digits of the
SHA-256 of the source and the shared headers (:data:`HEADERS`), so an
edited source or header rebuilds and an unchanged one loads at once. ``ptxas`` register and shared-memory reports are kept
beside each library (``<lib>.log``). A build runs at the first launch of
a kernel (or in :func:`build_all`, which starts one ``nvcc`` per source
at once); a failed build raises :class:`~mxnet_tpu_torch.MXNetError`
with the compiler's output. Nothing here runs at import time.

``nvcc`` is looked up as ``$CUDA_HOME/bin/nvcc``, then on ``PATH``, then
as ``/usr/local/cuda/bin/nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from ..base import MXNetError

__all__ = ["SOURCES", "build_all", "library", "log_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_OUT = os.path.join(os.path.dirname(_HERE), "_build")

# kernel name -> source file under csrc/
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_decode": "flash_decode.cu",
           "flash_decode_q8": "flash_decode_q8.cu",
           "flash_bwd_dkdv": "flash_bwd_dkdv.cu",
           "flash_bwd_dq": "flash_bwd_dq.cu", "nms_sweep": "nms_sweep.cu"}
# headers under csrc/ that every source includes
HEADERS = ("flash_common.cuh",)

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise MXNetError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
        "/usr/local/cuda/bin) — the CUDA kernels of mxnet_tpu_torch are "
        "built from source at first use")


def _lib_path(name):
    src = os.path.join(_CSRC, SOURCES[name])
    digest = hashlib.sha256()
    for path in [src] + [os.path.join(_CSRC, h) for h in HEADERS]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, os.path.join(_OUT, "lib%s-%s.so" % (name,
                                                     digest.hexdigest()[:16]))


def log_path(name):
    """The ``ptxas -v`` report of kernel ``name``'s current build."""
    return _lib_path(name)[1] + ".log"


def _start(name):
    """Start nvcc for ``name`` unless its library is current; returns
    (process or None, tmp path, final path)."""
    src, out = _lib_path(name)
    if os.path.exists(out):
        return None, None, out
    os.makedirs(_OUT, exist_ok=True)
    tmp = "%s.tmp%d" % (out, os.getpid())
    log = open(out + ".log.tmp%d" % os.getpid(), "w")
    try:
        proc = subprocess.Popen([_nvcc()] + _FLAGS + ["-o", tmp, src],
                                stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    return proc, tmp, out


def _finish(name, proc, tmp, out):
    if proc is None:
        return
    rc = proc.wait()
    log_tmp = out + ".log.tmp%d" % os.getpid()
    with open(log_tmp) as f:
        text = f.read()
    if rc != 0:
        os.unlink(log_tmp)
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise MXNetError("nvcc failed for %s (exit %d):\n%s"
                         % (SOURCES[name], rc, text))
    os.replace(log_tmp, out + ".log")
    os.replace(tmp, out)


def build_all():
    """Build every kernel that is not current, one ``nvcc`` per source,
    all started together. Returns the library paths by kernel name."""
    with _lock:
        started = {n: _start(n) for n in SOURCES}
        errors = []
        for n, job in started.items():
            try:
                _finish(n, *job)
            except MXNetError as exc:
                errors.append(str(exc))
        if errors:
            raise MXNetError("\n".join(errors))
        return {n: job[2] for n, job in started.items()}


def _declare(lib, name):
    """The ctypes signature of kernel ``name``'s C entry point; a decode
    kernel's also carries, as ``.splits``, the host's choice of splits
    of the cache for its shapes ``(B, H, T, D)``, which the entry point
    takes when it is given 0 splits."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "flash_fwd":
        fn = lib.mxt_flash_fwd
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, i, p]
    elif name == "flash_decode":
        fn = lib.mxt_flash_decode
        fn.argtypes = [p] * 5 + [i, i, i, i, f, i, p]
        fn.splits = lib.mxt_flash_decode_splits
    elif name == "flash_decode_q8":
        fn = lib.mxt_flash_decode_q8
        fn.argtypes = [p] * 7 + [i, i, i, i, f, i, p]
        fn.splits = lib.mxt_flash_decode_q8_splits
    elif name == "flash_bwd_dkdv":
        fn = lib.mxt_flash_bwd_dkdv
        fn.argtypes = [p] * 9 + [i, i, i, i, i, f, i, p]
    elif name == "nms_sweep":
        fn = lib.mxt_nms_sweep
        fn.argtypes = [p] * 4 + [i, i, f, i, p]
    else:
        fn = lib.mxt_flash_bwd_dq
        fn.argtypes = [p] * 8 + [i, i, i, i, i, f, i, p]
    fn.restype = ctypes.c_int
    splits = getattr(fn, "splits", None)
    if splits is not None:       # the decode kernels: (B, H, T, D) -> S
        splits.argtypes = [i, i, i, i]
        splits.restype = ctypes.c_int
    return fn


def library(name):
    """The C entry point of kernel ``name`` (a key of :data:`SOURCES`),
    building its library first if needed."""
    fn = _libs.get(name)
    if fn is not None:
        return fn
    with _lock:
        fn = _libs.get(name)
        if fn is None:
            job = _start(name)
            _finish(name, *job)
            fn = _declare(ctypes.CDLL(job[2]), name)
            _libs[name] = fn
    return fn
