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

With the persistent compile cache on (``MXNET_COMPILE_CACHE_DIR``,
:mod:`~mxnet_tpu_torch.compile_cache`), the libraries live there
instead, keyed by the kernel's name, ``nvcc``'s flags, the SHA-256 of
the source and headers, and the toolchain and card (site
``nvcc:<name>``): a hit writes the library and its report into a
directory of this process (``ctypes`` loads from a path) and runs no
``nvcc``; a miss builds into that directory and queues the library and
its report for the cache.

``nvcc`` is looked up as ``$CUDA_HOME/bin/nvcc``, then on ``PATH``, then
as ``/usr/local/cuda/bin/nvcc``.
"""
from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

from .. import compile_cache
from ..base import MXNetError

__all__ = ["SOURCES", "build_all", "library", "log_path", "nvcc_version"]

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
_cached = {}       # kernel name -> library path from the compile cache
_proc_dir = []     # this process's directory of cached libraries
_version = []      # nvcc's release line, read once


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


def nvcc_version():
    """nvcc's ``--version`` release line (part of the compile cache's
    version tag), read once per process."""
    if not _version:
        text = subprocess.run([_nvcc(), "--version"], capture_output=True,
                              text=True, timeout=60).stdout
        lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
        _version.append(next((ln for ln in lines if "release" in ln),
                             lines[-1] if lines else ""))
    return _version[0]


def _digest(name):
    """The SHA-256 of kernel ``name``'s source and the shared headers."""
    src = os.path.join(_CSRC, SOURCES[name])
    digest = hashlib.sha256()
    for path in [src] + [os.path.join(_CSRC, h) for h in HEADERS]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return src, digest.hexdigest()


def _lib_path(name):
    src, digest = _digest(name)
    base = "lib%s-%s.so" % (name, digest[:16])
    if name in _cached or compile_cache.maybe_enable():
        return src, os.path.join(_cache_out(), base)
    return src, os.path.join(_OUT, base)


def _cache_out():
    """This process's directory for libraries of the compile cache,
    removed at exit."""
    if not _proc_dir:
        _proc_dir.append(tempfile.mkdtemp(prefix="mxnet-nvcc-"))
        atexit.register(shutil.rmtree, _proc_dir[0], True)
    return _proc_dir[0]


def log_path(name):
    """The ``ptxas -v`` report of kernel ``name``'s current build."""
    return _lib_path(name)[1] + ".log"


def _from_cache(name, out):
    """Write kernel ``name``'s library and report from the compile cache
    to ``out``; returns its cache key, and whether it was there."""
    key = compile_cache.entry_key("nvcc:" + name, tuple(_FLAGS),
                                  _digest(name)[1])
    payload = compile_cache.lookup(key)
    if payload is None:
        return key, False
    log, lib = compile_cache.unpack_parts(payload)
    for path, data in ((out + ".log", log), (out, lib)):
        tmp = "%s.tmp%d" % (path, os.getpid())
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    _cached[name] = out
    return key, True


def _start(name):
    """Start nvcc for ``name`` unless its library is current; returns
    (process or None, tmp path, final path, cache key or None)."""
    src, out = _lib_path(name)
    key = None
    if compile_cache.enabled():
        if name in _cached:
            return None, None, out, None
        key, hit = _from_cache(name, out)
        if hit:
            return None, None, out, None
    elif os.path.exists(out):
        return None, None, out, None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = "%s.tmp%d" % (out, os.getpid())
    log = open(out + ".log.tmp%d" % os.getpid(), "w")
    try:
        proc = subprocess.Popen([_nvcc()] + _FLAGS + ["-o", tmp, src],
                                stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    return proc, tmp, out, key


def _finish(name, proc, tmp, out, key):
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
    if key is not None:
        with open(out, "rb") as f:
            compile_cache.store(key, compile_cache.pack_parts(
                text.encode(), f.read()))
        _cached[name] = out


def build_all(names=None):
    """Build every kernel (or those of ``names``) that is not current,
    one ``nvcc`` per source, all started together. Returns the library
    paths by kernel name."""
    with _lock:
        started = {n: _start(n) for n in (names or SOURCES)}
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
    takes when it is given 0 splits; ``nms_sweep``'s, as ``.workspace``,
    the bytes of device memory it takes at ``(B, n)``."""
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
        fn.argtypes = [p] * 5 + [i, i, f, i, i, p]
        fn.workspace = lib.mxt_nms_workspace
        fn.workspace.argtypes = [i, i]
        fn.workspace.restype = ctypes.c_longlong
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
