"""ctypes bindings for the native RecordIO reader (counterpart of
``mxnet_tpu/io/native.py``): buffered frame reading and a
dmlc::ThreadedIter-style prefetch thread, the reference's src/io/ data
plane, from the port's own source ``io/csrc/recordio_io.cc``.

The library is built at first use with

    g++ -O3 -std=c++17 -fPIC -shared -pthread -o <lib> recordio_io.cc

into ``mxnet_tpu_torch/_build/`` (listed in ``.gitignore``) under a name
that carries the first 16 hex digits of the source's SHA-256, so an
edited source rebuilds and an unchanged one loads at once. The compiler
is ``$CXX``, else ``g++`` on ``PATH``. Where there is none,
:func:`available` is False and the record iterators read through the
pure-Python :mod:`~mxnet_tpu_torch.recordio`, as the JAX package does
where its library is not built; a source that does not compile raises
:class:`~mxnet_tpu_torch.MXNetError` with the compiler's output.
``MXNET_USE_NATIVE_IO=0`` keeps the pure-Python reader.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from .. import envs
from ..base import MXNetError

__all__ = ["available", "lib_path", "NativeRecordReader",
           "PrefetchingRecordReader"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "recordio_io.cc")
_OUT = os.path.join(os.path.dirname(_HERE), "_build")
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_LIB = None
_TRIED = False
_lock = threading.Lock()


def lib_path():
    """Where the library of the current source lives (built or not)."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_OUT, "libmxtpu_io-%s.so" % digest)


def _compiler():
    cxx = os.environ.get("CXX") or "g++"
    return shutil.which(cxx)


def _build(path):
    """Compile the source to ``path`` (a temporary file, then a rename,
    so a concurrent loader never sees half a library)."""
    cxx = _compiler()
    if cxx is None:
        return False
    os.makedirs(_OUT, exist_ok=True)
    tmp = "%s.tmp%d" % (path, os.getpid())
    out = subprocess.run([cxx] + _FLAGS + ["-o", tmp, _SRC],
                         capture_output=True, text=True)
    if out.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise MXNetError("g++ failed for %s (exit %d):\n%s"
                         % (_SRC, out.returncode, out.stdout + out.stderr))
    os.replace(tmp, path)
    return True


def _load():
    global _LIB, _TRIED
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        if not envs.get_bool("MXNET_USE_NATIVE_IO"):
            return None
        path = lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        lib = ctypes.CDLL(path)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        for prefix in ("mxtpu_rec", "mxtpu_prefetch"):
            getattr(lib, prefix + "_open").restype = ctypes.c_void_p
            nxt = getattr(lib, prefix + "_next")
            nxt.restype = ctypes.c_int
            nxt.argtypes = [ctypes.c_void_p, ctypes.POINTER(u8p),
                            ctypes.POINTER(ctypes.c_uint64)]
            getattr(lib, prefix + "_error").restype = ctypes.c_char_p
            getattr(lib, prefix + "_error").argtypes = [ctypes.c_void_p]
            getattr(lib, prefix + "_close").argtypes = [ctypes.c_void_p]
        lib.mxtpu_rec_open.argtypes = [ctypes.c_char_p]
        lib.mxtpu_rec_seek.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.mxtpu_prefetch_open.argtypes = [ctypes.c_char_p,
                                            ctypes.c_uint64]
        _LIB = lib
        return _LIB


def available():
    """Whether the native reader is on (``MXNET_USE_NATIVE_IO``) and its
    library built or buildable here."""
    return _load() is not None


class _ReaderBase:
    _prefix = None
    _h = None

    def __init__(self, handle):
        self._h = handle
        self._lib = _load()

    def _next(self):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        data = u8p()
        length = ctypes.c_uint64()
        rc = getattr(self._lib, self._prefix + "_next")(
            self._h, ctypes.byref(data), ctypes.byref(length))
        if rc == 0:
            return None
        if rc < 0:
            err = getattr(self._lib, self._prefix + "_error")(self._h)
            raise RuntimeError((err or b"native IO error").decode())
        return ctypes.string_at(data, length.value)

    def read(self):
        """One record's payload bytes, or None at the end of the stream
        (the ``MXRecordIO.read`` contract)."""
        return self._next()

    def __iter__(self):
        while True:
            rec = self._next()
            if rec is None:
                return
            yield rec

    def close(self):
        if self._h is not None:
            getattr(self._lib, self._prefix + "_close")(self._h)
            self._h = None

    __enter__ = lambda self: self
    __exit__ = lambda self, *exc: self.close()
    __del__ = lambda self: self.close()


def _need_lib():
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native IO reader unavailable (MXNET_USE_NATIVE_IO=0 or no "
            "C++ compiler); use mxnet_tpu_torch.recordio.MXRecordIO")
    return lib


class NativeRecordReader(_ReaderBase):
    """Sequential buffered .rec reader over the native library."""

    _prefix = "mxtpu_rec"

    def __init__(self, path):
        lib = _need_lib()
        h = lib.mxtpu_rec_open(os.fsencode(path))
        if not h:
            raise IOError("cannot open %s" % path)
        super().__init__(h)
        self._path = path

    def seek(self, offset):
        self._lib.mxtpu_rec_seek(self._h, int(offset))

    def reset(self):
        self.seek(0)


class PrefetchingRecordReader(_ReaderBase):
    """Background-thread prefetching reader (the PrefetcherIter /
    dmlc::ThreadedIter role, reference iter_prefetcher.h:47): a C++
    producer thread stays ahead of the consumer by up to
    ``capacity_bytes`` of payload."""

    _prefix = "mxtpu_prefetch"

    def __init__(self, path, capacity_bytes=64 << 20):
        lib = _need_lib()
        h = lib.mxtpu_prefetch_open(os.fsencode(path), int(capacity_bytes))
        if not h:
            raise IOError("cannot open %s" % path)
        super().__init__(h)
        self._path = path
        self._capacity = int(capacity_bytes)

    def reset(self):
        """Restart the stream: the producer thread cannot rewind, so
        close and reopen (the reference prefetcher's BeforeFirst)."""
        self.close()
        h = self._lib.mxtpu_prefetch_open(os.fsencode(self._path),
                                          self._capacity)
        if not h:
            raise IOError("cannot reopen %s" % self._path)
        self._h = h
