"""Persistent on-disk store of the port's compiled device code
(counterpart of ``mxnet_tpu/compile_cache.py``).

The JAX package keeps XLA executables here. The port's programs are CUDA
graphs, which cannot be written to disk: a restarted process captures
them again. What the port does compile is device code, and that is what
this module keeps across a restart:

- the ``nvcc`` libraries of ``parallel/csrc/*.cu``
  (:mod:`~mxnet_tpu_torch.parallel._build`, site ``nvcc:<kernel>``),
  each entry the library's bytes and its ``ptxas -v`` report;
- the cubins NVRTC compiles for ``mx.rtc`` modules
  (:mod:`~mxnet_tpu_torch.rtc`, site ``nvrtc``), each entry the cubin
  and its kernels' lowered names.

Before a build the cache is consulted, and a hit loads the binary
without running the compiler; after a fresh build the binary is queued
for the disk. A warm restart therefore builds nothing, while it still
captures its CUDA graphs.

Cache key anatomy: an entry is reused only when ALL of these match
(each is part of the sha256 file name, so any change is a natural
miss, never a wrong binary):

- the **site** and **statics** (which producer and which build: the
  kernel's name and nvcc's flags, NVRTC's options and exports);
- the **signature** (the SHA-256 of the source and its headers);
- the **options** (the target architecture of an NVRTC build);
- the **version tag**: the port's version, torch's and its CUDA's, the
  toolchain's own version (nvcc's ``--version`` release line for
  ``nvcc:`` sites, ``nvrtcVersion`` for ``nvrtc``), and the device's
  name, compute capability and count (``"cpu"`` and 0 without a card).
  Each is read once per process.

Durability contract, as the JAX package's:

- writes are **atomic** (tmp + ``fsync`` + ``os.replace``) and happen
  on a background writer thread behind a bounded queue
  (``MXNET_COMPILE_CACHE_QUEUE``; a full queue drops the store,
  counted);
- a corrupt, truncated or version-mismatched entry is a **miss**
  (counted as a miss and an error, the file removed): the cache never
  kills the job, and the caller builds as if the cache were empty;
- the directory is **LRU-bounded** by ``MXNET_COMPILE_CACHE_MB``
  (default 512): after each store the least recently used entries go
  until the total fits; a hit refreshes its entry's mtime. Temporary
  files a killed writer left behind are swept when older than an hour.

An entry file is ``MXC1``, a 4-byte header length, a JSON header
(format, version tag, payload size and SHA-256) and the payload bytes;
nothing on disk is unpickled.

Observability: hits, misses, errors, evictions, dropped stores and
bytes read and written flow into ``profiler.counters()`` as
``compile_cache_*``; each compile-watch ``compile`` record is tagged
``"cache": "hit"|"miss"|"none"`` by the lookups its capture made on the
capturing thread; :func:`stats` feeds the summary's ``compile.cache``
block and diagnose's Compile-cache row.

Off by default, and cheap when off (one module-global ``None`` check):
enable with ``MXNET_COMPILE_CACHE_DIR`` (read at the first build) or
:func:`enable`. With the cache off the producers keep their binaries
under ``mxnet_tpu_torch/_build/`` as before.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue as _queue_mod
import struct
import threading
import time
import warnings

from . import envs

__all__ = ["enabled", "enable", "disable", "maybe_enable", "stats",
           "entry_key", "lookup", "store", "flush", "cache_dir"]

_FORMAT = 1
_SUFFIX = ".mxc"
_MAGIC = b"MXC1"
_lock = threading.Lock()
_cache = None          # the active _Cache; module-global None check


def _count(name, delta=1):
    from . import profiler
    profiler.increment_counter("compile_cache_%s" % name, delta)


class _Cache:
    def __init__(self, path, max_mb=None):
        self.dir = os.path.abspath(path)
        os.makedirs(self.dir, exist_ok=True)
        # sweep tmp files a killed writer stranded: they are invisible
        # to the LRU accounting (only *.mxc counts) and would grow the
        # directory past its cap forever. Only STALE tmp files go — a
        # fleet cold-starting against one shared directory has live
        # writers mid-replace, and racing them would lose their stores.
        now = time.time()
        for name in os.listdir(self.dir):
            if ".tmp." in name:
                p = os.path.join(self.dir, name)
                try:
                    if now - os.stat(p).st_mtime > 3600:
                        os.unlink(p)
                except OSError:
                    pass
        if max_mb is None:
            max_mb = envs.get_float("MXNET_COMPILE_CACHE_MB")
        self.max_bytes = max(1, int(float(max_mb) * (1 << 20)))
        self.hits = 0
        self.misses = 0
        self.errors = 0
        self.evictions = 0
        self.stores = 0
        self.stores_dropped = 0
        self.bytes_read = 0
        self.bytes_written = 0
        self.hit_s = 0.0
        # bounded store queue: a burst of first builds must not grow
        # host memory holding binaries for a slow disk — drop (and
        # count) instead, the entry simply stays cold
        self.pending = _queue_mod.Queue(
            maxsize=max(1, envs.get_int("MXNET_COMPILE_CACHE_QUEUE")))
        self.writer = threading.Thread(
            target=self._writer_loop, name="mxnet-compile-cache-writer",
            daemon=True)
        self.writer.start()

    # -- background writer -------------------------------------------------
    def _writer_loop(self):
        while True:
            item = self.pending.get()
            try:
                if item is None:
                    return
                key, payload = item
                self._write_entry(key, payload)
            except Exception:
                with _lock:
                    self.errors += 1
                _count("errors")
            finally:
                self.pending.task_done()

    def _path(self, key):
        return os.path.join(self.dir, key + _SUFFIX)

    def _write_entry(self, key, payload):
        blob = _frame(_tag_of(key), payload)
        path = self._path(key)
        tmp = path + ".tmp.%d" % os.getpid()
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        with _lock:
            self.stores += 1
            self.bytes_written += len(blob)
        _count("bytes_written", len(blob))
        self._evict_lru()

    def _evict_lru(self):
        """Drop the least-recently-used entries until the directory
        fits the byte cap (hits refresh mtime, so age == last use)."""
        entries = []
        total = 0
        try:
            for name in os.listdir(self.dir):
                if not name.endswith(_SUFFIX):
                    continue
                p = os.path.join(self.dir, name)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                entries.append((st.st_mtime, st.st_size, p))
                total += st.st_size
        except OSError:
            return
        if total <= self.max_bytes:
            return
        n = 0
        for _, size, p in sorted(entries):
            if total <= self.max_bytes:
                break
            try:
                os.unlink(p)
            except OSError:
                continue
            total -= size
            n += 1
        if n:
            with _lock:
                self.evictions += n
            _count("evictions", n)


def enabled():
    """True while a cache directory is active."""
    return _cache is not None


_enable_lock = threading.Lock()


def enable(path=None, max_mb=None):
    """Activate the cache at ``path`` (default:
    ``MXNET_COMPILE_CACHE_DIR``). Idempotent for the same directory;
    re-pointing at a different directory replaces the active cache
    (the old writer thread is stopped)."""
    global _cache
    if path is None:
        path = envs.get_path("MXNET_COMPILE_CACHE_DIR")
        if not path:
            raise ValueError(
                "compile_cache.enable: pass path= or set "
                "MXNET_COMPILE_CACHE_DIR")
    # one construction at a time: concurrent first builds must share
    # ONE cache object — a losing duplicate would leak its writer
    # thread and strand its counters
    with _enable_lock:
        with _lock:
            if _cache is not None and \
                    _cache.dir == os.path.abspath(path):
                if max_mb is not None:
                    _cache.max_bytes = max(
                        1, int(float(max_mb) * (1 << 20)))
                return _cache
        c = _Cache(path, max_mb=max_mb)
        with _lock:
            old, _cache = _cache, c
    if old is not None:
        old.pending.put(None)
    return c


def disable():
    """Deactivate (entries stay on disk for the next enable)."""
    global _cache, _env_failed
    _env_failed = False
    with _lock:
        c, _cache = _cache, None
    if c is not None:
        c.pending.put(None)


def graph_token(text):
    """The ONE content-fingerprint rule for cache-key material (a
    source's text, an artifact's bytes): every producer uses this
    helper so the key's content-identity definition lives in exactly
    one place."""
    if not isinstance(text, bytes):
        text = text.encode()
    return hashlib.sha256(text).hexdigest()


_env_failed = False


def maybe_enable():
    """Enable when ``MXNET_COMPILE_CACHE_DIR`` names a directory
    (checked before each build of device code). Returns True when
    active after the call."""
    global _env_failed
    if _cache is not None:
        return True
    if _env_failed:
        return False
    path = envs.get_path("MXNET_COMPILE_CACHE_DIR")
    if not path:
        return False
    try:
        enable(path)
    except OSError as exc:
        # an unwritable cache dir degrades to no cache, never kills
        # the job. The warn-once latch is process-LOCAL — mutating
        # os.environ would leak the failure into every child process
        # and block an explicit in-process enable() retry
        warnings.warn("compile_cache: cannot use %r (%s); persistent "
                      "compile cache disabled" % (path, exc))
        _env_failed = True
        return False
    return True


def cache_dir():
    """The active cache directory (None when off)."""
    c = _cache
    return c.dir if c is not None else None


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

_tags = {}             # toolchain -> version tag, read once per process
_key_tags = {}         # entry key -> the version tag it was made under


def _toolchain_version(toolchain):
    if toolchain == "nvcc":
        from .parallel import _build
        return _build.nvcc_version()
    if toolchain == "nvrtc":
        from . import rtc
        return rtc.nvrtc_version()
    return None


def _version_tag(site=None):
    """The compiler/topology fingerprint a binary is only valid under:
    the port's version, torch's and its CUDA's, the version of the
    toolchain that builds ``site``'s entries (none for other sites),
    and the device's name, compute capability and count."""
    toolchain = str(site).split(":", 1)[0]
    if toolchain not in ("nvcc", "nvrtc"):
        toolchain = None
    tag = _tags.get(toolchain)
    if tag is None:
        import torch

        from .libinfo import __version__ as mx_version
        if torch.cuda.is_available():
            device = (torch.cuda.get_device_name(0),
                      "%d.%d" % torch.cuda.get_device_capability(0),
                      torch.cuda.device_count())
        else:
            device = ("cpu", None, 0)
        tag = _tags[toolchain] = (
            mx_version, torch.__version__, torch.version.cuda,
            _toolchain_version(toolchain)) + device
    return tag


def _tag_of(key):
    tag = _key_tags.get(key)
    return tag if tag is not None else _version_tag()


def entry_key(site, statics, signature, options=None):
    """The sha256 entry name for one build. Every component reprs into
    the hash — a changed flag, an edited source, a toolkit upgrade or
    a different card is a different file, so a stale entry can never be
    loaded for the wrong build."""
    tag = _version_tag(site)
    raw = repr((site, statics, signature, options, tag))
    key = hashlib.sha256(raw.encode()).hexdigest()
    _key_tags[key] = tag
    return key


# ---------------------------------------------------------------------------
# entry files and payload parts
# ---------------------------------------------------------------------------

def _frame(tag, payload):
    header = json.dumps({
        "format": _FORMAT, "tag": list(tag), "size": len(payload),
        "sha256": hashlib.sha256(payload).hexdigest()}).encode()
    return _MAGIC + struct.pack("<I", len(header)) + header + payload


def _unframe(blob, tag):
    """The payload of entry ``blob``; ValueError unless it is whole and
    was written under ``tag``."""
    if blob[:4] != _MAGIC or len(blob) < 8:
        raise ValueError("not a compile-cache entry")
    (n,) = struct.unpack("<I", blob[4:8])
    header = json.loads(blob[8:8 + n].decode())
    payload = blob[8 + n:]
    if header.get("format") != _FORMAT or \
            header.get("tag") != json.loads(json.dumps(list(tag))):
        raise ValueError("stale cache entry (format/version)")
    if header.get("size") != len(payload) or header.get("sha256") != \
            hashlib.sha256(payload).hexdigest():
        raise ValueError("truncated or corrupt cache entry")
    return payload


def pack_parts(*parts):
    """One payload of several byte strings (a library and its log, a
    cubin and its lowered names)."""
    out = [struct.pack("<I", len(parts))]
    for p in parts:
        out += [struct.pack("<Q", len(p)), p]
    return b"".join(out)


def unpack_parts(payload):
    """The byte strings :func:`pack_parts` joined."""
    (n,) = struct.unpack_from("<I", payload, 0)
    at, parts = 4, []
    for _ in range(n):
        (size,) = struct.unpack_from("<Q", payload, at)
        parts.append(payload[at + 8:at + 8 + size])
        at += 8 + size
    return parts


# ---------------------------------------------------------------------------
# lookup / store
# ---------------------------------------------------------------------------

_tls = threading.local()


def thread_outcomes():
    """(hits, misses) of the lookups this thread has made: a capture
    reads it before and after to tag its compile record."""
    return getattr(_tls, "hits", 0), getattr(_tls, "misses", 0)


def _note(outcome):
    setattr(_tls, outcome, getattr(_tls, outcome, 0) + 1)


def lookup(key):
    """The payload bytes stored under ``key``, or None on a miss.
    Corrupt, truncated or version-mismatched entries are misses:
    counted, the bad file removed, never an exception."""
    c = _cache
    if c is None:
        return None
    path = c._path(key)
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        with _lock:
            c.misses += 1
        _count("misses")
        _note("misses")
        return None
    t0 = time.perf_counter()
    try:
        payload = _unframe(blob, _tag_of(key))
    except (ValueError, struct.error, UnicodeDecodeError):
        # a bad entry degrades to a miss — and is removed so the next
        # run pays the read at most once
        try:
            os.unlink(path)
        except OSError:
            pass
        with _lock:
            c.misses += 1
            c.errors += 1
        _count("misses")
        _count("errors")
        _note("misses")
        return None
    dur = time.perf_counter() - t0
    try:
        os.utime(path)               # LRU: a hit is a use
    except OSError:
        pass
    with _lock:
        c.hits += 1
        c.hit_s += dur
        c.bytes_read += len(blob)
    _count("hits")
    _count("bytes_read", len(blob))
    _note("hits")
    return payload


def store(key, payload):
    """Queue one freshly built binary (bytes) for the background writer
    (atomic tmp+replace, then LRU eviction). Never blocks the caller: a
    full queue drops the store (counted) and the entry stays cold."""
    c = _cache
    if c is None:
        return
    try:
        c.pending.put_nowait((key, bytes(payload)))
    except _queue_mod.Full:
        with _lock:
            c.stores_dropped += 1
        _count("stores_dropped")


def flush(timeout=None):
    """Block until every queued store has hit disk (tests, and a
    serving ``warmup()`` so a replica's binaries persist before
    traffic). No-op when off."""
    c = _cache
    if c is None:
        return
    if timeout is None:
        c.pending.join()
        return
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if c.pending.unfinished_tasks == 0:
            return
        time.sleep(0.01)


def stats():
    """Counters + directory occupancy snapshot (None when off) — the
    diagnose Compile-cache row."""
    c = _cache
    if c is None:
        return None
    size = 0
    entries = 0
    try:
        for name in os.listdir(c.dir):
            if name.endswith(_SUFFIX):
                try:
                    size += os.stat(os.path.join(c.dir, name)).st_size
                    entries += 1
                except OSError:
                    pass
    except OSError:
        pass
    with _lock:
        return {
            "dir": c.dir,
            "hits": c.hits,
            "misses": c.misses,
            "errors": c.errors,
            "evictions": c.evictions,
            "stores": c.stores,
            "stores_dropped": c.stores_dropped,
            "bytes_read": c.bytes_read,
            "bytes_written": c.bytes_written,
            "hit_s": round(c.hit_s, 6),
            "entries": entries,
            "size_bytes": size,
            "max_bytes": c.max_bytes,
        }
