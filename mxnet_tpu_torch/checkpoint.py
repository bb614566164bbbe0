"""Checkpoint manifests: the writer and the reader (counterpart of
``mxnet_tpu/checkpoint.py``).

A manifest checkpoint is a JSON file ``<prefix>-<epoch>.ckpt.json``
that names every artifact of one save with its SHA-256 (shard files of
npz payloads, an optimizer-state sibling), every parameter's layout
(shape, dtype, and its pieces: shard, key, and the global index of a
piece of a sharded entry) and an optional ``meta`` record (the AMP
policy, ``{"dtype_policy": policy.describe()}``). Shard 0 is
``<prefix>-<epoch>.params``, the single-file format ``nd.load`` reads.

**Writing.** :func:`save_arrays` writes the optimizer states first, then
the shards, then the manifest, each through :func:`atomic_write_file`
(tmp + fsync + ``os.replace``, visiting the ``ckpt_write`` and
``ckpt_fsync`` fault sites), so a kill mid-save strands at most
unreferenced files, never a manifest pointing at a torn one. A roster
holding a :class:`~mxnet_tpu_torch.parallel.mesh.ShardedTensor` (the
rank-mesh trainer's sharded parameters and ZeRO-1 state) is saved by
every rank of the mesh, as the JAX package's multi-process save is: each
rank writes the shard file of its own pieces (rank 0's also holds every
whole entry), all meet at a barrier, and rank 0 checksums every shard and
writes the manifest last. :class:`CheckpointManager` runs saves for a training loop:
``save`` snapshots every parameter as a device-side clone on the
training stream (the fused step's graph writes the live weights in
place at its next replay, so the writer must never read them), then a
writer thread behind a bounded queue (``MXNET_CHECKPOINT_INFLIGHT``:
backpressure past it) copies the clones to the host, serializes,
checksums and writes; ``MXNET_ASYNC_CHECKPOINT=0`` runs the same on the
calling thread. A failed save warns and leaves the previous good epoch
as the resume point. Each save is one ``checkpoint`` telemetry record;
:func:`write_bytes_async`/:func:`flush_async_writes` are the shared
background writer of ``Trainer.save_states(background=True)``.

**Reading.** Loading checks each file against its checksum before it
parses it, so a torn write raises
:class:`~mxnet_tpu_torch.base.MXNetError` naming the file, and
re-assembles a sharded entry from its pieces on the host. A bfloat16
entry comes back from npz as raw 2-byte values (``|V2``); numpy has no
bfloat16 dtype without ``ml_dtypes``, so the port reinterprets those
bytes as ``torch.bfloat16``, bit for bit, and writes bfloat16 the same
way. :func:`restore_params` casts a load to an AMP policy.
"""
from __future__ import annotations

import glob
import hashlib
import io as _io
import json
import logging
import os
import queue
import re
import threading
import time

import numpy as np
import torch

from . import envs
from .base import MXNetError
from .ndarray.ndarray import (_flatten_entry, host_numpy, numpy_dtype,
                              tensor_from_numpy)

__all__ = ["CheckpointManager", "async_checkpoint_enabled",
           "manifest_path", "load_manifest", "validate_manifest",
           "latest_manifest_epoch", "load_arrays", "load_param_arrays",
           "restore_params", "save_arrays", "saved_dtype_policy",
           "snapshot_params", "atomic_write_file", "write_bytes_async",
           "flush_async_writes"]

_PIECE_SEP = "::piece"       # shard-file key suffix for partial pieces
MANIFEST_FORMAT = 1


def async_checkpoint_enabled():
    """The ``MXNET_ASYNC_CHECKPOINT`` gate (default on), read per fit."""
    return envs.get_bool("MXNET_ASYNC_CHECKPOINT")


def _tag(prefix, epoch):
    return "%s-%04d" % (prefix, int(epoch))


def manifest_path(prefix, epoch):
    return _tag(prefix, epoch) + ".ckpt.json"


def _sha256(payload):
    return hashlib.sha256(payload).hexdigest()


# ---------------------------------------------------------------------------
# durable writes
# ---------------------------------------------------------------------------

def atomic_write_file(fname, payload):
    """``<fname>.tmp`` + fsync + ``os.replace``, visiting the
    ``ckpt_write``/``ckpt_fsync`` fault sites: a raised fault leaves at
    most a ``.tmp`` behind, never a torn ``fname``."""
    from . import fault
    fault.inject("ckpt_write")
    tmp = fname + ".tmp"
    with open(tmp, "wb") as sink:
        sink.write(payload)
        sink.flush()
        fault.inject("ckpt_fsync")
        os.fsync(sink.fileno())
    os.replace(tmp, fname)


_bytes_q = None
_bytes_thread = None
_bytes_lock = threading.Lock()
_bytes_errors = []       # (fname, "Type: msg") since the last flush


def _bytes_writer_loop():
    while True:
        fname, payload = _bytes_q.get()
        try:
            atomic_write_file(fname, payload)
        except Exception as exc:               # noqa: BLE001
            with _bytes_lock:
                _bytes_errors.append((fname, "%s: %s" % (
                    type(exc).__name__, str(exc)[:200])))
            logging.getLogger(__name__).warning(
                "checkpoint: background write of %s failed (%s: %s)",
                fname, type(exc).__name__, exc)
        finally:
            _bytes_q.task_done()


def write_bytes_async(fname, payload):
    """Durably write ``payload`` (a consistent byte snapshot) to
    ``fname`` from the shared background writer, behind a bounded
    queue."""
    global _bytes_q, _bytes_thread
    with _bytes_lock:
        if _bytes_thread is None or not _bytes_thread.is_alive():
            _bytes_q = queue.Queue(
                maxsize=max(1, envs.get_int("MXNET_CHECKPOINT_INFLIGHT")))
            _bytes_thread = threading.Thread(
                target=_bytes_writer_loop, daemon=True, name="mxckpt-bytes")
            _bytes_thread.start()
    _bytes_q.put((fname, payload))


def flush_async_writes():
    """Block until every :func:`write_bytes_async` payload landed, then
    raise naming the writes that failed since the last flush."""
    q = _bytes_q
    if q is not None:
        q.join()
    with _bytes_lock:
        errors, _bytes_errors[:] = list(_bytes_errors), []
    if errors:
        raise MXNetError("background checkpoint write(s) failed: "
                         + "; ".join("%s (%s)" % e for e in errors))


# ---------------------------------------------------------------------------
# snapshot and serialization
# ---------------------------------------------------------------------------

def snapshot_params(arg_params, aux_params=None, extra=None):
    """A point-in-time capture ``{'arg:name': tensor}`` (plus ``aux:``,
    and ``extra`` under its own keys): a device-side clone of each
    array, enqueued on the calling thread's stream, so a later in-place
    write (the fused step's replay) cannot reach what the writer
    reads. Host values (numpy) are copied."""
    flat = {}
    for prefix, params in (("arg:", arg_params), ("aux:", aux_params)):
        for k, v in (params or {}).items():
            _snap(prefix + k, v, flat)
    for k, v in (extra or {}).items():
        _snap(k, v, flat)
    return flat


def _snap(key, value, flat):
    """One roster entry into ``flat``: a clone of a dense array; a sparse
    array's components (clones) and shape under the ``nd.save`` keys
    (``__sparse_csr__::<key>::data``, ...), as the JAX writer spills
    them."""
    if getattr(value, "stype", "default") != "default":
        _flatten_entry(key, value, flat, lambda t: t.detach().clone())
        return
    from .parallel.mesh import ShardedTensor
    if isinstance(value, ShardedTensor):
        flat[key] = ShardedTensor(value.local.detach().clone(), value.shape,
                                  value.sharding)
        return
    data = getattr(value, "_data", value)
    if isinstance(data, torch.Tensor):
        flat[key] = data.detach().clone()
    else:
        flat[key] = np.array(data, copy=True)


def _host(value):
    return host_numpy(value) if isinstance(value, torch.Tensor) \
        else np.asarray(value)


def _dtype_name(value):
    if isinstance(value, torch.Tensor):
        return str(numpy_dtype(value.dtype))
    return str(np.asarray(value).dtype)


def _shard_file(prefix, epoch, shard, n_shards=1):
    """Shard 0 keeps the single-file name ``nd.load`` reads; the other
    mesh positions get the JAX package's ``.shardNN-of-NN`` names."""
    return _tag(prefix, epoch) + ".params" if shard == 0 else \
        "%s.shard%02d-of-%02d.params" % (_tag(prefix, epoch), shard,
                                         n_shards)


def _split_pieces(flat, me):
    """``(mine, layout, n_shards)`` of a roster with sharded entries:
    this rank's shard-file arrays and every entry's manifest layout. A
    sharded entry contributes one piece per distinct index, in the shard
    of the first rank (in rank order) holding it; whole entries are rank
    0's."""
    from .parallel.mesh import ShardedTensor
    mine, layout, n_shards = {}, {}, 1
    for key, value in flat.items():
        if isinstance(value, ShardedTensor) \
                and not value.is_fully_replicated:
            pieces, seen = [], set()
            for rank, index in value.pieces():
                n_shards = max(n_shards, rank + 1)
                if tuple(map(tuple, index)) in seen:
                    continue          # a replicated copy of a piece
                seen.add(tuple(map(tuple, index)))
                pkey = "%s%s%d" % (key, _PIECE_SEP, len(pieces))
                if rank == me:
                    mine[pkey] = _host(value.local)
                pieces.append({"shard": rank, "key": pkey,
                               "index": [list(ix) for ix in index]})
            layout[key] = {"shape": list(value.shape),
                           "dtype": _dtype_name(value.local),
                           "pieces": pieces}
            continue
        if isinstance(value, ShardedTensor):
            value = value.local
        host = _host(value)
        if me == 0:
            mine[key] = host
        layout[key] = {"shape": [int(d) for d in host.shape],
                       "dtype": _dtype_name(value),
                       "pieces": [{"shard": 0, "key": key, "index": None}]}
    return mine, layout, n_shards


def _save_ranks(prefix, epoch, flat, states_bytes, symbol, meta):
    """The every-rank save of a roster with sharded entries (see the
    module docstring); returns the telemetry stats."""
    import torch.distributed as dist
    from .parallel import distributed
    me = distributed.rank()
    t0 = time.perf_counter()
    mine, layout, n_shards = _split_pieces(flat, me)
    n_shards = max(n_shards, distributed.num_workers())
    t_snap = time.perf_counter()
    dirname = os.path.dirname(prefix)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    payload = _npz_bytes(mine)
    t_ser = time.perf_counter()
    states_entry = None
    if me == 0:
        if symbol is not None:
            symbol.save("%s-symbol.json" % prefix)
        if states_bytes is not None:
            states_file = _tag(prefix, epoch) + ".states"
            atomic_write_file(states_file, states_bytes)
            states_entry = {"file": os.path.basename(states_file),
                            "sha256": _sha256(states_bytes),
                            "bytes": len(states_bytes)}
    atomic_write_file(_shard_file(prefix, epoch, me, n_shards), payload)
    t_write = time.perf_counter()
    distributed.barrier("ckpt/%s" % _tag(prefix, epoch))
    ok = [True]
    if me == 0:
        try:
            shards = []
            for shard in range(n_shards):
                fname = _shard_file(prefix, epoch, shard, n_shards)
                if shard == me:
                    data = payload
                else:
                    with open(fname, "rb") as f:
                        data = f.read()
                shards.append({"file": os.path.basename(fname),
                               "sha256": _sha256(data),
                               "bytes": len(data), "shard": shard})
            manifest = {"format": MANIFEST_FORMAT, "epoch": int(epoch),
                        "time": time.time(), "shards": shards,
                        "params": layout, "processes": n_shards}
            if states_entry is not None:
                manifest["optimizer_states"] = states_entry
            if meta:
                manifest["meta"] = dict(meta)
            atomic_write_file(manifest_path(prefix, epoch),
                              json.dumps(manifest, sort_keys=True).encode())
        except Exception:
            ok = [False]
            dist.broadcast_object_list(ok, src=0)
            raise
    dist.broadcast_object_list(ok, src=0)
    if not ok[0]:
        raise MXNetError("checkpoint %s: rank 0 failed to write the "
                         "manifest" % _tag(prefix, epoch))
    t_end = time.perf_counter()
    return {"epoch": int(epoch), "bytes": len(payload), "shards": n_shards,
            "manifest": me == 0,
            "snapshot_ms": round((t_snap - t0) * 1e3, 3),
            "serialize_ms": round((t_ser - t_snap) * 1e3, 3),
            "write_ms": round((t_write - t_ser) * 1e3, 3),
            "manifest_ms": round((t_end - t_write) * 1e3, 3),
            "total_ms": round((t_end - t0) * 1e3, 3)}


def _npz_bytes(arrays):
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def save_arrays(prefix, epoch, flat, states_bytes=None, symbol=None,
                meta=None):
    """Write one checkpoint of a :func:`snapshot_params` roster: the
    optimizer states, then the shard, then the manifest (with ``meta``
    recorded verbatim), each durably. The device-to-host copy happens
    here, on the calling thread. Returns the stats the telemetry record
    carries; raises on a failure (a planned ``ckpt_write``/
    ``ckpt_fsync`` fault included). A roster with a sharded entry on a
    mesh of several ranks is saved by every rank (:func:`_save_ranks`)."""
    from .parallel import distributed
    from .parallel.mesh import ShardedTensor
    if distributed.num_workers() > 1 and any(
            isinstance(v, ShardedTensor) and not v.is_fully_replicated
            for v in flat.values()):
        return _save_ranks(prefix, epoch, flat, states_bytes, symbol, meta)
    t0 = time.perf_counter()
    arrays, layout = {}, {}
    for key, value in flat.items():
        if isinstance(value, ShardedTensor):
            value = value.local if value.is_fully_replicated \
                else value.full()
        host = _host(value)
        arrays[key] = host
        layout[key] = {"shape": [int(d) for d in host.shape],
                       "dtype": _dtype_name(value),
                       "pieces": [{"shard": 0, "key": key, "index": None}]}
    t_snap = time.perf_counter()
    dirname = os.path.dirname(prefix)
    if dirname:
        os.makedirs(dirname, exist_ok=True)
    payload = _npz_bytes(arrays)
    shard_fname = _shard_file(prefix, epoch, 0)
    t_ser = time.perf_counter()
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    total_bytes = len(payload)
    # states BEFORE the shard: a kill between the two strands only a
    # .states file, never a loadable .params whose states are missing
    states_entry = None
    if states_bytes is not None:
        states_file = _tag(prefix, epoch) + ".states"
        atomic_write_file(states_file, states_bytes)
        states_entry = {"file": os.path.basename(states_file),
                        "sha256": _sha256(states_bytes),
                        "bytes": len(states_bytes)}
        total_bytes += len(states_bytes)
    atomic_write_file(shard_fname, payload)
    t_write = time.perf_counter()
    manifest = {"format": MANIFEST_FORMAT, "epoch": int(epoch),
                "time": time.time(),
                "shards": [{"file": os.path.basename(shard_fname),
                            "sha256": _sha256(payload),
                            "bytes": len(payload), "shard": 0}],
                "params": layout}
    if states_entry is not None:
        manifest["optimizer_states"] = states_entry
    if meta:
        manifest["meta"] = dict(meta)
    atomic_write_file(manifest_path(prefix, epoch),
                      json.dumps(manifest, sort_keys=True).encode())
    t_end = time.perf_counter()
    return {"epoch": int(epoch), "bytes": total_bytes, "shards": 1,
            "snapshot_ms": round((t_snap - t0) * 1e3, 3),
            "serialize_ms": round((t_ser - t_snap) * 1e3, 3),
            "write_ms": round((t_write - t_ser) * 1e3, 3),
            "manifest_ms": round((t_end - t_write) * 1e3, 3),
            "total_ms": round((t_end - t0) * 1e3, 3)}


def latest_manifest_epoch(prefix, validate=True):
    """The newest epoch under ``prefix`` whose manifest (and, with
    ``validate``, every artifact it references) checks out; torn or
    corrupt epochs are skipped with a warning. None when nothing usable
    exists."""
    base = os.path.basename(prefix)
    dirname = os.path.dirname(prefix) or "."
    # \d{4,}: '%04d' grows past four digits at epoch 10000
    pat = re.compile(re.escape(base) + r"-(\d{4,})\.ckpt\.json$")
    epochs = []
    for path in glob.glob(os.path.join(dirname, base + "-*.ckpt.json")):
        m = pat.match(os.path.basename(path))
        if m:
            epochs.append(int(m.group(1)))
    for epoch in sorted(epochs, reverse=True):
        try:
            if validate:
                validate_manifest(prefix, epoch)
            elif load_manifest(prefix, epoch) is None:
                continue
            return epoch
        except (MXNetError, ValueError, OSError) as exc:
            logging.getLogger(__name__).warning(
                "checkpoint scan: epoch %04d under %s is torn/corrupt "
                "(%s) — skipping", epoch, prefix, exc)
    return None


def load_manifest(prefix, epoch):
    """The parsed manifest for ``(prefix, epoch)``, or None when the
    epoch has none (a single-file checkpoint)."""
    path = manifest_path(prefix, epoch)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def _read_entry(prefix, epoch, entry, validate=True):
    """One artifact's bytes, after checking that it exists and (with
    ``validate``) matches its recorded SHA-256; raises naming the
    missing or torn file."""
    base = os.path.dirname(_tag(prefix, epoch))
    path = os.path.join(base, entry["file"]) if base else entry["file"]
    if not os.path.isfile(path):
        raise MXNetError("checkpoint %s: missing artifact %s"
                         % (_tag(prefix, epoch), entry["file"]))
    with open(path, "rb") as f:
        payload = f.read()
    if validate and _sha256(payload) != entry["sha256"]:
        raise MXNetError("checkpoint %s: artifact %s is torn/corrupt "
                         "(checksum mismatch)"
                         % (_tag(prefix, epoch), entry["file"]))
    return payload


def validate_manifest(prefix, epoch, manifest=None):
    """Check every artifact the manifest references (shards and the
    optimizer-state sibling) against its SHA-256; raises naming the torn
    file, returns the manifest."""
    manifest = manifest if manifest is not None \
        else load_manifest(prefix, epoch)
    if manifest is None:
        raise MXNetError("no manifest for %s" % _tag(prefix, epoch))
    entries = list(manifest["shards"])
    if manifest.get("optimizer_states") is not None:
        entries.append(manifest["optimizer_states"])
    for entry in entries:
        _read_entry(prefix, epoch, entry)
    return manifest


def _restore_dtype(arr, entry):
    """A CPU tensor of one loaded array in its manifest dtype: raw
    2-byte values recorded as bfloat16 are reinterpreted bit for bit;
    another recorded dtype of the same width is a numpy view."""
    want = entry.get("dtype")
    if want and want != "bfloat16" and str(arr.dtype) != want:
        dt = np.dtype(want)
        arr = arr.view(dt) if arr.dtype.itemsize == dt.itemsize \
            else arr.astype(dt)
    out = tensor_from_numpy(arr)
    if want == "bfloat16" and out.dtype != torch.bfloat16:
        raise MXNetError("checkpoint entry recorded as bfloat16 holds %s"
                         % arr.dtype)
    return out


_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32}


def _read_host(prefix, epoch, validate):
    """``{key: CPU tensor}`` of a manifest checkpoint, sharded entries
    re-assembled from their pieces; float64 and int64 entries come back
    as float32 and int32, as the JAX package's ``nd.array`` gives them."""
    manifest = load_manifest(prefix, epoch)
    if manifest is None:
        raise MXNetError("no manifest for %s" % _tag(prefix, epoch))
    shard_data = []
    for entry in manifest["shards"]:
        payload = _read_entry(prefix, epoch, entry, validate=validate)
        shard_data.append(dict(np.load(_io.BytesIO(payload),
                                       allow_pickle=False)))
    if validate and manifest.get("optimizer_states") is not None:
        _read_entry(prefix, epoch, manifest["optimizer_states"])
    out = {}
    for key, entry in manifest["params"].items():
        pieces = entry["pieces"]
        if len(pieces) == 1 and pieces[0]["index"] is None:
            out[key] = _restore_dtype(
                shard_data[pieces[0]["shard"]][pieces[0]["key"]], entry)
            continue
        full = None
        for p in pieces:
            part = _restore_dtype(shard_data[p["shard"]][p["key"]], entry)
            if full is None:
                full = torch.empty(tuple(entry["shape"]), dtype=part.dtype)
            full[tuple(slice(a, b) for a, b in p["index"])] = part
        out[key] = full
    return {k: v.to(_CANONICAL.get(v.dtype, v.dtype))
            for k, v in out.items()}


def load_arrays(prefix, epoch, validate=True, ctx=None):
    """A manifest checkpoint as a flat ``{'arg:name': NDArray}`` dict on
    ``ctx`` (the current context by default), a sparse entry put back
    together from its components. ``validate`` checksums every artifact
    against the bytes it parses (one read a file), so a torn write
    raises."""
    from .ndarray.ndarray import unflatten_arrays
    return unflatten_arrays(_read_host(prefix, epoch, validate), ctx)


def load_param_arrays(prefix, epoch, validate=True):
    """``{name: CPU tensor}`` of a manifest checkpoint's entries under
    their plain names (``arg:``/``aux:`` dropped; a sparse entry dense):
    the decode server's weight swap source
    (``DecodeServer.swap_weights(prefix=, epoch=)``). The caller places
    them; host tensors stand where the JAX package returns numpy arrays,
    since numpy has no bfloat16."""
    from .context import cpu
    from .ndarray.ndarray import unflatten_arrays
    flat = unflatten_arrays(_read_host(prefix, epoch, validate), cpu())
    return {(k.split(":", 1)[1] if ":" in k else k): v.tostype("default")
            ._data for k, v in flat.items()}


def saved_dtype_policy(prefix, epoch):
    """The :class:`~mxnet_tpu_torch.amp.DtypePolicy` a manifest
    checkpoint was saved under (its ``meta.dtype_policy``), or None."""
    from .amp import DtypePolicy
    manifest = load_manifest(prefix, epoch)
    meta = (manifest or {}).get("meta") or {}
    return DtypePolicy.from_describe(meta.get("dtype_policy"))


def restore_params(prefix, epoch, validate=True, policy=None, ctx=None):
    """``(arg_params, aux_params)`` of a manifest checkpoint. ``policy``
    casts each parameter to its resolved dtype: an ``amp.DtypePolicy``
    resumes under that policy (an AMP checkpoint stores fp32 masters, so
    any resume precision is a cast of the exact master), ``"manifest"``
    re-adopts the policy the checkpoint was saved under. Placement on a
    rank mesh is ``parallel.DistributedTrainer.load_checkpoint``'s."""
    flat = load_arrays(prefix, epoch, validate=validate, ctx=ctx)
    arg_params, aux_params = {}, {}
    for k, v in flat.items():
        tp, name = k.split(":", 1)
        (arg_params if tp == "arg" else aux_params)[name] = v
    if policy == "manifest":
        policy = saved_dtype_policy(prefix, epoch)
    if policy is not None:
        arg_params = policy.cast_params(arg_params)
        aux_params = policy.cast_params(aux_params)
    return arg_params, aux_params


# ---------------------------------------------------------------------------
# the manager: a bounded-queue background writer
# ---------------------------------------------------------------------------

_CLOSE = object()


class CheckpointManager:
    """One checkpoint prefix's save pipeline for a training loop. Async
    mode (default): ``save()`` snapshots (device-side clones) under the
    telemetry ``checkpoint`` phase, waits only when the bounded queue is
    full, and returns; a writer thread does the rest. Sync mode runs the
    same writer code on the calling thread. A failed save warns and
    leaves :attr:`last_good_epoch` as it was."""

    def __init__(self, prefix, symbol=None, async_=None, inflight=None,
                 logger=None, meta=None):
        self.prefix = prefix
        self._symbol = symbol
        self._symbol_saved = False
        self.meta = dict(meta) if meta else None
        self.async_ = async_checkpoint_enabled() if async_ is None \
            else bool(async_)
        depth = inflight if inflight is not None \
            else envs.get_int("MXNET_CHECKPOINT_INFLIGHT")
        self._q = queue.Queue(maxsize=max(1, int(depth)))
        self._thread = None
        self._lock = threading.Lock()
        self.logger = logger or logging.getLogger(__name__)
        self.last_good_epoch = None
        self.saves = 0
        self.failures = 0
        self.bytes_written = 0
        self.last_blocking_ms = None

    def save(self, epoch, arg_params, aux_params=None, states_bytes=None,
             extra=None):
        """Checkpoint ``epoch``. The caller blocks for the snapshot (and,
        under backpressure, the queue) in async mode, for the whole
        durable write in sync mode."""
        from . import telemetry, tracing
        with telemetry.span("checkpoint"):
            t0 = time.perf_counter()
            ctx = tracing.context()
            flat = snapshot_params(arg_params, aux_params, extra=extra)
            if not self.async_:
                self._write(epoch, flat, states_bytes, t0, blocking=True,
                            ctx=ctx)
                self.last_blocking_ms = (time.perf_counter() - t0) * 1e3
                return
            self._ensure_thread()
            timing = {"t0": t0, "ctx": ctx}
            self._q.put((epoch, flat, states_bytes, timing))
            timing["t_enq"] = time.perf_counter()
            self.last_blocking_ms = (timing["t_enq"] - t0) * 1e3

    def wait(self):
        """Block until every enqueued save was written (or failed)."""
        if self._thread is not None:
            self._q.join()

    def close(self):
        """Drain the in-flight saves and stop the writer thread; safe to
        call twice (a later save starts a new thread)."""
        if self._thread is None:
            return
        self._q.join()
        self._q.put(_CLOSE)
        self._thread.join(timeout=30)
        self._thread = None

    def stats(self):
        with self._lock:
            return {"saves": self.saves, "failures": self.failures,
                    "bytes_written": self.bytes_written,
                    "last_good_epoch": self.last_good_epoch,
                    "async": self.async_}

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._writer_loop,
                                            daemon=True, name="mxckpt-write")
            self._thread.start()

    def _writer_loop(self):
        while True:
            item = self._q.get()
            if item is _CLOSE:
                self._q.task_done()
                return
            epoch, flat, states_bytes, timing = item
            try:
                self._write(epoch, flat, states_bytes, timing["t0"],
                            blocking=False, t_enq=timing.get("t_enq"),
                            ctx=timing.get("ctx"))
            finally:
                self._q.task_done()

    def _symbol_once(self):
        if self._symbol is not None and not self._symbol_saved:
            self._symbol.save("%s-symbol.json" % self.prefix)
            self._symbol_saved = True

    def _write(self, epoch, flat, states_bytes, t0, blocking, t_enq=None,
               ctx=None):
        """One durable save and its accounting; never raises."""
        from . import telemetry, tracing
        t_work0 = time.perf_counter()
        if t_enq is None and not blocking:
            t_enq = time.perf_counter()
        rec = {"epoch": int(epoch), "async": not blocking}
        try:
            self._symbol_once()
            st = save_arrays(self.prefix, epoch, flat,
                             states_bytes=states_bytes, meta=self.meta)
            rec.update(st, ok=True)
            with self._lock:
                self.saves += 1
                self.bytes_written += st["bytes"]
                if self.last_good_epoch is None \
                        or epoch > self.last_good_epoch:
                    self.last_good_epoch = epoch
        except Exception as exc:               # noqa: BLE001
            with self._lock:
                self.failures += 1
            rec.update(ok=False, error="%s: %s" % (type(exc).__name__,
                                                   str(exc)[:200]))
            self.logger.warning(
                "checkpoint: save of epoch %d failed (%s: %s) — last good "
                "epoch is %s", epoch, type(exc).__name__, exc,
                self.last_good_epoch)
        now = time.perf_counter()
        if blocking:
            rec["blocking_ms"] = round((now - t0) * 1e3, 3)
            rec["async_ms"] = 0.0
        else:
            rec["blocking_ms"] = round((t_enq - t0) * 1e3, 3)
            rec["async_ms"] = round((now - t_enq) * 1e3, 3)
        rec["last_good_epoch"] = self.last_good_epoch
        if tracing._tracer is not None:
            args = dict(ctx or {})
            args.update(epoch=int(epoch), ok=bool(rec.get("ok")),
                        bytes=rec.get("bytes", 0))
            tracing.add("ckpt:epoch%04d" % int(epoch), "checkpoint",
                        t_work0, now - t_work0,
                        tid=tracing.track("checkpoint"), args=args)
        telemetry.checkpoint_event(rec)
