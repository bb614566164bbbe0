"""Staged asynchronous input pipeline: a multi-worker decode pool and
device prefetch, so that ``data_wait`` leaves the step's critical path
(counterpart of ``mxnet_tpu/io/pipeline.py``; the reference's
PrefetcherIter -> ThreadedIter -> BatchLoader stack, after the staged
design of tf.data, Murray et al., VLDB 2021).

1. **Decode pool** — ``MXNET_DATA_WORKERS`` threads (numpy, cv2 and PIL
   release the GIL). One scheduler thread pulls work items from the
   source *in order* and fans the decode out to the pool; the futures
   enter the hand-off queue in submission order, so delivery order is
   the source order. A source with the split protocol
   (``next_raw``/``decode_raw``: ``NDArrayIter``, ``ImageRecordIter``)
   decodes on many workers into host tensors; any other iterator is
   called through ``next()`` on the scheduler thread.
2. **Device prefetch** — a placer thread copies each batch to its
   target (a ``torch.device``, a :class:`~mxnet_tpu_torch.Context` or a
   per-array callable ``(name, tensor) -> target``) up to
   ``prefetch_depth`` batches ahead: on a CUDA target each array is
   copied from pinned host memory (``pin_memory()``, torch's caching
   host allocator) with ``non_blocking=True`` on the placer's own
   ``torch.cuda.Stream``, and the placer waits for that stream, so the
   consumer receives batches whose copies have landed and the copies
   overlap the step running on the consumer's stream. Each array's
   bytes and copy time are accounted under the telemetry ``h2d`` kind
   (``telemetry.h2d``: the ``comms`` ledger and the ``h2d_calls`` /
   ``h2d_bytes`` profiler counters).
3. **Bounded buffering** — every queue is bounded (decode: workers +
   depth; ready: ``prefetch_depth``), every put is stop-aware, and
   shutdown drains the queues before it joins, so ``reset()``,
   ``close()`` and garbage collection never leave a thread blocked.

**Across streams.** A batch the placer copied was allocated on the
placer's stream and is read on the consumer's. At the hand-off in
:meth:`AsyncInputPipeline.next` each copied tensor is marked with
``record_stream(current_stream)``, so the caching allocator does not
give its memory to a later copy on the placer's stream before the
consumer's work on it has run. The executor takes a placed batch into
its bound inputs with one device-to-device ``copy_``.

The consumer-side ``data_wait`` span opens only when the ready queue
is dry (a non-blocking get is tried first), so the phase measures
input stalls, not every fetch. A failed decode or placement raises in
the consumer.

:func:`make_sharded_pipeline` places for a rank mesh: each rank's
placer takes its ``dp`` rows of every array whose leading dim splits
over the axis (a :class:`RowShard` target) and leaves the rest whole;
the placed arrays are marked, so the data-parallel step does not take
rows a second time.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import envs
from ..context import Context
from ..ndarray import NDArray
from .io import DataBatch, DataIter

__all__ = ["AsyncInputPipeline", "data_workers", "pipeline_enabled",
           "placement_for_module", "make_sharded_pipeline",
           "place_batch", "stop_aware_put"]

_SENTINEL = object()      # end-of-epoch marker
_PUT_TICK = 0.05          # stop-aware put poll interval (seconds)
_JOIN_S = 5.0             # shutdown's bound on each thread's join


def stop_aware_put(q, item, stop, tick=_PUT_TICK):
    """A bounded put that gives up when ``stop`` fires, so a full queue
    never holds a producer past shutdown. Returns False when the put was
    abandoned."""
    while not stop.is_set():
        try:
            q.put(item, timeout=tick)
            return True
        except queue.Full:
            continue
    return False


def data_workers(default=2):
    """The configured decode-pool width (``MXNET_DATA_WORKERS``)."""
    return max(1, envs.get_int("MXNET_DATA_WORKERS", default))


def pipeline_enabled():
    """The ``MXNET_DATA_PIPELINE`` gate of the fit loops (on by
    default; re-read at each fit)."""
    return envs.get_bool("MXNET_DATA_PIPELINE")


# ---------------------------------------------------------------------------
# device placement
# ---------------------------------------------------------------------------

def _device(target):
    """A placement target as a ``torch.device`` (None stays None)."""
    if target is None:
        return None
    if isinstance(target, Context):
        return target.torch_device()
    device = torch.device(target)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class RowShard:
    """A placement target that keeps rows ``[index * k, (index + 1) * k)``
    of an array whose leading dim is ``n * k``, on ``device``."""
    __slots__ = ("device", "n", "index")

    def __init__(self, device, n, index):
        self.device, self.n, self.index = device, int(n), int(index)


def _target(placement, name, data):
    """The device of one array (or a :class:`RowShard`): ``placement``
    itself, or its answer for ``(name, tensor)`` when it is a
    callable."""
    if callable(placement) and not isinstance(placement,
                                              (Context, torch.device)):
        placement = placement(name, data)
    if isinstance(placement, RowShard):
        return RowShard(_device(placement.device), placement.n,
                        placement.index)
    return _device(placement)


class _Placer:
    """Copies arrays to their devices; one CUDA stream per device, made
    on first use. Records the tensors it allocated, for the hand-off's
    ``record_stream``."""

    def __init__(self):
        self._streams = {}

    def stream(self, device):
        s = self._streams.get(device)
        if s is None:
            s = self._streams[device] = torch.cuda.Stream(device)
        return s

    def put(self, arr, device, name, copied):
        """``arr`` (an NDArray) on ``device``, accounted under h2d. An
        array already there passes through (its bytes still count, as
        the JAX package counts a resident array)."""
        from .. import telemetry, tracing
        t0 = time.perf_counter()
        data = arr._data
        out = arr
        if data.device != device:
            if device.type == "cuda":
                src = data.pin_memory() if data.device.type == "cpu" \
                    and not data.is_pinned() else data
                stream = self.stream(device)
                with torch.cuda.stream(stream):
                    moved = src.to(device, non_blocking=True)
                stream.synchronize()
                copied.append(moved)
            else:
                moved = data.to(device)
            out = NDArray(moved)
        dur = time.perf_counter() - t0
        nbytes = data.numel() * data.element_size()
        telemetry.h2d(name, nbytes, dur)
        if tracing._tracer is not None:
            # the placer runs ahead of consumption: the context token
            # parents the copy to the step open while it ran
            args = tracing.context() or {}
            args["bytes"] = nbytes
            tracing.add("h2d:%s" % name, "io", t0, dur,
                        tid=tracing.track("io:h2d"), args=args)
        return out


def _place(batch, placement, data_names, label_names, placer, copied):
    if isinstance(batch, NDArray):
        name = data_names[0] if data_names else "data"
        device = _target(placement, name, batch._data)
        if isinstance(device, RowShard):
            k = batch.shape[0] // device.n
            placed = placer.put(
                NDArray(batch._data[device.index * k:(device.index + 1) * k]),
                device.device, name, copied)
            placed._dp_local = True
            return placed
        return batch if device is None else \
            placer.put(batch, device, name, copied)
    if isinstance(batch, DataBatch):
        names_d = [d.name for d in batch.provide_data] \
            if batch.provide_data else list(data_names or [])
        names_l = [lb.name for lb in batch.provide_label] \
            if batch.provide_label else list(label_names or [])

        def roster(arrays, names, fallback):
            if arrays is None:
                return None
            out = []
            for i, a in enumerate(arrays):
                if not isinstance(a, NDArray):
                    out.append(a)       # numpy leaves stay on the host
                    continue
                name = names[i] if i < len(names) else \
                    "%s%d" % (fallback, i)
                out.append(_place(a, placement, [name], None, placer,
                                  copied))
            return out

        placed = DataBatch(roster(batch.data, names_d, "data"),
                           roster(batch.label, names_l, "label"),
                           pad=batch.pad, index=batch.index,
                           bucket_key=batch.bucket_key,
                           provide_data=batch.provide_data,
                           provide_label=batch.provide_label)
        for extra in ("valid_lengths", "valid_rows"):
            if hasattr(batch, extra):
                setattr(placed, extra, getattr(batch, extra))
        return placed
    if isinstance(batch, (list, tuple)):
        # a 2-element batch is the (data, label) convention: the second
        # element's h2d is accounted under the label's name
        names_per = [data_names] * len(batch)
        if len(batch) == 2:
            names_per[1] = label_names or ["label"]
        placed = [_place(b, placement, names_per[i], label_names, placer,
                         copied) for i, b in enumerate(batch)]
        if hasattr(batch, "_fields"):    # namedtuple: positional fields
            return type(batch)(*placed)
        return type(batch)(placed)
    return batch


def place_batch(batch, placement, data_names=None, label_names=None):
    """One batch's arrays on ``placement``: a :class:`DataBatch`, a bare
    NDArray, or (nested) lists and tuples of them (the Gluon
    DataLoader's ``(data, label)`` pairs). Other leaves pass through.
    The copies are complete when this returns."""
    if placement is None or batch is None:
        return batch
    return _place(batch, placement, data_names, label_names, _Placer(), [])


def placement_for_module(module):
    """The placement of a bound Module's batches: each array on the
    device of the executor's bound array of the same name (the bound
    context's device for any other name). None when the module has no
    executor."""
    ex = getattr(module, "_exec", None)
    if ex is None:
        return None
    default = ex._ctx.torch_device()

    def place(name, arr):
        bound = ex.arg_dict.get(name)
        return bound._data.device if bound is not None else default
    return place


def _dp_placement(mesh, device, batch_args=None, axis="dp"):
    """The data-parallel placement of a rank mesh as a callable: a batch
    arg whose leading dim splits over the ``axis`` size goes to this
    rank's rows on ``device`` (a :class:`RowShard`), anything else whole
    on ``device``."""
    n_dp = mesh.axis_size(axis)
    index = mesh.axis_index(axis)

    def place(name, arr):
        if (batch_args is None or name in batch_args) \
                and getattr(arr, "ndim", 0) >= 1 \
                and arr.shape[0] % n_dp == 0:
            return RowShard(device, n_dp, index)
        return device
    return place


def make_sharded_pipeline(source, mesh, prefetch_depth=2,
                          num_workers=None):
    """A pipeline whose batches land as this rank's ``dp`` rows of every
    batch-divisible array (the rest whole) on the current context's
    device: what ``parallel.data_parallel``'s step consumes without
    taking rows again."""
    from ..context import current_context
    target = _device(current_context())
    return AsyncInputPipeline(source, num_workers=num_workers,
                              prefetch_depth=prefetch_depth,
                              placement=_dp_placement(mesh, target))


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

class AsyncInputPipeline(DataIter):
    """Three-stage asynchronous wrapper around a :class:`DataIter` (or
    anything with ``next()``/``reset()``): a decode pool of
    ``num_workers`` for a split-protocol source, in source order; a
    placer that copies each batch to ``placement`` ahead of consumption;
    bounded, stop-aware queues between them. The source's
    ``StopIteration`` ends the epoch; ``reset()`` restarts cleanly."""

    def __init__(self, source, num_workers=None, prefetch_depth=2,
                 placement=None):
        super().__init__(getattr(source, "batch_size", 0) or 0)
        self._source = source
        self._workers = max(1, int(num_workers if num_workers is not None
                                   else data_workers()))
        self.prefetch_depth = max(1, int(prefetch_depth))
        self._placement = placement
        self._split = hasattr(source, "next_raw") and \
            hasattr(source, "decode_raw")
        try:
            self._data_names = [d.name if hasattr(d, "name") else d[0]
                                for d in source.provide_data]
        except Exception:
            self._data_names = []
        try:
            self._label_names = [lb.name if hasattr(lb, "name") else lb[0]
                                 for lb in source.provide_label]
        except Exception:
            self._label_names = []
        self._placer_state = _Placer()
        self._stop = None
        self._threads = []
        self._pool = None
        self._decode_q = None
        self._ready_q = None
        self._exhausted = False
        self._cached = None
        self._start()

    @property
    def provide_data(self):
        return self._source.provide_data

    @property
    def provide_label(self):
        return self._source.provide_label

    def set_placement(self, placement):
        """Place on ``placement`` from the next batch the placer takes;
        batches already in the ready queue keep their old place (the
        executor copies them into its bound arrays all the same)."""
        self._placement = placement

    # -- lifecycle ---------------------------------------------------------
    def _start(self):
        self._stop = threading.Event()
        self._exhausted = False
        self._decode_q = queue.Queue(
            maxsize=self._workers + self.prefetch_depth)
        self._ready_q = queue.Queue(maxsize=self.prefetch_depth)
        self._pool = ThreadPoolExecutor(
            max_workers=self._workers, thread_name_prefix="mxio-decode") \
            if self._split and self._workers > 1 else None
        sched = threading.Thread(target=self._scheduler, daemon=True,
                                 name="mxio-sched")
        placer = threading.Thread(target=self._placer, daemon=True,
                                  name="mxio-place")
        self._threads = [sched, placer]
        sched.start()
        placer.start()

    def _put(self, q, item):
        return stop_aware_put(q, item, self._stop)

    def _scheduler(self):
        """Stage 1: pull work from the source in order (the source is
        never touched concurrently), fan decode out to the pool, and
        hand futures or batches on in submission order."""
        from .. import tracing
        src = self._source
        try:
            while not self._stop.is_set():
                traced = tracing._tracer is not None
                try:
                    if self._pool is not None:
                        raw = src.next_raw()
                        item = self._pool.submit(
                            self._decode_traced, raw, tracing.context()) \
                            if traced else self._pool.submit(src.decode_raw,
                                                             raw)
                    elif self._split:
                        # one worker: still split, so the random draws
                        # are serial (bit-identical to eager)
                        raw = src.next_raw()
                        item = self._decode_traced(raw, tracing.context()) \
                            if traced else src.decode_raw(raw)
                    else:
                        item = src.next()
                except StopIteration:
                    break
                except Exception as exc:        # raised in the consumer
                    self._put(self._decode_q, exc)
                    return
                if not self._put(self._decode_q, item):
                    return
        finally:
            self._put(self._decode_q, _SENTINEL)

    def _decode_traced(self, raw, ctx):
        """Decode one work item with its trace span, parented to the
        step that triggered it through the propagated ``ctx`` token."""
        from .. import tracing
        t0 = time.perf_counter()
        out = self._source.decode_raw(raw)
        tracing.add("decode", "io", t0, time.perf_counter() - t0,
                    tid=tracing.track("io:decode"), args=ctx)
        return out

    def _placer(self):
        """Stage 2: resolve decode results in order, copy them to their
        devices (waiting here, off the critical path, for the copies to
        land) and fill the ready queue with ``(batch, copied tensors)``."""
        while not self._stop.is_set():
            try:
                item = self._decode_q.get(timeout=_PUT_TICK)
            except queue.Empty:
                continue
            if item is _SENTINEL:
                self._put(self._ready_q, _SENTINEL)
                return
            if isinstance(item, Exception):
                self._put(self._ready_q, item)
                self._stop.set()     # the scheduler must stop decoding
                return
            try:
                batch = item.result() if hasattr(item, "result") else item
                copied = []
                if self._placement is not None and batch is not None:
                    batch = _place(batch, self._placement, self._data_names,
                                   self._label_names, self._placer_state,
                                   copied)
            except Exception as exc:            # noqa: BLE001
                self._put(self._ready_q, exc)
                self._stop.set()
                return
            if not self._put(self._ready_q, (batch, copied)):
                return

    def _shutdown_threads(self):
        """Stop, drain, then join, in that order: draining unblocks a
        producer mid-put, and the stop-aware puts bound its exit. Returns
        the threads still alive after the join's bound (wedged inside a
        stalled source read or decode)."""
        stop = self._stop
        if stop is None:
            return []
        stop.set()
        for q in (self._decode_q, self._ready_q):
            if q is None:
                continue
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        for t in self._threads:
            t.join(timeout=_JOIN_S)
        wedged = [t for t in self._threads if t.is_alive()]
        self._threads = []
        if self._pool is not None:
            # a wedged producer may be inside a pool decode: do not let
            # the pool's shutdown wait on it too
            self._pool.shutdown(wait=not wedged)
            self._pool = None
        return wedged

    def reset(self):
        """Stop, reset the source and restart at the configured depth and
        pool width. Refuses to reset a source a wedged producer is still
        reading."""
        wedged = self._shutdown_threads()
        if wedged:
            from ..base import MXNetError
            raise MXNetError(
                "input pipeline reset: producer thread(s) %s did not exit "
                "within %.0f s (source read stalled?); refusing to reset "
                "the source under a live reader"
                % ([t.name for t in wedged], _JOIN_S))
        self._source.reset()
        self._start()

    def close(self):
        """Tear the pipeline down for good (also at garbage collection).
        The source is the caller's."""
        self._shutdown_threads()

    def __del__(self):
        try:
            self._shutdown_threads()
        except Exception:       # interpreter teardown
            pass

    # -- consumption -------------------------------------------------------
    def next(self):
        if self._exhausted:
            raise StopIteration
        try:
            # a ready batch means no stall: data_wait opens only when the
            # queue is dry
            item = self._ready_q.get_nowait()
        except queue.Empty:
            from .. import telemetry
            with telemetry.span("data_wait"):
                item = self._blocking_get()
        if item is _SENTINEL:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, Exception):
            self._exhausted = True
            raise item
        batch, copied = item
        for t in copied:
            # read on this stream from now on: the allocator must not
            # reuse the block for the placer's next copy before then
            t.record_stream(torch.cuda.current_stream(t.device))
        return batch

    def _blocking_get(self):
        while True:
            try:
                return self._ready_q.get(timeout=_PUT_TICK)
            except queue.Empty:
                if self._stop.is_set() or \
                        not any(t.is_alive() for t in self._threads):
                    # an error put just before the stop still surfaces
                    try:
                        return self._ready_q.get_nowait()
                    except queue.Empty:
                        return _SENTINEL

    def iter_next(self):
        try:
            self._cached = self.next()
            return True
        except StopIteration:
            self._cached = None
            return False

    def getdata(self):
        return self._cached.data

    def getlabel(self):
        return self._cached.label

    def getpad(self):
        return self._cached.pad

    def getindex(self):
        return self._cached.index
