"""The continuous-batching inference server (counterpart of
``mxnet_tpu/serving/server.py``), plus the serving error types and
priority helpers the decode server and the router share.

One :class:`InferenceServer` = one model (a deploy artifact's bucket
ladder, or an in-process batched callable), one bounded admission
queue, one batcher thread, and one worker thread per replica:

- **Admission** — :meth:`InferenceServer.submit` validates the request
  against the artifact meta, then either enqueues it (FIFO, bounded by
  ``max_queue``) or sheds it with :class:`ServerOverloadedError` when
  the queue is full (``block=True`` instead waits for space —
  backpressure — bounded by the request's own deadline).
- **Batching** — the batcher thread coalesces waiting requests (after
  a ``batch_window_ms`` straggler window) into the smallest ladder
  bucket that fits, drops requests whose deadline already passed
  (:class:`RequestTimeoutError`), and hands the batch to the replica
  with the fewest outstanding batches (at most
  ``MXNET_SERVING_MAX_OUTSTANDING`` each).
- **Replicas** — each replica owns one device (``devices=``, else the
  visible CUDA devices; a list may repeat a device); its worker pads
  the batch to the bucket shape, places it on its device, and runs the
  bucket's program there under ``torch.inference_mode()`` (grad mode
  is thread-local in torch). Each bucket (or bucket x seq rung) is one
  ``compile_watch.jit`` program at ``serving[:name]:bN[:sM]``: on the
  card one CUDA graph per device, captured under the process's capture
  lock — by :meth:`warmup` before traffic, or by the first batch that
  reaches it; ``compile_watch.site_stats("serving")`` is the
  fixed-program-set oracle. Rows are sliced back out per request as
  numpy arrays; the padding is exact.
- **Faults** — ``MXNET_FAULT_PLAN`` sites ``serve_admit`` (visited per
  admitted request) and ``serve_dispatch`` (visited per batcher pass).
- **Telemetry** — cumulative ``serving`` records every
  ``record_every`` batches and at :meth:`stop`, the live ``/metrics``
  families (``mxnet_serving_*``), the SLO watchdog's serving checks,
  and the shed/timeout/dispatch counters in ``profiler.counters()``.
- **Tracing** — every submit assigns a ``request_id``; with tracing on,
  each request's lifetime lands on its own track as nested spans:
  queue wait → batch formation → replica dispatch → pad → device
  compute → slice/respond.

An in-process callable takes the batched inputs as torch tensors on
the replica's device and returns a tensor (or a tuple of them; an
NDArray is unwrapped). A hybridized block called inside it runs its
plan inside the bucket's graph: its ops are captured there, its own
CachedOp captures nothing (a capture cannot nest in another).
"""
from __future__ import annotations

import itertools
import queue as _queue_mod
import threading
import time
from collections import deque

import numpy as _np
import torch

from .. import envs
from ..base import MXNetError
from .. import fault, profiler, telemetry, tracing
from ..bucketing.padding import pad_along
from .batcher import BucketLadder, pad_batch, slice_rows

__all__ = ["InferenceServer", "ServerOverloadedError",
           "RequestTimeoutError", "ServerClosedError",
           "validate_priority", "shed_lowest_locked"]


class ServerOverloadedError(MXNetError):
    """The bounded request queue is full — the request was shed (or
    preempted under KV-pool pressure). Retry with backoff, raise
    ``max_queue``, or add capacity."""


class RequestTimeoutError(MXNetError):
    """The request's deadline passed before it completed."""


class ServerClosedError(MXNetError):
    """The server was stopped; the request cannot be served."""


def validate_priority(priority, levels):
    """A priority class in ``0 .. levels-1`` (0 lowest). ``levels``
    comes from ``MXNET_SERVING_PRIORITIES``; a value outside the
    declared classes raises naming the knob."""
    p = int(priority)
    if not 0 <= p < levels:
        raise MXNetError(
            "priority %d outside 0..%d (MXNET_SERVING_PRIORITIES=%d; "
            "0 is lowest, %d highest)"
            % (p, levels - 1, levels, levels - 1))
    return p


def shed_lowest_locked(queue, priority):
    """Overload shedding with priority classes: pick (and REMOVE from
    ``queue``) the victim a ``priority``-class arrival displaces — the
    NEWEST member of the LOWEST class strictly below it. Returns None
    when nothing below it waits (the arrival itself sheds). The caller
    holds the queue's lock and fails the victim's future outside it."""
    victim = None
    for r in queue:                    # left-to-right = oldest-first
        p = getattr(r, "priority", 0) or 0
        if p >= priority:
            continue
        if victim is None or p <= (victim.priority or 0):
            victim = r                 # later match = newer
    if victim is not None:
        queue.remove(victim)
    return victim


def _unwrap(out):
    """A callable model's output as a tensor or a tuple of tensors."""
    if isinstance(out, (tuple, list)):
        return tuple(_unwrap(o) for o in out)
    return getattr(out, "_data", out)


def _host(out):
    """A program's output copied to host numpy (one sync a batch)."""
    if isinstance(out, tuple):
        return tuple(o.detach().cpu().numpy() for o in out)
    return out.detach().cpu().numpy()


class _Request:
    """One in-flight request: the per-sample input arrays, the
    server-assigned ``request_id`` (present on every shed/timeout log
    line so they join against traces), and a future-style completion
    event. ``_tr`` holds the trace-clock stamps of the request's
    lifecycle spans — None whenever tracing is off."""

    __slots__ = ("args", "t_submit", "deadline", "request_id",
                 "priority", "bucket", "batch", "row", "_tr",
                 "_event", "_value", "_error", "_t_done")

    def __init__(self, args, t_submit, deadline, request_id=None,
                 priority=0):
        self.args = args
        self.t_submit = t_submit
        self.deadline = deadline
        self.request_id = request_id
        self.priority = priority
        self.bucket = None        # the ladder bucket it was served in
        # the server's batch (its sequence number, from 1) and the row
        # in it: an answer that depends on its batch-mates (an int8
        # artifact quantizes its input over the whole batch) is
        # reproduced from the same batch
        self.batch = None
        self.row = None
        self._tr = None
        self._event = threading.Event()
        self._value = None
        self._error = None
        self._t_done = None

    @property
    def latency(self):
        """Seconds from submit to completion (None until served) —
        the same figure the server's latency percentiles aggregate."""
        if self._t_done is None:
            return None
        return self._t_done - self.t_submit

    def _fulfill(self, value):
        self._value = value
        self._t_done = time.monotonic()
        self._event.set()

    def _fail(self, exc):
        self._error = exc
        self._event.set()

    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        """Block for the response (row(s) of the batched program
        output, batch dim sliced off). Raises the request's error —
        RequestTimeoutError / ServerClosedError / the model's own."""
        if not self._event.wait(timeout):
            raise RequestTimeoutError(
                "request %s did not complete within %ss"
                % (self.request_id or "?", timeout))
        if self._error is not None:
            raise self._error
        return self._value


class InferenceServer:
    """Continuous-batching server over a deploy artifact (path or
    :class:`~mxnet_tpu_torch.deploy.Predictor`) or an in-process batched
    callable (``fn(*batched_tensors) -> batched_tensor(s)``, graph-safe
    on the card: no host reads of device values; requires ``ladder`` or
    ``max_batch``).

    ``seq_ladder=`` (callable models only) serves variable-length
    requests: samples may differ along ``seq_axis``, each batch holds
    requests of ONE sequence rung (a request always pads to its OWN
    smallest rung — its result can never depend on which batch-mates
    arrived concurrently), and the program cache stays bounded by the
    two ladders' product (``compile_watch.site_stats("serving")``
    oracle, the shared ``bucketing`` ladder contract). The
    model DOES see the deterministic per-rung zero padding: it must
    tolerate it (mask internally, or be padding-invariant for the
    outputs it reports); per-position outputs come back rung-length —
    callers slice to their own request's length."""

    def __init__(self, model, *, ladder=None, max_batch=None,
                 seq_ladder=None, seq_axis=0,
                 max_queue=64, batch_window_ms=2.0, replicas=1,
                 devices=None, default_deadline_ms=None,
                 record_every=None, name=None, start=True):
        from .. import compile_watch
        self._meta_inputs = None
        predictor = None
        if isinstance(model, str):
            from ..deploy import load_compiled
            predictor = load_compiled(model, device=(
                _device_name(devices[0]) if devices else None))
        elif hasattr(model, "batch_sizes") and hasattr(model, "program"):
            predictor = model
        elif not callable(model):
            raise MXNetError(
                "InferenceServer: model must be an artifact path, a "
                "deploy.Predictor, or a batched callable — got %r"
                % type(model).__name__)

        if predictor is not None:
            artifact_buckets = list(predictor.batch_sizes)
            if ladder is None:
                ladder = BucketLadder(artifact_buckets)
            else:
                ladder = ladder if isinstance(ladder, BucketLadder) \
                    else BucketLadder(ladder)
                missing = [b for b in ladder.buckets
                           if b not in artifact_buckets]
                if missing:
                    raise MXNetError(
                        "InferenceServer: ladder buckets %s are not in "
                        "the artifact (exported buckets: %s)"
                        % (missing, artifact_buckets))
            self._meta_inputs = (predictor.meta.get("inputs") or None)
        else:
            if ladder is None:
                if max_batch is None:
                    raise MXNetError(
                        "InferenceServer: a callable model needs "
                        "ladder= or max_batch=")
                ladder = BucketLadder.geometric(max_batch)
            elif not isinstance(ladder, BucketLadder):
                ladder = BucketLadder(ladder)
        self._ladder = ladder

        # variable-length requests: a second ladder over the samples'
        # sequence dimension (``seq_axis`` of the per-sample array).
        # Each (batch bucket, seq bucket) pair is one program — the
        # cache stays bounded by |ladder| x |seq_ladder| under any
        # request-length mix. In-process callables only: a deploy
        # artifact records ONE fixed per-sample shape per batch bucket.
        self._seq_axis = int(seq_axis)
        if seq_ladder is not None:
            if predictor is not None:
                raise MXNetError(
                    "InferenceServer: seq_ladder= needs an in-process "
                    "callable model — deploy artifacts record fixed "
                    "per-sample shapes (export one program per shape "
                    "instead)")
            if not isinstance(seq_ladder, BucketLadder):
                seq_ladder = BucketLadder(seq_ladder)
        self._seq_ladder = seq_ladder

        self.name = name
        site = "serving" if not name else "serving:%s" % name

        replicas = int(replicas)
        if devices is not None:
            devices = [torch.device(_device_name(d)) for d in devices]
            if len(devices) < replicas:
                raise MXNetError(
                    "InferenceServer: %d replicas need %d devices, "
                    "got %d" % (replicas, replicas, len(devices)))
        else:
            if predictor is not None and predictor.device.type != "cuda":
                avail = [predictor.device]
            elif torch.cuda.is_available():
                avail = [torch.device("cuda", i)
                         for i in range(torch.cuda.device_count())]
            else:
                from ..context import resolve_device
                avail = [resolve_device()]
            if replicas > len(avail):
                raise MXNetError(
                    "InferenceServer: %d replicas exceed the %d "
                    "available devices" % (replicas, len(avail)))
            devices = avail
        self._devices = [devices[i] for i in range(replicas)]
        self._replicas = replicas

        # one program per (bucket[, seq rung]) and distinct device: a
        # recompile inside one bucket site IS churn; distinct buckets
        # are distinct programs by construction (statics carry the
        # bucket). A device repeated in devices= shares its programs.
        self._programs = {}
        for dev in dict.fromkeys(str(d) for d in self._devices):
            for b in ladder.buckets:
                if predictor is not None:
                    fn = predictor.program(b, device=dev)
                else:
                    fn = (lambda *a, _f=model: _unwrap(_f(*a)))
                if seq_ladder is None:
                    self._programs[(dev, b)] = compile_watch.jit(
                        fn, "%s:b%d" % (site, b), statics=(site, b))
                else:
                    for s in seq_ladder.buckets:
                        self._programs[(dev, (b, s))] = \
                            compile_watch.jit(
                                fn, "%s:b%d:s%d" % (site, b, s),
                                statics=(site, b, s))

        self._max_queue = max(1, int(max_queue))
        # in-flight batches per replica: one running + one staged.
        # Bounding this is what closes the backpressure chain — when
        # every replica is saturated the batcher STOPS draining the
        # admission queue, so the queue (the only unbounded-wait spot)
        # fills to its bound and sheds, instead of requests waiting
        # unboundedly in an invisible dispatch buffer.
        self._max_outstanding = max(
            1, envs.get_int("MXNET_SERVING_MAX_OUTSTANDING"))
        self._window = max(0.0, float(batch_window_ms)) / 1e3
        self._default_deadline = (float(default_deadline_ms) / 1e3
                                  if default_deadline_ms is not None
                                  else None)
        self._record_every = int(record_every) if record_every \
            else envs.get_int("MXNET_SERVING_RECORD_EVERY")

        self._cond = threading.Condition()
        self._queue = deque()
        self._stats = {"requests": 0, "completed": 0, "shed": 0,
                       "timeouts": 0, "errors": 0, "dispatch_faults": 0,
                       "batches": 0, "occupancy_sum": 0.0,
                       "queue_peak": 0}
        self._levels = max(1, envs.get_int("MXNET_SERVING_PRIORITIES"))
        self._shed_by_priority = {}
        self._bucket_counts = {}
        self._replica_batches = [0] * replicas
        self._replica_service_s = [0.0] * replicas
        self._outstanding = [0] * replicas
        self._rid = itertools.count(1)
        self._latencies = deque(
            maxlen=max(1, envs.get_int("MXNET_SERVING_LATENCY_RING")))
        self._batches_since_record = 0
        self._n_inputs = len(self._meta_inputs) \
            if self._meta_inputs else None

        self._stopping = False
        self._drain = True
        self._closed = False
        self._started = False
        self._t0 = time.perf_counter()
        # depth is bounded UPSTREAM: the batcher only dispatches to
        # replica r while _outstanding[r] < _max_outstanding, so the
        # queue never holds more than max_outstanding batches (+ the
        # stop sentinel); a maxsize here could deadlock stop().
        self._work = [_queue_mod.Queue() for _ in range(replicas)]
        self._threads = []
        # the live /metrics endpoint scrapes every registered server;
        # MXNET_METRICS_PORT/MXNET_WATCHDOG arm the live stack even
        # for pure serving processes that never start a telemetry run
        from .. import livemetrics
        livemetrics.register_server(self)
        livemetrics.maybe_start()
        tracing.maybe_enable()
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        """Spawn the batcher + replica worker threads (idempotent;
        the constructor calls this unless ``start=False``)."""
        if self._started:
            return self
        if self._closed:
            raise ServerClosedError("InferenceServer already stopped")
        self._started = True
        self._t0 = time.perf_counter()
        t = threading.Thread(target=self._batch_loop,
                             name="mxnet-serving-batcher", daemon=True)
        t.start()
        self._threads.append(t)
        for i in range(self._replicas):
            t = threading.Thread(target=self._worker_loop, args=(i,),
                                 name="mxnet-serving-replica%d" % i,
                                 daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self, drain=True):
        """Stop the server. ``drain=True`` serves every queued request
        first; ``drain=False`` fails them with ServerClosedError.
        Emits a final ``serving`` telemetry record."""
        if self._closed:
            return
        with self._cond:
            self._stopping = True
            self._drain = drain
            self._cond.notify_all()
        for t in self._threads[:1]:        # the batcher drains first
            t.join()
        if not drain:
            with self._cond:
                leftovers = list(self._queue)
                self._queue.clear()
            for r in leftovers:
                r._fail(ServerClosedError("server stopped"))
        for q in self._work:
            q.put(None)
        for t in self._threads[1:]:
            t.join()
        self._closed = True
        self._emit_record()
        # off the /metrics scrape: a stopped server must not export
        # frozen gauges forever, and its label frees for a successor
        from .. import livemetrics
        livemetrics.deregister_server(self)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def warmup(self, *example):
        """Capture every bucket program on every replica device before
        taking traffic, so no live request ever pays a capture.
        Artifact-backed servers build zero samples from the meta;
        callable models need one ``example`` sample array per input.
        Returns the number of (bucket, device) programs readied (a
        repeated device counts once per replica, as in the JAX
        package). A CUDA graph cannot be written to disk, so a restart
        captures again; the device code the captures built is flushed
        to the persistent compile cache before this returns, when it
        is on."""
        if example:
            samples = [a.asnumpy() if hasattr(a, "asnumpy")
                       else _np.asarray(a) for a in example]
            samples = self._validate_sample(samples)
        elif self._meta_inputs and \
                all(i.get("shape") for i in self._meta_inputs):
            samples = [_np.zeros(
                tuple(int(s) for s in i["shape"][1:]),
                _np.dtype(i.get("dtype") or "float32"))
                for i in self._meta_inputs]
        else:
            raise MXNetError(
                "serving: warmup() on a callable model needs one "
                "example sample per input")
        n = 0
        seq_rungs = [None] if self._seq_ladder is None \
            else list(self._seq_ladder.buckets)
        for dev in self._devices:
            for b in self._ladder.buckets:
                for s_rung in seq_rungs:
                    warm = samples
                    key = b
                    if s_rung is not None:
                        # one zero sample per seq rung: truncate or
                        # pad the example's sequence axis to the rung
                        warm = []
                        for s in samples:
                            ax = self._seq_axis
                            sl = [slice(None)] * s.ndim
                            sl[ax] = slice(0, min(s.shape[ax], s_rung))
                            warm.append(pad_along(s[tuple(sl)], s_rung,
                                                 ax))
                        key = (b, s_rung)
                    with torch.inference_mode():
                        inputs = [_place(pad_batch([s], b), dev)
                                  for s in warm]
                        _host(self._programs[(str(dev), key)](*inputs))
                    n += 1
        from .. import compile_cache
        compile_cache.flush()
        return n

    # -- admission ---------------------------------------------------------
    def _validate_sample(self, arrays):
        """Per-sample validation against the artifact meta (a request
        carries ONE sample: the recorded shape minus the batch dim)."""
        if self._n_inputs is not None and len(arrays) != self._n_inputs:
            names = [i.get("name") for i in self._meta_inputs] \
                if self._meta_inputs else "?"
            raise MXNetError(
                "serving: model takes %d input(s) %s per request, got "
                "%d" % (self._n_inputs, names, len(arrays)))
        if self._n_inputs is None:
            self._n_inputs = len(arrays)
        if self._seq_ladder is not None:
            ax = self._seq_axis
            top = self._seq_ladder.max_batch
            for arr in arrays:
                if arr.ndim <= ax:
                    raise MXNetError(
                        "serving: seq_ladder expects samples with a "
                        "sequence axis %d; got shape %s"
                        % (ax, list(arr.shape)))
                if arr.shape[ax] > top:
                    raise MXNetError(
                        "serving: sample length %d exceeds the "
                        "seq ladder top %d" % (arr.shape[ax], top))
        if not self._meta_inputs:
            # float64 samples run as float32, the JAX package's default
            # (64-bit off)
            return [a.astype(_np.float32) if a.dtype == _np.float64
                    else a for a in arrays]
        from ..deploy import check_cast_dtype
        out = []
        for spec, arr in zip(self._meta_inputs, arrays):
            name = spec.get("name", "?")
            want = [int(s) for s in (spec.get("shape") or [])]
            if want and list(arr.shape) != want[1:]:
                raise MXNetError(
                    "serving: input %r sample shape %s does not match "
                    "the artifact's per-sample %s (a request is ONE "
                    "sample — no batch dim)"
                    % (name, list(arr.shape), want[1:]))
            out.append(check_cast_dtype(name, arr, spec.get("dtype"),
                                        who="serving"))
        return out

    def submit(self, *args, deadline_ms=None, block=False, priority=0):
        """Admit one request (one SAMPLE per input — no batch dim).
        Returns a future; ``.result(timeout)`` yields the response
        rows. ``priority`` (0 lowest .. ``MXNET_SERVING_PRIORITIES``-1
        highest) governs overload: a full queue sheds its newest
        LOWEST-class member below the arrival instead of the arrival
        itself, so the low class degrades first and the high class
        keeps its admission SLO. Sheds with
        :class:`ServerOverloadedError` (the message names the shed
        request's priority) when nothing below the arrival waits;
        ``block=True`` waits for space instead, up to the request's
        deadline."""
        if self._closed or not self._started:
            raise ServerClosedError("InferenceServer is not running")
        arrays = [a.asnumpy() if hasattr(a, "asnumpy")
                  else _np.asarray(a) for a in args]
        arrays = self._validate_sample(arrays)
        priority = validate_priority(priority, self._levels)
        fault.inject("serve_admit")
        if deadline_ms is None:
            deadline_s = self._default_deadline
        else:
            deadline_s = float(deadline_ms) / 1e3
        now = time.monotonic()
        # deadline 0 means "expire unless dispatchable now", not "no
        # deadline" — only None disables
        rid = "r%06d" % next(self._rid)
        req = _Request(arrays, now,
                       now + deadline_s if deadline_s is not None
                       else None, request_id=rid, priority=priority)
        if tracing._tracer is not None:
            req._tr = {"submit": tracing.now()}
        shed = stopping = False
        victim = None
        with self._cond:
            if self._stopping:
                stopping = True
            else:
                self._stats["requests"] += 1
                if len(self._queue) >= self._max_queue and block:
                    while len(self._queue) >= self._max_queue \
                            and not self._stopping:
                        if req.deadline is not None:
                            left = req.deadline - time.monotonic()
                            if left <= 0:
                                break
                            self._cond.wait(left)
                        else:
                            self._cond.wait(0.05)
                if self._stopping:
                    # stop() raced the blocking wait: this is a
                    # shutdown, not overload — don't count a shed or
                    # tell the caller to retry
                    self._stats["requests"] -= 1
                    stopping = True
                elif len(self._queue) >= self._max_queue:
                    # priority admission: displace the newest member
                    # of the lowest class below this arrival; shed
                    # the arrival itself only when nothing waits
                    # below it
                    victim = shed_lowest_locked(self._queue, priority)
                    self._stats["shed"] += 1
                    if victim is None:
                        self._note_shed_locked(priority)
                        shed = True
                    else:
                        self._note_shed_locked(victim.priority)
                        self._queue.append(req)
                        self._cond.notify_all()
                else:
                    # admit under the SAME lock hold as the bound
                    # check — the queue depth can never exceed the
                    # bound, even against racing submitters
                    self._queue.append(req)
                    depth = len(self._queue)
                    if depth > self._stats["queue_peak"]:
                        self._stats["queue_peak"] = depth
                    self._cond.notify_all()
        if stopping:
            raise ServerClosedError(
                "InferenceServer is stopping; request %s not admitted"
                % rid)
        if victim is not None:
            telemetry.note("serving_shed")
            profiler.increment_counter("serving_shed")
            if victim._tr is not None:
                tracing.instant("shed", "serving",
                                tid=tracing.track("serving"),
                                args={"request_id": victim.request_id})
            victim._fail(ServerOverloadedError(
                "serving: request %s (priority %d) shed for a "
                "priority-%d arrival — queue full (max_queue=%d); "
                "retry with backoff, raise max_queue, or add replicas"
                % (victim.request_id, victim.priority, priority,
                   self._max_queue)))
        if shed:
            telemetry.note("serving_shed")
            profiler.increment_counter("serving_shed")
            if req._tr is not None:
                tracing.instant("shed", "serving",
                                tid=tracing.track("serving"),
                                args={"request_id": rid})
            raise ServerOverloadedError(
                "serving: request %s (priority %d) shed — queue full "
                "(max_queue=%d); retry with backoff, raise max_queue, "
                "or add replicas"
                % (rid, priority, self._max_queue))
        return req

    def _note_shed_locked(self, priority):
        self._shed_by_priority[priority] = \
            self._shed_by_priority.get(priority, 0) + 1

    def predict(self, *args, timeout=None, deadline_ms=None):
        """Synchronous convenience: submit + result."""
        return self.submit(*args, deadline_ms=deadline_ms) \
            .result(timeout=timeout)

    # -- batching ----------------------------------------------------------
    def _batch_loop(self):
        max_b = self._ladder.max_batch
        while True:
            with self._cond:
                while not self._queue and not self._stopping:
                    self._cond.wait(0.05)
                if self._stopping and (not self._queue
                                       or not self._drain):
                    break
                if self._window > 0 and len(self._queue) < max_b \
                        and not self._stopping:
                    # straggler window: let concurrent submitters
                    # coalesce into one fuller (cheaper) batch
                    self._cond.wait(self._window)
            try:
                fault.inject("serve_dispatch")
            except fault.InjectedFault:
                # a planned raise/hang at the dispatch site: count it
                # and keep serving — queued requests age meanwhile,
                # which is exactly how deadline tests drive the
                # timeout path deterministically
                with self._cond:
                    self._stats["dispatch_faults"] += 1
                continue
            # reserve a replica slot BEFORE popping requests: while
            # every replica is at its outstanding cap the requests
            # stay in the bounded admission queue (filling it, aging
            # toward their deadlines, shedding new arrivals) instead
            # of piling into an unbounded dispatch buffer
            r = None
            with self._cond:
                while not (self._stopping and not self._drain):
                    free = [i for i in range(self._replicas)
                            if self._outstanding[i]
                            < self._max_outstanding]
                    if free:
                        # least-outstanding replica wins the batch
                        r = min(free,
                                key=lambda i: self._outstanding[i])
                        self._outstanding[r] += 1
                        break
                    self._cond.wait(0.05)
            if r is None:
                break
            now = time.monotonic()
            batch, expired, leftover = [], [], []
            srung = None
            with self._cond:
                while self._queue and len(batch) < max_b:
                    req = self._queue.popleft()
                    if req.deadline is not None and now > req.deadline:
                        expired.append(req)
                        continue
                    if self._seq_ladder is not None:
                        # one batch = ONE sequence rung, the first
                        # request's own: a request's padding depends
                        # only on itself, never on which batch-mates
                        # happened to arrive concurrently — the
                        # row-independence contract for models that
                        # see (and must mask or tolerate) the pad
                        rung = self._req_rung(req)
                        if srung is None:
                            srung = rung
                        elif rung != srung:
                            leftover.append(req)
                            continue
                    if req._tr is not None:
                        # the queue-wait span ends here: this request
                        # just joined a forming batch
                        req._tr["pop"] = tracing.now()
                    batch.append(req)
                if leftover:
                    # preserve FIFO for the rungs left behind
                    self._queue.extendleft(reversed(leftover))
                if expired:
                    self._stats["timeouts"] += len(expired)
                if not batch:
                    self._outstanding[r] -= 1   # nothing to dispatch
                self._cond.notify_all()     # space for blocked submits
            for req in expired:
                telemetry.note("serving_timeout")
                profiler.increment_counter("serving_timeouts")
                if req._tr is not None:
                    tid = tracing.track("req %s" % req.request_id)
                    t_end = tracing.now()
                    tracing.add("queue", "serving", req._tr["submit"],
                                t_end - req._tr["submit"], tid=tid,
                                args={"request_id": req.request_id})
                    tracing.instant("timeout", "serving", tid=tid,
                                    args={"request_id": req.request_id})
                req._fail(RequestTimeoutError(
                    "request %s deadline passed after %.1f ms in "
                    "queue (deadline %.1f ms)"
                    % (req.request_id, (now - req.t_submit) * 1e3,
                       (req.deadline - req.t_submit) * 1e3)))
            if not batch:
                continue
            bucket = self._ladder.bucket_for(len(batch))
            profiler.increment_counter("serving_dispatches")
            t_put = tracing.now() if tracing._tracer is not None \
                else None
            self._work[r].put((batch, bucket, srung, t_put))

    def _req_rung(self, req):
        """One request's own sequence rung: the smallest bucket
        fitting its longest input (every input pads along seq_axis to
        the shared rung; all lengths validated <= top at admit)."""
        lmax = max(a.shape[self._seq_axis] for a in req.args)
        return self._seq_ladder.bucket_for(lmax)

    # -- replicas ----------------------------------------------------------
    def _worker_loop(self, idx):
        # grad mode is thread-local: this thread serves in inference
        # mode, so no served output carries an autograd graph
        with torch.inference_mode():
            self._serve(idx)

    def _serve(self, idx):
        dev = self._devices[idx]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        while True:
            item = self._work[idx].get()
            if item is None:
                break
            batch, bucket, srung, t_put = item
            pkey = bucket if srung is None else (bucket, srung)
            t_get = time.perf_counter()
            try:
                t_pad0 = t_get
                inputs = []
                for j in range(len(batch[0].args)):
                    samples = [r.args[j] for r in batch]
                    if srung is not None:
                        samples = [pad_along(s, srung, self._seq_axis)
                                   for s in samples]
                    inputs.append(_place(pad_batch(samples, bucket),
                                         dev))
                t_compute0 = time.perf_counter()
                out = _host(self._programs[(str(dev), pkey)](*inputs))
            except Exception as exc:        # noqa: BLE001 — model errors
                with self._cond:            # belong to the requests
                    self._stats["errors"] += len(batch)
                    self._outstanding[idx] -= 1
                    self._cond.notify_all()
                for r in batch:
                    if r._tr is not None:
                        tracing.instant(
                            "error", "serving",
                            tid=tracing.track("req %s" % r.request_id),
                            args={"request_id": r.request_id,
                                  "error": type(exc).__name__})
                    r._fail(exc)
                continue
            t_compute1 = time.perf_counter()
            done = time.monotonic()
            values = [slice_rows(out, i) for i in range(len(batch))]
            # account BEFORE fulfilling: the instant a future's event
            # sets, the client may call stats() (or scrape /metrics)
            # and must see this batch's completions — fulfilling first
            # would make the counters trail the observable results
            with self._cond:
                n = len(batch)
                self._stats["completed"] += n
                self._stats["batches"] += 1
                seq = self._stats["batches"]
                self._stats["occupancy_sum"] += n / float(bucket)
                self._replica_service_s[idx] += \
                    time.perf_counter() - t_get
                ckey = str(bucket) if srung is None \
                    else "%dx%d" % (bucket, srung)
                self._bucket_counts[ckey] = \
                    self._bucket_counts.get(ckey, 0) + 1
                self._replica_batches[idx] += 1
                self._outstanding[idx] -= 1
                self._cond.notify_all()     # wake the slot-reserving
                for r in batch:             # batcher promptly
                    self._latencies.append(done - r.t_submit)
                self._batches_since_record += 1
                emit = self._batches_since_record >= self._record_every
                if emit:
                    self._batches_since_record = 0
            respond_ends = []
            for row, (r, value) in enumerate(zip(batch, values)):
                r.bucket, r.batch, r.row = bucket, seq, row
                r._fulfill(value)
                respond_ends.append(time.perf_counter())
            if t_put is not None:
                self._trace_batch(batch, bucket, srung, idx, t_put,
                                  t_get, t_pad0, t_compute0,
                                  t_compute1, respond_ends)
            if emit:
                self._emit_record()

    def _trace_batch(self, batch, bucket, srung, replica, t_put, t_get,
                     t_pad0, t_compute0, t_compute1, respond_ends):
        """Emit one batch's causally-nested per-request trace spans:
        each request gets its own named track holding a ``request``
        parent span with queue → batch → dispatch → pad → compute →
        respond children, consecutive and non-overlapping by
        construction (each phase starts where the previous ended).
        Batch-shared phases (pad/compute) repeat on every member's
        track — that duplication is what makes a single request's
        lifetime readable in isolation in Perfetto."""
        base = {"bucket": bucket, "replica": replica,
                "batch_size": len(batch)}
        if srung is not None:
            base["seq_rung"] = srung
        for i, r in enumerate(batch):
            tr = r._tr
            if tr is None:
                continue         # admitted before tracing was enabled
            tid = tracing.track("req %s" % r.request_id)
            args = dict(base, request_id=r.request_id)
            sub = tr["submit"]
            pop = tr.get("pop", t_put)
            r0 = t_compute1 if i == 0 else respond_ends[i - 1]
            r1 = respond_ends[i]
            tracing.add("request", "serving", sub, r1 - sub, tid=tid,
                        args=args)
            tracing.add("queue", "serving", sub, pop - sub, tid=tid,
                        args=args)
            tracing.add("batch", "serving", pop, t_put - pop, tid=tid,
                        args=args)
            tracing.add("dispatch", "serving", t_put, t_get - t_put,
                        tid=tid, args=args)
            tracing.add("pad", "serving", t_pad0, t_compute0 - t_pad0,
                        tid=tid, args=args)
            tracing.add("compute", "serving", t_compute0,
                        t_compute1 - t_compute0, tid=tid, args=args)
            tracing.add("respond", "serving", r0, r1 - r0, tid=tid,
                        args=args)

    # -- stats & telemetry -------------------------------------------------
    def stats(self):
        """Cumulative serving stats snapshot: request counts
        (completed/shed/timeout/errors), latency percentiles,
        requests/sec, mean batch occupancy, queue depth (now/peak/
        bound), per-bucket batch counts, per-replica batch counts."""
        elapsed = max(time.perf_counter() - self._t0, 1e-9)
        with self._cond:
            s = dict(self._stats)
            lats = [v * 1e3 for v in self._latencies]
            from ..bucketing.ladder import bucket_sort_key
            buckets = dict(sorted(self._bucket_counts.items(),
                                  key=lambda kv: bucket_sort_key(kv[0])))
            depth = len(self._queue)
            replica_batches = list(self._replica_batches)
            replica_service = list(self._replica_service_s)
            shed_pri = dict(self._shed_by_priority)
        out = {
            # the /metrics registration dedups this label per process
            # — stats consumers (the watchdog's per-server baselines)
            # must key by the same identity, or two unnamed servers
            # would interleave one counter stream
            "name": getattr(self, "_metrics_label", None)
            or self.name or "default",
            "requests": s["requests"],
            "completed": s["completed"],
            "shed": s["shed"],
            "timeouts": s["timeouts"],
            "errors": s["errors"],
            "dispatch_faults": s["dispatch_faults"],
            "batches": s["batches"],
            "occupancy": round(s["occupancy_sum"] / s["batches"], 4)
            if s["batches"] else None,
            "queue_depth": depth,
            "queue_peak": s["queue_peak"],
            "max_queue": self._max_queue,
            "rps": round(s["completed"] / elapsed, 3),
            "ladder": list(self._ladder.buckets),
            "buckets": buckets,
            "replicas": self._replicas,
            "replica_batches": replica_batches,
            # mean batch service time per replica — the straggler
            # signal the SLO watchdog's skew check reads
            "replica_service_ms": [
                round(1e3 * s / b, 3) if b else None
                for s, b in zip(replica_service, replica_batches)],
        }
        if lats:
            out["latency_ms"] = {
                "mean": round(sum(lats) / len(lats), 3),
                "p50": round(telemetry.percentile(lats, 50), 3),
                "p90": round(telemetry.percentile(lats, 90), 3),
                "p99": round(telemetry.percentile(lats, 99), 3),
                "max": round(max(lats), 3),
            }
        if shed_pri:
            # per-priority shed counts — present only once priorities
            # actually shed, so priority-free runs keep the historical
            # record shape (and sink bytes) exactly
            out["shed_by_priority"] = {str(k): v for k, v
                                       in sorted(shed_pri.items())}
        return out

    def latency_snapshot(self):
        """The recent fulfilled-request latencies (seconds) — the
        /metrics endpoint's histogram source."""
        with self._cond:
            return list(self._latencies)

    def _emit_record(self):
        telemetry.serving_event(self.stats())


def _device_name(d):
    """A device given as a torch.device, a string or a Context."""
    if hasattr(d, "torch_device"):
        return d.torch_device()
    return d


def _place(arr, dev):
    """One padded host batch on the replica's device."""
    t = torch.from_numpy(_np.ascontiguousarray(arr))
    return t.to(dev) if dev.type != "cpu" else t
