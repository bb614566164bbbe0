"""Unified run telemetry: step timeline, goodput, memory, serving
records — one schema, one sink (counterpart of
``mxnet_tpu/telemetry.py``).

- **Per-step timeline** — :func:`span` phases (``sync``,
  ``optimizer``, ...) accumulate into the open step record and layer
  onto the profiler's aggregate table (and its chrome trace while the
  profiler runs). Phases are exclusive: under nesting the OUTERMOST
  span owns the wall time, and only spans on the accounting thread (the
  one driving steps) count, so phase totals never sum past the wall
  clock. The Gluon Trainer ticks one step per ``step``/``update``.
- **Throughput & goodput** — steps land in a ring buffer
  (``MXNET_TELEMETRY_RING``) for step-time percentiles; productive vs.
  skipped/retried accounting reconciles with ``fault.stats()``
  (:func:`note` counts each branch point) in :func:`report`.
- **Device memory watermarks** — ``torch.cuda.memory_stats(d)``
  (``allocated_bytes.all.current`` / ``.peak``) of every visible card,
  sampled every ``MXNET_TELEMETRY_MEM_INTERVAL`` steps and at
  :func:`stop`. A CUDA graph's private memory pool shows in reserved
  memory, not in allocated memory. Without a card no ``memory`` record
  is written: the JAX package's host live-buffer fallback
  (``MXNET_TELEMETRY_LIVE_BUFFERS``) has no torch counterpart. The
  rank-mesh trainer adds its per-rank split (:func:`memory_breakdown`:
  sharded and replicated parameters, optimizer state).
- **Serving records** — cumulative ``serving`` records from each
  ``serving.InferenceServer`` (the summary's ``serving`` block: the
  latest), ``decode`` and ``prefix_cache`` records from each
  ``serving.DecodeServer``, ``router`` records from
  each ``serving.Router``, ``usage`` records from the meter
  (``metering``), and ``alert`` records (a confirmed replica loss, an
  SLO-watchdog breach) that also trigger the flight recorder.
- **Bucketing records** — cumulative ``bucketing`` records from each
  shape-bucketing producer (``bucketing.BucketingStats``).
- **Comms ledger** — the input pipeline's host-to-device copies
  (:func:`h2d`), the kvstore's pushes and pulls and the bucketed
  exchange (:func:`comm_span`), the rank mesh's collectives (kind
  ``collective``, keyed by the collective's name), and the per-link split
  (:func:`comm_links`): calls, bytes and milliseconds per
  ``kind:key`` in the summary's ``comms`` (present once a transfer was
  accounted).

Everything flows to a structured JSONL sink (``MXNET_TELEMETRY_FILE``)
and to the :func:`report` summary dict; ``python -m
mxnet_tpu_torch.tools.diagnose <file>.jsonl`` renders it. The sink is
created atomically (``<file>.tmp`` + ``os.replace``) and later flushes
append only the records accrued since the previous flush; a crash can
strand at most one trailing partial line, which the diagnose reader
skips.

Always cheap when off: with no active run every hook is one module
lookup + None check and :func:`span` returns a shared no-op context
manager. A run starts explicitly (:func:`start`) or from the
environment (``MXNET_TELEMETRY=1`` or ``MXNET_TELEMETRY_FILE`` set) on
the next Gluon ``Trainer.step`` (:func:`maybe_start`). :func:`start`
also arms the tracer (``MXNET_TRACE``), the flight recorder
(``MXNET_FLIGHTREC_DIR``), the ``/metrics`` endpoint
(``MXNET_METRICS_PORT``) and the SLO watchdog (``MXNET_WATCHDOG``).

JSONL record types: ``run_start``, ``step``, ``memory``,
``memory_breakdown``, ``summary``, ``serving``, ``decode``,
``prefix_cache``, ``router``, ``bucketing``, ``usage`` and ``alert``,
and, only while the compile watch is on (:mod:`~mxnet_tpu_torch.
compile_watch`), ``compile`` and ``utilization`` (with the summary's
``compile``/``utilization`` blocks);
a subsystem that never runs writes none of its kinds, so the sink is
byte-identical to a run without it. The JAX package's other kinds
arrive with the modules that emit them (``ROADMAP.md`` queue A).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from . import tracing
from . import envs

__all__ = ["PHASES", "enabled", "start", "stop", "reset", "maybe_start",
           "step_begin", "step_end", "step_tick", "span", "note",
           "recent_rate", "sample_memory", "flush", "report",
           "quick_stats", "percentile", "external_record",
           "checkpoint_event", "serving_event", "decode_event",
           "router_event", "prefix_cache_event",
           "bucketing_event", "alert_event", "usage_event", "comm",
           "comm_span", "comm_links", "h2d", "memory_breakdown"]

# the phases a training step record splits its time into
PHASES = ("data_wait", "compute", "optimizer", "sync", "checkpoint",
          "eval")

_lock = threading.Lock()
_run = None          # the active _Run
_last_run = None     # most recently stopped run (report() after fit)
_env_cfg = None      # cached (enabled, filename) from the environment
# per-step utilization hooks, installed by compile_watch.enable():
# _util_probe is called at each step boundary (under _lock — it must
# not call back in) with (step_seq, dur_s) and returns the extra fields
# of a ``utilization`` record, or None; _util_reset is called at
# step_begin so pre-step backlog never inflates the first step's MFU.
# One global None check each when the watch is off.
_util_probe = None
_util_reset = None
# SLO-watchdog hooks, installed by livemetrics.enable_watchdog():
# _watch_step receives each closed step record, _watch_serving each
# cumulative serving snapshot — both called OUTSIDE the module lock.
# One global None check each when the watchdog is off.
_watch_step = None
_watch_serving = None
# flight-recorder hooks, installed by flightrec.enable(): _recent is
# the recorder's own bounded deque shadowing every record the run
# appends (records leave run.records at flush, so a post-mortem needs
# its own tail); _flight_alert receives each alert's fields at the
# alert edge. One global None check each when the recorder is off.
_recent = None
_flight_alert = None


def _remember(rec):
    """Shadow one record into the flight recorder's bounded ring.
    One None check when no recorder is armed; deque appends are
    thread-safe, so callers may hold the lock or not."""
    r = _recent
    if r is not None:
        r.append(rec)


class _Run:
    """One training run's accumulators. All mutation under the module
    lock; reads for report() snapshot under the same lock."""

    def __init__(self, filename, run_id, meta):
        self.run_id = run_id or "run-%d-%d" % (os.getpid(),
                                               int(time.time()))
        self.filename = filename
        self.t0_wall = time.time()
        self.records = [{"type": "run_start", "run_id": self.run_id,
                         "time": self.t0_wall, "pid": os.getpid(),
                         "meta": dict(meta or {})}]
        self.ring = deque(
            maxlen=max(1, envs.get_int("MXNET_TELEMETRY_RING")))
        self.steps = 0
        self.samples = 0
        self.total_step_s = 0.0
        self.phase_totals = {}       # phase -> seconds (whole run)
        self.open_phases = set()     # same-phase reentrancy guard
        self.pending_phases = {}     # phase -> seconds since boundary
        self.serving = None          # latest cumulative serving stats
        self.decode = None           # per-server cumulative decode
                                     # (autoregressive serving) stats
        self.router = None           # per-router cumulative fleet
                                     # (dispatch/failover) stats
        self.prefix = None           # per-server cumulative KV
                                     # prefix-cache (page sharing) stats
        self.bucketing = None        # per-producer cumulative bucketing
                                     # (pads, discards, per-bucket) stats
        self.ckpt = None             # checkpoint-save aggregates (lazy)
        self.usage = None            # per-meter cumulative usage
                                     # (tenant cost-attribution) stats
        self.alerts = None           # SLO-watchdog alert list (lazy,
        self.alerts_dropped = 0      # bounded to _MAX_ALERTS)
        self.fault_counters = {"skipped_steps": 0, "retries": 0,
                               "timeouts": 0}
        self.extra_counters = {}     # free-form note() names
        self.comms = {}              # (kind, key) -> calls/bytes/time_ms
        self.mem_watermarks = {}     # device -> peak/last bytes
        self.mem_breakdown = None    # params_sharded/... split (lazy)
        self.fault_base = None       # fault.stats() at start
        self.counters_base = {}      # profiler.counters() at start
        self.cw_base = None          # compile_watch compile baseline
        self._step_t0 = None         # perf_counter at step_begin
        self._last_boundary = None   # perf_counter at last step end
        # spans only count on the accounting thread (the one driving
        # steps): a run-global phase guard must not let a background
        # thread suppress the training thread's real span
        self._thread = threading.get_ident()
        self._step_fault_base = dict(self.fault_counters)
        self._steps_since_flush = 0
        self._steps_since_mem = 0
        self._mem_interval = envs.get_int("MXNET_TELEMETRY_MEM_INTERVAL")
        self._flush_steps = max(
            1, envs.get_int("MXNET_TELEMETRY_FLUSH_STEPS"))
        self._sink_created = False
        self._flush_lock = threading.Lock()   # serializes sink writers
        # sink-less runs cap the in-memory record list; flushed records
        # of sink-backed runs leave memory at each flush
        self._max_records = max(
            1, envs.get_int("MXNET_TELEMETRY_MAX_RECORDS"))
        self.records_dropped = 0


class _NullSpan:
    """Shared no-op context manager — the whole cost of a span when
    telemetry is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL = _NullSpan()


# ---------------------------------------------------------------------------
# run lifecycle
# ---------------------------------------------------------------------------

def enabled():
    """True while a run is active."""
    return _run is not None


def _env():
    """(enabled, filename) from MXNET_TELEMETRY / MXNET_TELEMETRY_FILE,
    parsed once; reset() re-reads."""
    global _env_cfg
    if _env_cfg is None:
        on = envs.get_bool("MXNET_TELEMETRY")
        fname = envs.get_path("MXNET_TELEMETRY_FILE") or None
        _env_cfg = (on or fname is not None, fname)
    return _env_cfg


def start(filename=None, run_id=None, meta=None):
    """Begin a telemetry run. ``filename`` (or MXNET_TELEMETRY_FILE)
    names the JSONL sink; None keeps the run in memory only. Returns
    the run_id. A second start() while a run is active is a no-op
    returning the active run's id. An atexit stop() is registered so a
    run whose loop has no natural end (a bare gluon loop that never
    calls stop()) still gets its final flush + summary record."""
    global _run, _atexit_registered
    # the baseline first, outside the lock (fault takes its own lock;
    # a loser's snapshot is simply discarded below)
    from . import compile_watch, fault, profiler
    fault_base = fault.stats()
    counters_base = profiler.counters()
    compile_watch.maybe_enable()   # MXNET_COMPILE_WATCH rides the run
    compile_watch.run_reset()      # utilization is scoped to THIS run
    tracing.maybe_enable()         # MXNET_TRACE rides the run
    from . import flightrec
    flightrec.maybe_enable()       # MXNET_FLIGHTREC_DIR rides the run
    from . import livemetrics
    # MXNET_METRICS_PORT / MXNET_WATCHDOG; a new run gets a FRESH
    # watchdog so the drift baseline never spans workloads
    livemetrics.maybe_start(fresh_run=True)
    cw = compile_watch.stats()
    cw_base = {"count": cw["compiles"],
               "total_s": cw["compile_total_s"]} if cw else None
    with _lock:
        if _run is not None:
            return _run.run_id     # racer lost: report the winner's id
        if filename is None:
            filename = _env()[1]
        run = _Run(_per_worker_filename(filename), run_id, meta)
        run.fault_base = fault_base
        run.counters_base = counters_base
        run.cw_base = cw_base
        _run = run
    if not _atexit_registered:
        _atexit_registered = True
        import atexit
        atexit.register(stop)      # no-op when already stopped
    # a supervised relaunch stamps its restart generation into every
    # worker's env; recording it as a run event lets diagnose show the
    # fleet's restart timeline
    gen = envs.get_int("MXNET_LAUNCH_RESTART")
    if gen:
        note("supervisor_restart_generation", int(gen))
    return run.run_id


def _per_worker_filename(filename):
    """In a launcher-spawned multi-worker job (the DMLC_* env
    contract) every worker would otherwise race on ONE sink path —
    concurrent creates clobber each other and interleaved appends
    merge two runs. Give each non-zero worker its own file."""
    if not filename:
        return filename
    worker = os.environ.get("DMLC_WORKER_ID")
    if not worker or worker == "0" or \
            os.environ.get("DMLC_NUM_WORKER", "1") in ("", "1"):
        return filename
    base, ext = os.path.splitext(filename)
    return "%s.worker%s%s" % (base, worker, ext)


_atexit_registered = False


def maybe_start(meta=None):
    """Training-loop entry hook (the Gluon Trainer calls it at every
    ``step``/``update``): start a run when the environment asks
    for one (MXNET_TELEMETRY=1 or MXNET_TELEMETRY_FILE set) and none is
    active. Returns True only when THIS call started the run — the
    caller then owns stop() (loops with no natural end rely on the
    atexit stop that start() registers)."""
    if _run is not None:
        return False
    on, fname = _env()
    if not on:
        return False
    start(filename=fname, meta=meta)
    return True


def stop():
    """End the run: close any open step, append the ``summary`` record,
    flush the JSONL sink, and keep the run readable via report().
    Returns the summary dict (None when no run was active)."""
    global _run, _last_run
    run = _run
    if run is None:
        return None
    now = time.perf_counter()
    with _lock:
        if run._step_t0 is not None:
            _close_step_locked(run, now, None)
    # a final sample guarantees every run carries memory watermarks,
    # even short ones that never hit the periodic interval
    _sample_memory(run)
    summary = report()
    with _lock:
        run.records.append(dict(summary, type="summary"))
        _remember({"type": "summary", "run_id": run.run_id})
        _last_run = run
        _run = None
    _flush_run(run)
    return summary


def reset():
    """Forget the active and last runs and the cached env config.
    Tests that monkeypatch MXNET_TELEMETRY* call this."""
    global _run, _last_run, _env_cfg
    with _lock:
        _run = None
        _last_run = None
        _env_cfg = None


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def _close_step_locked(run, now, samples):
    """Finalize one step record; caller holds the lock. In tick mode
    (no step_begin) the step spans from the previous boundary — the
    first tick only sets the baseline."""
    t0 = run._step_t0
    if t0 is None:
        if run._last_boundary is None:
            run._last_boundary = now
            run.pending_phases = {}
            run._step_fault_base = dict(run.fault_counters)
            return None
        t0 = run._last_boundary
    dur = max(now - t0, 0.0)
    run._step_t0 = None
    run._last_boundary = now
    run.steps += 1
    run.total_step_s += dur
    rec = {"type": "step", "seq": run.steps,
           "t": round(time.time() - run.t0_wall, 6),
           "dur_ms": round(dur * 1e3, 6)}
    if run.pending_phases:
        rec["phases_ms"] = {k: round(v * 1e3, 6)
                            for k, v in run.pending_phases.items()}
    if samples:
        rec["samples"] = int(samples)
        run.samples += int(samples)
    skipped = run.fault_counters["skipped_steps"] \
        - run._step_fault_base["skipped_steps"]
    retries = run.fault_counters["retries"] \
        - run._step_fault_base["retries"]
    if skipped:
        rec["skipped"] = skipped
    if retries:
        rec["retries"] = retries
    run.pending_phases = {}
    run._step_fault_base = dict(run.fault_counters)
    run.ring.append(rec)
    run.records.append(rec)
    _remember(rec)
    if tracing._tracer is not None:
        # the step's own trace span on the accounting thread's track;
        # phase spans recorded by _Span nest inside it by containment
        tracing.add("step", "step", now - dur, dur, tid=run._thread,
                    args={"seq": run.steps})
    probe = _util_probe
    if probe is not None:
        util = probe(run.steps, dur)
        if util:
            urec = {"type": "utilization", "seq": run.steps,
                    "t": rec["t"], "dur_ms": rec["dur_ms"]}
            urec.update(util)
            run.records.append(urec)
            _remember(urec)
    _cap_records_locked(run)
    run._steps_since_flush += 1
    run._steps_since_mem += 1
    return rec


def _cap_records_locked(run):
    """Bound a memory-only run's record list (the ring and the
    accumulators keep the summary exact; only raw records drop).
    Drop a 10% block, not one element — a per-record front-shift of a
    100k list under the lock would cost O(cap) every record. Caller
    holds the lock. Sink-backed runs flush instead."""
    if run.filename or len(run.records) <= run._max_records:
        return
    drop = max(len(run.records) - run._max_records,
               run._max_records // 10)
    drop = min(drop, len(run.records) - 1)       # keep run_start
    del run.records[1:1 + drop]
    run.records_dropped += drop


def step_begin():
    """Open a step (closing any still-open one). The fit loop calls
    this at the top of each batch."""
    run = _run
    if run is None:
        return
    now = time.perf_counter()
    resetf = _util_reset
    with _lock:
        if run._step_t0 is not None:
            # a still-open step: close it FIRST so the utilization
            # probe drains its accumulators into its record
            _close_step_locked(run, now, None)
        elif resetf is not None:
            # no step was open: anything accrued since the last
            # boundary is pre-step backlog, not this step's work
            resetf()
        run._step_t0 = now
        run._thread = threading.get_ident()
        run.pending_phases = {}
        run._step_fault_base = dict(run.fault_counters)


def step_end(samples=None):
    """Close the open step, or — with no step_begin (gluon Trainer
    tick mode) — record a step spanning from the previous boundary.
    Returns the step record (None when telemetry is off or this tick
    only set the baseline)."""
    run = _run
    if run is None:
        return None
    now = time.perf_counter()
    with _lock:
        run._thread = threading.get_ident()   # tick mode: the ticking
        rec = _close_step_locked(run, now, samples)   # thread accounts
    hook = _watch_step
    if hook is not None and rec is not None:
        hook(rec)                  # SLO watchdog — outside the lock
    _after_step(run)
    return rec


# gluon Trainer's per-step boundary: identical semantics, honest name
step_tick = step_end


def _after_step(run):
    """Post-boundary work that must not hold the lock: periodic memory
    sampling and JSONL flush."""
    if run._mem_interval > 0 and run._steps_since_mem >= run._mem_interval:
        run._steps_since_mem = 0
        _sample_memory(run)
    if run.filename and run._steps_since_flush >= run._flush_steps:
        run._steps_since_flush = 0
        _flush_run(run)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

class _Span:
    __slots__ = ("run", "phase", "t0", "active")

    def __init__(self, run, phase):
        self.run = run
        self.phase = phase

    def __enter__(self):
        run = self.run
        with _lock:
            if threading.get_ident() != run._thread:
                # off the accounting thread: background work is not a
                # step stall — no-op
                self.active = False
            elif run.open_phases:
                # phases are EXCLUSIVE: the outermost span owns the
                # wall time, so phase totals can never sum past the
                # run's wall clock
                self.active = False
            else:
                run.open_phases.add(self.phase)
                self.active = True
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        if tracing._tracer is not None:
            # the trace records EVERY span — including the nested and
            # off-accounting-thread ones the exclusive-phase accounting
            # (rightly) ignores: nesting shows up as time containment
            # on the emitting thread's own track. steps + 1 = the step
            # this span will close under, in begin/end AND tick mode
            tracing.add(self.phase, "phase", self.t0,
                        time.perf_counter() - self.t0,
                        args={"step": self.run.steps + 1})
        if not self.active:
            return False
        dur = time.perf_counter() - self.t0
        run = self.run
        with _lock:
            run.open_phases.discard(self.phase)
            run.pending_phases[self.phase] = \
                run.pending_phases.get(self.phase, 0.0) + dur
            run.phase_totals[self.phase] = \
                run.phase_totals.get(self.phase, 0.0) + dur
        # layer onto the existing profiler: always in the aggregate
        # table, and as a trace event while the profiler runs
        from . import profiler
        dur_us = dur * 1e6
        profiler._aggregate("telemetry.%s" % self.phase, dur_us)
        if profiler._state["running"]:
            profiler._emit("telemetry.%s" % self.phase, "telemetry", "X",
                           ts=profiler._now_us() - int(dur_us),
                           dur=int(dur_us))
        return False


def span(phase):
    """A context manager timing one phase of the current step. No-op
    singleton when telemetry is off. Phases are exclusive — under
    nesting, only the outermost span counts — and only the accounting
    thread's spans count at all."""
    run = _run
    if run is None:
        return _NULL
    return _Span(run, phase)


# ---------------------------------------------------------------------------
# fault/goodput unification
# ---------------------------------------------------------------------------

def comm(kind, key, nbytes=0, seconds=0.0):
    """Account one transfer: calls, bytes and milliseconds per
    ``(kind, key)`` in the run's comms ledger (the summary's ``comms``,
    keyed ``kind:key``). No-op without a run. Kinds: ``h2d`` (the input
    placer), ``push``/``pull`` (the kvstore, per key) and ``grad_sync``
    (the bucketed exchange, per bucket); the per-link split lands under
    ``ici``/``dcn`` (:func:`comm_links`)."""
    run = _run
    if run is None:
        return
    k = (str(kind), str(key))
    with _lock:
        c = run.comms.get(k)
        if c is None:
            c = run.comms[k] = {"calls": 0, "bytes": 0, "time_ms": 0.0}
        c["calls"] += 1
        c["bytes"] += int(nbytes)
        c["time_ms"] += seconds * 1e3


def _nbytes(value):
    """Payload size of an NDArray, a tensor, a sparse NDArray (its values
    and indices) or a list of them."""
    if value is None:
        return 0
    if isinstance(value, (list, tuple)):
        return sum(_nbytes(v) for v in value)
    sp = getattr(value, "_sp_data", None)
    if sp is not None:
        return _nbytes(sp) + _nbytes(getattr(value, "_sp_indices", None))
    data = getattr(value, "_data", value)
    nbytes = getattr(data, "nbytes", None)
    return int(nbytes) if isinstance(nbytes, int) else 0


class _CommSpan:
    __slots__ = ("kind", "key", "nbytes", "t0")

    def __init__(self, kind, key, nbytes):
        self.kind = kind
        self.key = key
        self.nbytes = nbytes

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        comm(self.kind, self.key, self.nbytes,
             time.perf_counter() - self.t0)
        return False


def comm_span(kind, key, value=None, nbytes=None):
    """Time one communication call and account ``value``'s bytes (or
    ``nbytes``) under ``(kind, key)``. The latency is the caller's: it
    includes any retry backoff and, for a reduce through ``gloo`` on
    CUDA tensors, the host's wait for the copies. No-op without a
    run."""
    if _run is None:
        return _NULL
    return _CommSpan(kind, key,
                     _nbytes(value) if nbytes is None else int(nbytes))


def comm_links(key, ici_bytes, dcn_bytes, calls=1):
    """Account one collective's bytes by link, keyed by the collective's
    kind: ``ici`` within a host's devices, ``dcn`` between processes.
    The port books every byte a rank sends another process under
    ``dcn``, as the JAX package books its process-group exchange, ranks
    on one host included. No-op without a run."""
    run = _run
    if run is None:
        return
    with _lock:
        for link, nbytes in (("ici", ici_bytes), ("dcn", dcn_bytes)):
            c = run.comms.get((link, str(key)))
            if c is None:
                c = run.comms[(link, str(key))] = {
                    "calls": 0, "bytes": 0, "time_ms": 0.0}
            c["calls"] += int(calls)
            c["bytes"] += int(nbytes)


def h2d(key, nbytes=0, seconds=0.0):
    """Account one host-to-device batch copy made by the input
    pipeline's placer (``io/pipeline.py``): the ``h2d`` kind of the comms
    ledger, and the process-wide profiler counters ``h2d_calls`` /
    ``h2d_bytes``. The copy runs on the placer's thread, off the step's
    accounting thread, so it is a counter and not a :func:`span`."""
    from . import profiler
    profiler.increment_counter("h2d_calls")
    profiler.increment_counter("h2d_bytes", int(nbytes))
    comm("h2d", key, nbytes, seconds)


def external_record(rec):
    """Append one externally-built record to the active run. No-op
    without a run. The caller
    must not hold any of its own locks that its telemetry callbacks
    also take (lock order: telemetry._lock is innermost here)."""
    run = _run
    if run is None:
        return
    with _lock:
        rec = dict(rec)
        run.records.append(rec)
    _remember(rec)


def checkpoint_event(fields):
    """Append one ``checkpoint`` record for a save of
    ``checkpoint.CheckpointManager`` (its writer thread calls this) and
    roll it into the run's checkpoint summary (count, bytes, blocking vs
    async milliseconds, failures, last good epoch). No-op without a
    run."""
    run = _run
    if run is None:
        return
    rec = {"type": "checkpoint", "seq": run.steps,
           "t": round(time.time() - run.t0_wall, 6)}
    rec.update(fields)
    with _lock:
        agg = run.ckpt
        if agg is None:
            agg = run.ckpt = {"saves": 0, "failures": 0, "bytes": 0,
                              "blocking_ms": 0.0, "async_ms": 0.0,
                              "last_good_epoch": None}
        if fields.get("ok"):
            agg["saves"] += 1
            agg["bytes"] += int(fields.get("bytes", 0) or 0)
        else:
            agg["failures"] += 1
        agg["blocking_ms"] += float(fields.get("blocking_ms", 0.0) or 0)
        agg["async_ms"] += float(fields.get("async_ms", 0.0) or 0)
        last = fields.get("last_good_epoch")
        if last is not None:
            prev = agg["last_good_epoch"]
            agg["last_good_epoch"] = last if prev is None \
                else max(prev, last)
        run.records.append(rec)
    _remember(rec)


def serving_event(fields):
    """Append one cumulative ``serving`` record from a
    ``serving.InferenceServer`` (request counts, latency percentiles,
    rps, occupancy, queue depth — the server emits one every
    ``record_every`` batches and at stop). The latest snapshot also
    lands in the summary's ``serving`` block. No-op without a run, so a
    run that never serves keeps a byte-identical sink."""
    run = _run
    if run is not None:
        rec = {"type": "serving", "seq": run.steps,
               "t": round(time.time() - run.t0_wall, 6)}
        rec.update(fields)
        with _lock:
            run.serving = dict(fields)     # cumulative: latest wins
            run.records.append(rec)
            _remember(rec)
            # a stepless sink-less serving process must not grow
            # records unboundedly
            _cap_records_locked(run)
    # the SLO watchdog observes snapshots even without a telemetry run;
    # called outside the lock
    hook = _watch_serving
    if hook is not None:
        hook(fields)


def decode_event(fields):
    """Append one cumulative ``decode`` record from a
    ``serving.DecodeServer`` (token throughput,
    time-to-first-token and inter-token percentiles, KV-pool
    occupancy/evictions, prefill-vs-decode step mix, weight-swap
    state — the server emits one every ``record_every`` scheduler
    steps and at stop). Latest snapshot per server ``name`` lands in
    the summary's ``decode`` block. No-op without a run, so a run
    that never decodes keeps a byte-identical sink."""
    run = _run
    if run is None:
        return
    rec = {"type": "decode", "seq": run.steps,
           "t": round(time.time() - run.t0_wall, 6)}
    rec.update(fields)
    with _lock:
        if run.decode is None:
            run.decode = {}
        # cumulative per server name: latest wins
        run.decode[fields.get("name") or "default"] = dict(fields)
        run.records.append(rec)
        _remember(rec)
        # a stepless sink-less process hosting a long-lived decode
        # server must not grow records unboundedly
        _cap_records_locked(run)


def prefix_cache_event(fields):
    """Append one cumulative ``prefix_cache`` record from a
    ``DecodeServer`` running with KV prefix sharing on (hit rate and
    hit tokens, bytes of prefill saved, shared / cow / evicted page
    counts, the per-model split of a shared pool — emitted alongside
    the ``decode`` record). Latest snapshot per server ``name`` lands
    in the summary's ``prefix_cache`` block. No-op without a run, so a
    sharing-off process keeps a byte-identical sink."""
    run = _run
    if run is None:
        return
    rec = {"type": "prefix_cache", "seq": run.steps,
           "t": round(time.time() - run.t0_wall, 6)}
    rec.update(fields)
    with _lock:
        if run.prefix is None:
            run.prefix = {}
        # cumulative per server name: latest wins
        run.prefix[fields.get("name") or "default"] = dict(fields)
        run.records.append(rec)
        _remember(rec)
        # a long-lived sharing server in a stepless process must not
        # grow records unboundedly
        _cap_records_locked(run)


def bucketing_event(fields):
    """Append one cumulative ``bucketing`` record from a shape-
    bucketing producer (``bucketing.BucketingStats``: per-bucket batch
    counts, padding-overhead share, pad-row and discarded-sample
    counts; producers emit every ``MXNET_BUCKETING_RECORD_EVERY``
    batches and at epoch boundaries). Latest snapshot per producer
    ``name`` lands in the summary's ``bucketing`` block. No-op without
    a run, so an unbucketed run keeps a byte-identical sink."""
    run = _run
    if run is None:
        return
    rec = {"type": "bucketing", "seq": run.steps,
           "t": round(time.time() - run.t0_wall, 6)}
    rec.update(fields)
    with _lock:
        if run.bucketing is None:
            run.bucketing = {}
        # cumulative per producer: latest wins
        run.bucketing[fields.get("name") or "default"] = dict(fields)
        run.records.append(rec)
        _remember(rec)
        # a stepless sink-less loop (a bare data-pipeline soak) must
        # not grow records unboundedly
        _cap_records_locked(run)


def router_event(fields):
    """Append one cumulative ``router`` record from a
    ``serving.Router`` (dispatches, failovers and replayed
    re-prefill tokens, detection-to-resume latency, per-replica
    outstanding tokens, per-tenant quota/latency state — the router
    emits one every ``MXNET_ROUTER_RECORD_EVERY`` active pump rounds
    and at stop). Latest snapshot per router ``name`` lands in the
    summary's ``router`` block. No-op without a run, so a routerless
    process keeps a byte-identical sink."""
    run = _run
    if run is None:
        return
    rec = {"type": "router", "seq": run.steps,
           "t": round(time.time() - run.t0_wall, 6)}
    rec.update(fields)
    with _lock:
        if run.router is None:
            run.router = {}
        # cumulative per router name: latest wins
        run.router[fields.get("name") or "default"] = dict(fields)
        run.records.append(rec)
        _remember(rec)
        # a long-lived fleet front door in a stepless process must not
        # grow records unboundedly
        _cap_records_locked(run)


def usage_event(fields):
    """Append one cumulative ``usage`` record from a
    ``metering.Meter`` — per-tenant attributed tokens,
    FLOPs, KV page*seconds, prefix-cache credits, outcome counts, and
    the meter's dual-entry reconciliation verdict (the meter emits
    every ``MXNET_METER_FLUSH_EVERY`` closed records and at
    ``metering.stop()``). Latest snapshot per meter ``name`` lands in
    the summary's ``usage`` block; diagnose reconciles it against the
    router's own counters. No-op without a run, so an unmetered
    process keeps a byte-identical sink."""
    run = _run
    if run is None:
        return
    rec = {"type": "usage", "seq": run.steps,
           "t": round(time.time() - run.t0_wall, 6)}
    rec.update(fields)
    with _lock:
        if run.usage is None:
            run.usage = {}
        # cumulative per meter name: latest wins
        run.usage[fields.get("name") or "default"] = dict(fields)
        run.records.append(rec)
        _remember(rec)
        # a long-lived metered fleet front door in a stepless process
        # must not grow records unboundedly
        _cap_records_locked(run)


def alert_event(fields):
    """Append one structured ``alert`` record — a Router's confirmed
    ``replica_lost`` or an SLO-watchdog breach (``livemetrics``): kind,
    message, and the breach's numbers. The alert list also lands in the summary's ``alerts``
    block and renders as the diagnose Alerts table. No-op without a
    run, so a watchdog-off (or alert-free) run keeps a byte-identical
    sink."""
    run = _run
    if run is not None:
        rec = {"type": "alert", "seq": run.steps,
               "t": round(time.time() - run.t0_wall, 6)}
        rec.update(fields)
        with _lock:
            if run.alerts is None:
                run.alerts = []
            run.alerts.append(dict(fields))
            # the summary's alert list is bounded: a condition that
            # stays in breach for days must not grow host memory — the
            # newest window plus a drop count tells the whole story
            if len(run.alerts) > _MAX_ALERTS:
                run.alerts_dropped += len(run.alerts) - _MAX_ALERTS
                del run.alerts[:len(run.alerts) - _MAX_ALERTS]
            run.records.append(rec)
            _remember(rec)
            _cap_records_locked(run)
    # the flight recorder dumps on the alert edge EVEN WITHOUT a run —
    # a pure serving process's watchdog breach still deserves a
    # post-mortem bundle. Called outside the lock.
    hook = _flight_alert
    if hook is not None:
        hook(dict(fields))


_MAX_ALERTS = 256


def note(name, delta=1):
    """Count one resilience/bookkeeping event against the run. The
    ``skipped_steps``/``retries``/``timeouts`` names feed the goodput
    accounting that report() reconciles with fault.stats(); any other
    name lands in the summary's ``events``."""
    run = _run
    if run is None:
        return
    with _lock:
        if name in run.fault_counters:
            run.fault_counters[name] += delta
        else:
            run.extra_counters[name] = \
                run.extra_counters.get(name, 0) + delta


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------

def sample_memory():
    """Sample per-card memory now (also runs automatically every
    MXNET_TELEMETRY_MEM_INTERVAL steps and at stop())."""
    run = _run
    if run is None:
        return
    _sample_memory(run)


def _sample_memory(run):
    """Each visible card's allocated bytes now and at peak (the caching
    allocator's counters: host bookkeeping, no device sync). No record
    without a card."""
    import torch
    if not torch.cuda.is_available():
        return
    for d in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(d)
        in_use = int(stats.get("allocated_bytes.all.current", 0))
        peak = int(stats.get("allocated_bytes.all.peak", in_use))
        _record_memory(run, "cuda:%d" % d, in_use, peak)


def memory_breakdown(**kinds):
    """Account a per-rank resident-bytes split by kind
    (``params_sharded`` / ``params_replicated`` / ``opt_state``, from the
    FSDP/ZeRO-1 trainer). Watermarks: each kind keeps its max over the
    run, and a ``memory_breakdown`` record is appended only when one
    grows (a steady loop adds one record). No-op without a run."""
    run = _run
    if run is None:
        return
    with _lock:
        bd = run.mem_breakdown
        if bd is None:
            bd = run.mem_breakdown = {}
        grew = False
        for k, v in kinds.items():
            v = int(v or 0)
            if v > bd.get(k, -1):
                bd[k] = v
                grew = True
        if grew:
            rec = {"type": "memory_breakdown", "seq": run.steps}
            rec.update(bd)
            run.records.append(rec)
            _remember(rec)


def _record_memory(run, device, in_use, peak):
    rec = {"type": "memory", "device": device, "seq": run.steps,
           "bytes_in_use": in_use, "peak_bytes_in_use": peak}
    with _lock:
        wm = run.mem_watermarks.get(device)
        if wm is None:
            wm = run.mem_watermarks[device] = {
                "peak_bytes_in_use": 0, "last_bytes_in_use": 0,
                "samples": 0}
        wm["peak_bytes_in_use"] = max(wm["peak_bytes_in_use"], peak,
                                      in_use)
        wm["last_bytes_in_use"] = in_use
        wm["samples"] += 1
        run.records.append(rec)
        _remember(rec)


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------

def recent_rate(n=None):
    """samples/sec over the last ``n`` ring-buffer steps that carry a
    sample count (None when unavailable) — the Speedometer's clock."""
    run = _run or _last_run
    if run is None:
        return None
    with _lock:
        steps = list(run.ring)
    if n:
        steps = steps[-int(n):]
    pairs = [(s["samples"], s["dur_ms"]) for s in steps
             if s.get("samples") and s.get("dur_ms")]
    if not pairs:
        return None
    total_s = sum(d for _, d in pairs) / 1e3
    if total_s <= 0:
        return float("inf")
    return sum(s for s, _ in pairs) / total_s


def quick_stats():
    """Per-callback subset of :func:`report` — steps, goodput,
    samples/sec, step-time p50 — without the memory copies or the
    fault snapshot, cheap enough for a batch-end
    callback. None when no run exists."""
    run = _run or _last_run
    if run is None:
        return None
    with _lock:
        steps = run.steps
        skipped = run.fault_counters["skipped_steps"]
        samples = run.samples
        total_s = run.total_step_s
        durs = [r["dur_ms"] for r in run.ring]
    return {
        "steps": steps,
        "goodput": ((steps - skipped) / steps) if steps else None,
        "samples_per_sec": (samples / total_s)
        if (samples and total_s > 0) else None,
        "step_time_ms_p50": percentile(durs, 50) if durs else None,
    }


def percentile(values, q):
    """Linear-interpolated percentile (numpy's default method) of an
    iterable; None on empty input. q in [0, 100]."""
    vals = sorted(values)
    if not vals:
        return None
    if len(vals) == 1:
        return float(vals[0])
    pos = (len(vals) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return float(vals[lo] * (1.0 - frac) + vals[hi] * frac)


def report():
    """The run summary: step-time percentiles (over the ring buffer),
    goodput, phase totals, memory watermarks, the latest serving
    snapshots, and the fault.stats() delta since the run started —
    ``skipped_steps``/``retried`` here reconcile exactly with it. Works
    on the active run, or the last stopped one."""
    run = _run or _last_run
    if run is None:
        return None
    with _lock:
        ring = list(run.ring)
        out = {
            "run_id": run.run_id,
            "steps": run.steps,
            "samples": run.samples,
            "skipped_steps": run.fault_counters["skipped_steps"],
            "retried": run.fault_counters["retries"],
            "timeouts": run.fault_counters["timeouts"],
            "phases_ms": {k: round(v * 1e3, 3)
                          for k, v in run.phase_totals.items()},
            "memory": {d: dict(w)
                       for d, w in run.mem_watermarks.items()},
        }
        if run.comms:
            out["comms"] = {"%s:%s" % k: dict(c)
                            for k, c in sorted(run.comms.items())}
        if run.mem_breakdown is not None:
            out["memory_breakdown"] = dict(run.mem_breakdown)
        if run.extra_counters:
            out["events"] = dict(run.extra_counters)
        if run.ckpt is not None:
            ck = dict(run.ckpt)
            ck["blocking_ms"] = round(ck["blocking_ms"], 3)
            ck["async_ms"] = round(ck["async_ms"], 3)
            out["checkpoint"] = ck
        if run.serving is not None:
            out["serving"] = dict(run.serving)
        if run.decode is not None:
            out["decode"] = {k: dict(v)
                             for k, v in run.decode.items()}
        if run.router is not None:
            out["router"] = {k: dict(v)
                             for k, v in run.router.items()}
        if run.prefix is not None:
            out["prefix_cache"] = {k: dict(v)
                                   for k, v in run.prefix.items()}
        if run.bucketing is not None:
            out["bucketing"] = {k: dict(v)
                                for k, v in run.bucketing.items()}
        if run.usage is not None:
            out["usage"] = {k: dict(v)
                            for k, v in run.usage.items()}
        if run.alerts is not None:
            out["alerts"] = [dict(a) for a in run.alerts]
            if run.alerts_dropped:
                out["alerts_dropped"] = run.alerts_dropped
        if run.records_dropped:
            out["records_dropped"] = run.records_dropped
        total_s = run.total_step_s
        fault_base = run.fault_base
        counters_base = run.counters_base
        cw_base = run.cw_base
    out["productive_steps"] = out["steps"] - out["skipped_steps"]
    out["goodput"] = (out["productive_steps"] / out["steps"]) \
        if out["steps"] else None
    out["samples_per_sec"] = (out["samples"] / total_s) \
        if (out["samples"] and total_s > 0) else None
    durs = [s["dur_ms"] for s in ring]
    if durs:
        out["step_time_ms"] = {
            "count": len(durs),
            "mean": sum(durs) / len(durs),
            "p50": percentile(durs, 50),
            "p90": percentile(durs, 90),
            "p99": percentile(durs, 99),
            "max": max(durs),
        }
    from . import fault
    if fault_base is not None:
        fs = fault.stats()
        out["fault"] = {k: fs.get(k, 0) - fault_base.get(k, 0)
                        for k in ("skipped_steps", "retries", "timeouts")}
    from . import compile_watch, profiler
    ctr = profiler.counters()
    fused = {k: v - counters_base.get(k, 0) for k, v in ctr.items()
             if k.startswith("fused_step")}
    if fused:
        out["counters"] = fused
    # compile & utilization blocks only while the compile watch is on,
    # so an off-run's summary (and sink) is byte-identical
    cblock, ublock = compile_watch.summary_blocks()
    if cblock is not None:
        if cw_base:
            # count/seconds scoped to THIS run; the per-program table
            # stays process-lifetime
            cblock["count"] = cblock["count"] - cw_base["count"]
            cblock["total_s"] = round(
                cblock["total_s"] - cw_base["total_s"], 6)
        out["compile"] = cblock
    if ublock is not None:
        out["utilization"] = ublock
    return out


# ---------------------------------------------------------------------------
# sink
# ---------------------------------------------------------------------------

def flush():
    """Write the run's pending records to the JSONL sink now (atomic
    create on the first flush, whole-line appends after — see the
    module docstring). Returns the filename, or None without a
    sink/run."""
    run = _run or _last_run
    if run is None:
        return None
    return _flush_run(run)


def _flush_run(run):
    """Create the sink atomically on first flush; later flushes append
    only the records accrued since (snapshot-and-clear is one locked
    step, so a record is either in memory or on disk, never both) —
    flush cost and resident memory stay O(new records), not O(run).
    The whole flush runs under the run's flush lock so two concurrent
    flushers (training thread + an explicit flush()/stop()) serialize
    instead of the creator's os.replace clobbering the appender's
    lines. Lock order: _flush_lock before _lock, never the reverse."""
    with run._flush_lock:
        with _lock:
            fname = run.filename
            if not fname:
                return None
            lines = [json.dumps(r) for r in run.records]
            run.records = []
            first = not run._sink_created
            run._sink_created = True
        try:
            if first and not os.path.exists(fname):
                # pid-unique tmp: two processes pointed at one path
                # must not scribble over each other's staging file
                tmp = "%s.%d.tmp" % (fname, os.getpid())
                with open(tmp, "w") as sink:
                    for line in lines:
                        sink.write(line)
                        sink.write("\n")
                os.replace(tmp, fname)
            elif lines:
                # either a later flush of this run, or the sink holds
                # an earlier run (two fits in one process reusing
                # MXNET_TELEMETRY_FILE): append instead of destroying
                # it — the diagnose reader renders the file's LAST run
                with open(fname, "a") as sink:
                    for line in lines:
                        sink.write(line)
                        sink.write("\n")
        except OSError as exc:
            # an observability layer enabled from the environment must
            # never kill the job it observes: disable the sink for the
            # rest of the run (ring + accumulators keep report()
            # working) and say so
            with _lock:
                run.filename = None
            import warnings
            warnings.warn(
                "telemetry: cannot write sink %s (%s: %s); sink "
                "disabled for the rest of this run"
                % (fname, type(exc).__name__, exc))
            return None
    return fname
