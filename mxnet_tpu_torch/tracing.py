"""End-to-end request/step tracing with Perfetto-loadable export
(counterpart of ``mxnet_tpu/tracing.py``): the per-event half of the
observability stack.

The telemetry layer aggregates (phase totals, percentiles, counters);
this module records *events*: every routed session gets causally
linked spans across its lifetime (router queue → dispatch → replica
queue → prefill → decode), with router-side and replica-side spans
joined under one ``request_id`` by the wire context a dispatch carries
(:func:`wire_context` / :func:`adopt_context`); every Gluon Trainer
step gets a step span with its phase spans nested inside. Spans are
host time: a decode server closes its spans after the token's copy
back to the host, which already waits for the device, and no hook ever
runs inside a captured CUDA graph.

Storage is a bounded ring (``MXNET_TRACE_RING`` events, default
200000); :func:`stats` reports how many events the bound dropped.
:func:`export` writes the ring as Chrome trace-event JSON loadable in
Perfetto / chrome://tracing (atomic tmp + ``os.replace``), and
:func:`merge_exports` clock-aligns several processes' exports into one.

Always cheap when off: every hook is one module-global ``None`` check,
and :func:`span` returns a shared no-op singleton (zero allocation).
Enable with ``MXNET_TRACE=1`` (picked up at ``telemetry.start``) or
:func:`enable`; set ``MXNET_TRACE_FILE`` to export at
``disable``/atexit.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from . import envs

__all__ = ["enabled", "enable", "disable", "reset", "maybe_enable",
           "now", "add", "instant", "span", "context", "track",
           "export", "stats", "wire_context", "adopt_context",
           "merge_exports"]

_tracer = None          # the active _Trace; module-global None check
_lock = threading.Lock()


class _Trace:
    """One tracing session's ring + track table. Event appends run
    under the module lock (producers live on many threads)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.t0_wall = time.time()
        self.events = deque(
            maxlen=max(1, envs.get_int("MXNET_TRACE_RING")))
        self.dropped = 0
        self.pid = os.getpid()
        # synthetic tracks (per-request, compile, grad_sync, ...) get
        # small ids; real threads use their ident — the two ranges
        # cannot collide in practice (thread idents are pointers).
        # The table is BOUNDED (MXNET_TRACE_TRACKS) with LRU
        # eviction: a long-lived traced server mints one track per
        # request, and the most-recently-USED labels win — hot
        # system tracks stay named while cold one-shot per-request
        # labels age out; events whose label was evicted (and whose
        # spans have usually rotated out of the ring anyway) export
        # under their bare numeric tid
        self.tracks = {}          # label -> tid (insertion-ordered)
        self.max_tracks = max(
            16, envs.get_int("MXNET_TRACE_TRACKS"))
        self.next_tid = 1
        # clock-offset samples recorded by adopt_context (bounded):
        # each pairs a peer's wall stamp with ours, so merge_exports
        # and diagnose can cross-check the wall-anchor alignment
        self.wire_samples = deque(maxlen=64)


class _NullSpan:
    """Shared no-op span — the whole cost of :func:`span` when tracing
    is off. Zero allocation: one module-level singleton."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL = _NullSpan()


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def enabled():
    """True while tracing is active."""
    return _tracer is not None


def enable():
    """Turn tracing on (idempotent). Returns the tracer."""
    global _tracer, _atexit_registered
    with _lock:
        if _tracer is None:
            _tracer = _Trace()
    if not _atexit_registered:
        _atexit_registered = True
        import atexit
        atexit.register(_atexit_export)
    return _tracer


_atexit_registered = False


def _atexit_export():
    """Export to MXNET_TRACE_FILE at interpreter exit for runs that
    never call disable()/export() themselves."""
    fname = envs.get_path("MXNET_TRACE_FILE")
    if _tracer is not None and fname:
        try:
            export(fname)
        except OSError:
            pass


def disable():
    """Turn tracing off. When ``MXNET_TRACE_FILE`` is set the ring is
    exported there first. Returns the export path (or None)."""
    global _tracer
    fname = envs.get_path("MXNET_TRACE_FILE") or None
    out = None
    if _tracer is not None and fname:
        try:
            out = export(fname)
        except OSError:
            out = None
    with _lock:
        _tracer = None
    return out


def reset():
    """Forget the tracer entirely (tests)."""
    global _tracer
    with _lock:
        _tracer = None


def maybe_enable():
    """Enable when the environment asks (``MXNET_TRACE=1`` or
    ``MXNET_TRACE_FILE`` set) — called from ``telemetry.start`` so
    tracing rides a run the way the compile watch does. Returns True
    when active after the call."""
    if _tracer is not None:
        return True
    on = envs.get_bool("MXNET_TRACE")
    if on or envs.get_path("MXNET_TRACE_FILE"):
        enable()
        return True
    return False


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------

def now():
    """The tracer's clock (``time.perf_counter`` — the same clock
    telemetry stamps with, so step/phase/trace timestamps agree)."""
    return time.perf_counter()


def track(label):
    """The synthetic track (Chrome ``tid``) named ``label``; the name
    is attached at export as a ``thread_name`` metadata event so
    Perfetto shows the label. The label table is bounded at
    ``MXNET_TRACE_TRACKS`` with LRU eviction — the most-recently-used
    labels keep their names (perpetually-hot system tracks stay
    resident; cold one-shot per-request labels age out, mirroring the
    event ring's newest-wins bound); an evicted label's events (if
    any still survive in the ring) export under a bare numeric tid,
    with their args (request ids etc.) still carrying the identity.
    None when tracing is off."""
    t = _tracer
    if t is None:
        return None
    with _lock:
        tid = t.tracks.pop(label, None)
        if tid is None:
            if len(t.tracks) >= t.max_tracks:
                # LRU evict: the pop/re-insert below refreshes every
                # hit, so perpetually-hot system tracks (compile,
                # grad_sync, io:*) stay resident while cold one-shot
                # per-request labels age out
                del t.tracks[next(iter(t.tracks))]
            tid = t.next_tid
            t.next_tid += 1
        t.tracks[label] = tid          # (re-)insert at the MRU end
        return tid


def _append_locked(t, ev):
    """Ring append; caller holds the lock. A full ring drops the
    OLDEST event (deque maxlen) and counts the drop."""
    if len(t.events) == t.events.maxlen:
        t.dropped += 1
    t.events.append(ev)


def _append(t, ev):
    with _lock:
        _append_locked(t, ev)


def add(name, cat, t_start, dur_s, tid=None, args=None):
    """Record one complete (``X``) event: ``t_start`` is a
    :func:`now` stamp, ``dur_s`` seconds. ``tid`` is a real thread
    ident or a :func:`track` id (default: the calling thread). No-op
    when tracing is off."""
    t = _tracer
    if t is None:
        return
    ev = {"name": name, "cat": cat, "ph": "X",
          "ts": round((t_start - t.t0) * 1e6, 3),
          "dur": round(max(dur_s, 0.0) * 1e6, 3),
          "pid": t.pid,
          "tid": tid if tid is not None else threading.get_ident()}
    if args:
        ev["args"] = args
    _append(t, ev)


def instant(name, cat, tid=None, args=None, t_at=None):
    """Record one instant (``i``) event at ``t_at`` (default now)."""
    t = _tracer
    if t is None:
        return
    ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
          "ts": round(((t_at if t_at is not None
                        else time.perf_counter()) - t.t0) * 1e6, 3),
          "pid": t.pid,
          "tid": tid if tid is not None else threading.get_ident()}
    if args:
        ev["args"] = args
    _append(t, ev)


class _Span:
    __slots__ = ("name", "cat", "tid", "args", "t0")

    def __init__(self, name, cat, tid, args):
        self.name = name
        self.cat = cat
        self.tid = tid
        self.args = args

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        add(self.name, self.cat, self.t0,
            time.perf_counter() - self.t0, tid=self.tid,
            args=self.args)
        return False


def span(name, cat="span", tid=None, args=None):
    """A context manager recording one ``X`` event around its body.
    The shared no-op singleton when tracing is off."""
    if _tracer is None:
        return _NULL
    return _Span(name, cat, tid, args)


def context():
    """The current causal context, captured ON THE TRIGGERING THREAD
    and passed to off-thread work (checkpoint writer, decode pool) so
    its spans are parented to the step that triggered them by an
    explicit token, never by thread identity. Returns ``{"step": N}``
    (N = the open/most recent telemetry step) or None when tracing is
    off / no run is active."""
    if _tracer is None:
        return None
    from . import telemetry
    run = telemetry._run
    if run is None:
        return None
    # the step this work will CLOSE under: run.steps counts closed
    # steps, and both step_begin/step_end mode (the open step) and
    # gluon tick mode (everything between boundaries closes at the
    # next tick) resolve to steps + 1. Advisory read, no lock — the
    # token is trace metadata, not accounting.
    return {"step": run.steps + 1}


# ---------------------------------------------------------------------------
# cross-process correlation (the wire context)
# ---------------------------------------------------------------------------

def process_identity():
    """This process's fleet identity: ``{"rank", "gen"}`` — the
    launcher-contract rank (DMLC_WORKER_ID, else MXNET_TPU_RANK, else
    0) and the supervisor restart generation (MXNET_LAUNCH_RESTART).
    Cheap enough for per-dispatch use; shared by the wire context,
    the flight recorder, and the /metrics identity gauge."""
    if "DMLC_WORKER_ID" in os.environ:
        try:
            rank = int(os.environ["DMLC_WORKER_ID"])
        except ValueError:
            rank = 0
    else:
        rank = envs.get_int("MXNET_TPU_RANK") or 0
    return {"rank": rank, "gen": envs.get_int("MXNET_LAUNCH_RESTART")}


def wire_context(**fields):
    """A serializable trace context for crossing a process boundary
    (router→replica dispatch, rank→rank multihost exchange): the
    sender's pid/rank/restart-generation identity, a paired
    wall+monotonic clock sample (so the receiver — and later
    :func:`merge_exports` — can align the two processes' trace
    clocks), and any caller identity ``fields`` (``request_id``,
    ``tenant``, ``step``). Plain JSON-safe dict. None when tracing is
    off or ``MXNET_TRACE_WIRE=0`` — callers forward it unconditionally
    and receivers treat None as "no context" (one None check)."""
    t = _tracer
    if t is None or not envs.get_bool("MXNET_TRACE_WIRE"):
        return None
    ident = process_identity()
    ctx = {"v": 1, "pid": t.pid, "rank": ident["rank"],
           "gen": ident["gen"], "wall": time.time(),
           "mono": time.perf_counter()}
    step = context()
    if step is not None:
        ctx["step"] = step["step"]
    ctx.update(fields)
    return ctx


# the wire-context keys that are transport plumbing, not identity —
# adopt_context strips these from the span-args view it returns
_WIRE_CLOCK_KEYS = ("v", "wall", "mono")


def adopt_context(ctx, name="ctx:adopt", cat="wire", tid=None):
    """Adopt a peer's :func:`wire_context` on the receiving side:
    records one ``i`` event carrying the peer identity plus the
    observed wall skew, stores a bounded clock-offset sample for
    export, and returns the identity args (``request_id``/``tenant``/
    ``origin_pid``/``origin_rank``/``gen``/``step``) for the receiver
    to stamp onto its own spans so the two processes' events join
    under one id. None (and no event) when tracing is off or ``ctx``
    is falsy."""
    t = _tracer
    if t is None or not ctx:
        return None
    wall_in = time.time()
    args = {"origin_pid": ctx.get("pid"),
            "origin_rank": ctx.get("rank")}
    for k, v in ctx.items():
        if k not in _WIRE_CLOCK_KEYS and k not in ("pid", "rank"):
            args[k] = v
    wall_out = ctx.get("wall")
    if isinstance(wall_out, (int, float)):
        # one-way wall delta: ≥ transit time when the hosts' wall
        # clocks agree; merge_exports uses the samples to report how
        # trustworthy the wall-anchor alignment is
        skew = wall_in - wall_out
        args["wall_skew_ms"] = round(skew * 1e3, 3)
        with _lock:
            t.wire_samples.append(
                {"origin_pid": ctx.get("pid"),
                 "origin_rank": ctx.get("rank"),
                 "wall_out": wall_out, "wall_in": wall_in})
    instant(name, cat, tid=tid, args=args)
    return args


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def stats():
    """{"events", "dropped", "tracks"} of the live ring; None when
    tracing is off."""
    t = _tracer
    if t is None:
        return None
    with _lock:
        return {"events": len(t.events), "dropped": t.dropped,
                "tracks": len(t.tracks)}


def export(path=None):
    """Export the ring as Chrome trace-event JSON. With ``path``,
    write atomically (tmp + ``os.replace``) and return the path;
    without, return the trace dict. Loadable in Perfetto
    (https://ui.perfetto.dev) and chrome://tracing. Raises
    RuntimeError when tracing was never enabled."""
    t = _tracer
    if t is None:
        raise RuntimeError("tracing.export: tracing is not enabled")
    with _lock:
        # track-name metadata is synthesized from the label table at
        # export time, NOT stored in the ring — a week-long run whose
        # ring rotated a million times still exports every surviving
        # event under a named track
        names = [{"name": "thread_name", "ph": "M", "pid": t.pid,
                  "tid": tid, "args": {"name": label}}
                 for label, tid in sorted(t.tracks.items(),
                                          key=lambda kv: kv[1])]
        events = names + list(t.events)
        dropped = t.dropped
        ident = process_identity()
        meta = {"pid": t.pid, "trace_t0_wall": t.t0_wall,
                "dropped_events": dropped,
                "rank": ident["rank"], "gen": ident["gen"]}
        if t.wire_samples:
            meta["wire_samples"] = list(t.wire_samples)
    trace = {"traceEvents": events, "displayTimeUnit": "ms",
             "otherData": meta}
    if path is None:
        return trace
    tmp = "%s.%d.tmp" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, path)
    return path


def merge_exports(inputs, path=None):
    """Clock-align N per-process Chrome-JSON exports into ONE
    Perfetto-loadable trace. ``inputs`` is a list of export paths (or
    already-loaded trace dicts). Pure offline function — works with
    tracing off.

    Alignment uses each export's ``otherData.trace_t0_wall`` anchor
    (every process stamped its monotonic t0 against the wall clock at
    enable): the earliest anchor becomes the merged t=0 and every
    other process's events are shifted by its anchor delta, so a
    request's router-side and replica-side spans nest causally on the
    shared timeline. Colliding pids (two processes on different hosts
    can share one) are remapped, each process track gets a
    ``process_name`` metadata row (``rank R gen G (pid P)``), and
    ``otherData.processes`` records the per-input anchor, shift, and
    any ``wire_samples`` (adopt-time clock-offset observations) so a
    reader can judge the alignment's trust. With ``path`` the merged
    trace is written atomically and the path returned; without, the
    merged dict is returned. Raises ValueError on empty input or an
    input with no ``trace_t0_wall`` anchor."""
    traces = []
    for src in inputs:
        if isinstance(src, dict):
            traces.append((str(src.get("otherData", {}).get("pid")),
                           src))
        else:
            with open(src) as f:
                traces.append((str(src), json.load(f)))
    if not traces:
        raise ValueError("merge_exports: no inputs")
    anchors = []
    for label, tr in traces:
        meta = tr.get("otherData") or {}
        t0 = meta.get("trace_t0_wall")
        if not isinstance(t0, (int, float)):
            raise ValueError(
                "merge_exports: input %s has no trace_t0_wall anchor "
                "(not a tracing.export file?)" % label)
        anchors.append(float(t0))
    base = min(anchors)
    used_pids = set()
    meta_events, span_events = [], []
    processes, dropped = [], 0
    for (label, tr), t0 in zip(traces, anchors):
        meta = tr.get("otherData") or {}
        orig_pid = meta.get("pid")
        pid = orig_pid if isinstance(orig_pid, int) else 0
        while pid in used_pids:        # same pid on two hosts
            pid += 1 << 20
        used_pids.add(pid)
        shift_us = (t0 - base) * 1e6
        for ev in tr.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid
            if "ts" in ev:
                ev["ts"] = round(ev["ts"] + shift_us, 3)
            (meta_events if ev.get("ph") == "M"
             else span_events).append(ev)
        pname = "rank %s gen %s (pid %s)" % (
            meta.get("rank", "?"), meta.get("gen", 0), orig_pid)
        meta_events.append({"name": "process_name", "ph": "M",
                            "pid": pid, "args": {"name": pname}})
        dropped += int(meta.get("dropped_events", 0) or 0)
        processes.append({"pid": pid, "orig_pid": orig_pid,
                          "rank": meta.get("rank"),
                          "gen": meta.get("gen"),
                          "trace_t0_wall": t0,
                          "shift_us": round(shift_us, 3),
                          "wire_samples": meta.get("wire_samples",
                                                   [])})
    span_events.sort(key=lambda e: e.get("ts", 0.0))
    trace = {"traceEvents": meta_events + span_events,
             "displayTimeUnit": "ms",
             "otherData": {"merged_from": len(traces),
                           "trace_t0_wall": base,
                           "dropped_events": dropped,
                           "processes": processes}}
    if path is None:
        return trace
    tmp = "%s.%d.tmp" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, path)
    return path
