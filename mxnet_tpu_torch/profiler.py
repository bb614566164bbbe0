"""Profiler (counterpart of ``mxnet_tpu/profiler.py``; parity:
python/mxnet/profiler.py + src/profiler/).

- chrome://tracing JSON artifact — host-side scoped events
  (Task/Frame/Event/Counter/Marker + the ``record()`` scope) written by
  :func:`dump`, the DumpProfile artifact contract (profiler.h:304);
- aggregate per-name stats (AggregateStats) as a host-side table
  (:func:`dumps`); ``telemetry.span`` phases land there too;
- named monotonic counters (:func:`increment_counter`).

The JAX package's ``set_config(profile_all=True)`` also starts the XLA
device profiler. Device time on the card is read with
``torch.profiler`` by the caller; this module keeps host events only
and accepts the ``profile_*`` flags for source compatibility.
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["set_config", "profiler_set_config", "set_state",
           "profiler_set_state", "dump", "dumps", "pause", "resume",
           "Task", "Frame", "Event", "Counter", "Marker", "record",
           "aggregate_stats", "increment_counter", "counters",
           "reset_counters"]

_state = {
    "running": False,
    "filename": "profile.json",
    "events": [],
    "aggregate": {},
    "counters": {},
}
_lock = threading.Lock()
_t0 = time.time()


def _now_us():
    return int((time.time() - _t0) * 1e6)


def set_config(**kwargs):
    """Configure (reference: profiler.py set_config /
    MXSetProcessProfilerConfig): ``filename`` of the :func:`dump`
    artifact."""
    _state["filename"] = kwargs.get("filename", _state["filename"])


profiler_set_config = set_config


def set_state(state='stop', profile_process='worker'):
    """'run' | 'stop' (reference: profiler.py set_state)."""
    if state == 'run':
        global _MAX_EVENTS
        _MAX_EVENTS = None            # re-read the env cap at run start
        _state["running"] = True
    else:
        _state["running"] = False


profiler_set_state = set_state


def pause(profile_process='worker'):
    _state["running"] = False


def resume(profile_process='worker'):
    _state["running"] = True


_MAX_EVENTS = None


def _max_events():
    """MXNET_PROFILER_MAX_EVENTS, read once and cached — _emit sits on
    the tracing hot path. set_state('run') re-reads."""
    global _MAX_EVENTS
    if _MAX_EVENTS is None:
        from . import envs
        _MAX_EVENTS = envs.get_int("MXNET_PROFILER_MAX_EVENTS")
    return _MAX_EVENTS


def _emit(name, cat, ph, ts=None, args=None, dur=None):
    """Append one trace event — only while the profiler is running
    (a stopped profiler must not accumulate host events forever), and
    only up to MXNET_PROFILER_MAX_EVENTS; overflow increments the
    ``profiler_events_dropped`` counter instead of growing without
    bound."""
    if not _state["running"]:
        return
    ev = {"name": name, "cat": cat, "ph": ph,
          "ts": ts if ts is not None else _now_us(),
          "pid": os.getpid(), "tid": threading.get_ident()}
    if args:
        ev["args"] = args
    if dur is not None:
        ev["dur"] = dur
    with _lock:
        if len(_state["events"]) >= _max_events():
            # direct dict bump: increment_counter would re-enter _lock
            _state["counters"]["profiler_events_dropped"] = \
                _state["counters"].get("profiler_events_dropped", 0) + 1
            return
        _state["events"].append(ev)


def _aggregate(name, dur_us):
    with _lock:
        agg = _state["aggregate"].setdefault(
            name, {"count": 0, "total": 0.0, "min": float("inf"),
                   "max": 0.0})
        agg["count"] += 1
        agg["total"] += dur_us
        agg["min"] = min(agg["min"], dur_us)
        agg["max"] = max(agg["max"], dur_us)


def dumps(reset=False, format='table', sort_by='total', ascending=False):
    """Aggregate stats table (reference: MXAggregateProfileStatsPrint,
    which sorts by avg by default). ``sort_by`` is one of
    total|avg|count|min|max — an unknown key raises instead of
    silently sorting everything as 0."""
    valid = ("total", "avg", "count", "min", "max")
    if sort_by not in valid:
        raise ValueError("dumps: sort_by=%r (want %s)"
                         % (sort_by, "|".join(valid)))

    def _key(kv):
        a = kv[1]
        if sort_by == "avg":
            return a["total"] / max(a["count"], 1)
        return a[sort_by]

    with _lock:
        rows = sorted(_state["aggregate"].items(), key=_key,
                      reverse=not ascending)
        out = ["%-40s %8s %12s %12s %12s %12s"
               % ("Name", "Count", "Total(us)", "Avg(us)", "Min(us)",
                  "Max(us)")]
        for name, a in rows:
            out.append("%-40s %8d %12.1f %12.1f %12.1f %12.1f"
                       % (name, a["count"], a["total"],
                          a["total"] / max(a["count"], 1), a["min"],
                          a["max"]))
        if reset:
            _state["aggregate"] = {}
    return "\n".join(out)


def dump(finished=True, profile_process='worker'):
    """Write chrome://tracing JSON (reference: DumpProfile). The write
    is atomic (tmp + os.replace, the checkpoint-write contract) so a
    crash mid-dump never leaves a truncated trace."""
    with _lock:
        events = list(_state["events"])
        if finished:
            _state["events"] = []
    fname = _state["filename"]
    tmp = fname + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    os.replace(tmp, fname)
    return fname


def aggregate_stats():
    return dict(_state["aggregate"])


def increment_counter(name, delta=1):
    """Named monotonic counters (fused-step compile-cache hits/misses,
    dispatch and fallback counts, ...). Always accumulated — queryable
    via :func:`counters` — and additionally emitted as chrome-tracing
    counter events while the profiler is running."""
    with _lock:
        value = _state["counters"].get(name, 0) + delta
        _state["counters"][name] = value
    if _state["running"]:
        _emit(name, "counter", "C", args={"value": value})
    return value


def counters():
    """Snapshot of the named counters."""
    with _lock:
        return dict(_state["counters"])


def reset_counters():
    with _lock:
        _state["counters"] = {}


class _Scoped:
    def __init__(self, name, cat):
        self.name = name
        self.cat = cat
        self._start = None

    def start(self):
        self._start = _now_us()
        return self

    def stop(self):
        if self._start is None:
            return
        dur = _now_us() - self._start
        _emit(self.name, self.cat, "X", ts=self._start, dur=dur)
        _aggregate(self.name, dur)
        self._start = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()


class Task(_Scoped):
    def __init__(self, name, domain=None):
        super().__init__(name, "task")


class Frame(_Scoped):
    def __init__(self, name, domain=None):
        super().__init__(name, "frame")


class Event(_Scoped):
    def __init__(self, name):
        super().__init__(name, "event")


class Marker:
    def __init__(self, name, domain=None):
        self.name = name

    def mark(self, scope='process'):
        _emit(self.name, "marker", "i")


class Counter:
    """Trace counter. Value updates run under the module lock so
    concurrent increments never lose counts (the lock is released
    before the event emit, which takes it again)."""

    def __init__(self, name, domain=None, value=0):
        self.name = name
        self._v = value

    def set_value(self, value):
        with _lock:
            self._v = value
        _emit(self.name, "counter", "C", args={"value": value})

    def _shift(self, delta):
        with _lock:
            self._v += delta
            value = self._v
        _emit(self.name, "counter", "C", args={"value": value})

    def increment(self, delta=1):
        self._shift(delta)

    def decrement(self, delta=1):
        self._shift(-delta)

    __iadd__ = lambda self, d: (self.increment(d), self)[1]
    __isub__ = lambda self, d: (self.decrement(d), self)[1]


class record:
    """Scoped profiling (reference: profiler.py record)."""

    def __init__(self, filename=None, profile_all=True):
        if filename:
            set_config(filename=filename, profile_all=profile_all)

    def __enter__(self):
        set_state('run')
        return self

    def __exit__(self, *a):
        set_state('stop')
