"""Named monotonic counters (counterpart of the counter part of
``mxnet_tpu/profiler.py``). The event profiler itself waits for a
later slice."""
from __future__ import annotations

import threading

__all__ = ["increment_counter", "counters"]

_lock = threading.Lock()
_counters = {}


def increment_counter(name, delta=1):
    """Add ``delta`` to the counter ``name``; returns the new value."""
    with _lock:
        value = _counters.get(name, 0) + delta
        _counters[name] = value
    return value


def counters():
    """Snapshot of the named counters."""
    with _lock:
        return dict(_counters)
