"""Telemetry hooks of the decode serving path, disarmed (stands in for
``mxnet_tpu/telemetry.py``).

The JAX package sends ``decode``, ``prefix_cache``, ``router`` and
``alert`` records and counter notes to the active telemetry run; with
no run active, which is its default, each hook returns at once. The
port has no telemetry run yet (``ROADMAP.md`` queue A, observability),
so the hooks here are that disarmed state and :func:`enabled` is always
False (the router record has no hook: the Router raises if armed).
:func:`percentile` is a real copy: ``stats()`` reports latency
percentiles with it.
"""
from __future__ import annotations

__all__ = ["enabled", "note", "decode_event", "prefix_cache_event",
           "alert_event", "percentile"]


def enabled():
    """True while a telemetry run is active (never, in this slice)."""
    return False


def note(name, delta=1):
    """Count one bookkeeping event against the active run (none)."""


def decode_event(stats):
    """Record a cumulative ``decode`` snapshot in the active run
    (none)."""


def prefix_cache_event(stats):
    """Record a cumulative ``prefix_cache`` snapshot in the active run
    (none)."""


def alert_event(fields):
    """Record an ``alert`` (a confirmed replica loss) in the active run
    (none)."""


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
