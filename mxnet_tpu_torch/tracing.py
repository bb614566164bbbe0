"""Request tracing, disarmed (stands in for ``mxnet_tpu/tracing.py``).

The JAX tracer records spans only while ``MXNET_TRACE`` arms it, which
is off by default. The port has no tracer yet (``ROADMAP.md`` queue A,
observability): :func:`enabled` is always False, so the decode server
ignores a submitted ``trace_ctx`` exactly as the disarmed JAX server
does, and the router's span and instant hooks record nothing.
"""
from __future__ import annotations

import time

__all__ = ["enabled", "now", "track", "add", "instant", "wire_context"]


def enabled():
    """True while the tracer is armed (never, in this slice)."""
    return False


def now():
    """The tracer's clock (``time.perf_counter``)."""
    return time.perf_counter()


def track(label):
    """The track named ``label`` (none while disarmed)."""


def add(name, cat, t_start, dur_s, tid=None, args=None):
    """Record a complete span (nothing while disarmed)."""


def instant(name, cat, tid=None, args=None, t_at=None):
    """Record an instant event (nothing while disarmed)."""


def wire_context(**fields):
    """The trace context a dispatch carries to a replica: None while the
    tracer is disarmed ("no context")."""
    return None
