"""Request tracing, disarmed (stands in for ``mxnet_tpu/tracing.py``).

The JAX tracer records spans only while ``MXNET_TRACE`` arms it, which
is off by default. The port has no tracer yet (``ROADMAP.md`` queue A,
observability): :func:`enabled` is always False, so the decode server
ignores a submitted ``trace_ctx`` exactly as the disarmed JAX server
does.
"""
from __future__ import annotations

__all__ = ["enabled"]


def enabled():
    """True while the tracer is armed (never, in this slice)."""
    return False
