"""Per-tenant usage metering, disarmed (stands in for
``mxnet_tpu/metering.py``).

The JAX meter accrues page-seconds, prefix credits and FLOPs only while
a meter is armed, which is off by default. The port has no meter yet
(``ROADMAP.md`` queue A, observability): :func:`enabled` is always
False, so the decode server accrues nothing, as the disarmed JAX server
does.
"""
from __future__ import annotations

__all__ = ["enabled"]


def enabled():
    """True while a meter is armed (never, in this slice)."""
    return False
