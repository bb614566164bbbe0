"""Per-tenant usage metering, disarmed (stands in for
``mxnet_tpu/metering.py``).

The JAX meter accrues page-seconds, prefix credits and FLOPs only while
a meter is armed, which is off by default. The port has no meter yet
(``ROADMAP.md`` queue A, observability): :func:`enabled` is always
False, so the decode server accrues nothing and the router's request
hooks return at once, as the disarmed JAX ones do.
"""
from __future__ import annotations

__all__ = ["enabled", "emit", "inner_key", "request_admitted",
           "request_dispatched", "request_requeued", "request_resumed",
           "request_closed", "tenant_throttled"]


def enabled():
    """True while a meter is armed (never, in this slice)."""
    return False


def emit():
    """Write the usage snapshot (none while disarmed)."""


def inner_key(server, request_id):
    """Metering key for a replica-local request id: DecodeServer ids
    restart at 1 per server, so the key carries the server's
    identity."""
    return "%d:%s" % (id(server), request_id)


def request_admitted(tenant, request_id, prompt_tokens, max_new,
                     priority):
    """Open a session's usage record (none while disarmed)."""


def request_dispatched(request_id, inner_id, replica, replay=False,
                       replay_tokens=0):
    """Bind a session's record to a replica (none while disarmed)."""


def request_requeued(request_id):
    """Restamp a failed-over session's queue clock (none while
    disarmed)."""


def request_resumed(request_id, cached_tokens):
    """Note a failed-over session's first resumed token (none while
    disarmed)."""


def request_closed(request_id, outcome, generated_tokens=None,
                   latency_ms=None):
    """Close a session's record with its outcome (none while
    disarmed)."""


def tenant_throttled(tenant):
    """Count one token-bucket throttle of ``tenant`` (none while
    disarmed)."""
