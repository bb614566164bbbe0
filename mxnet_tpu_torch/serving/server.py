"""Serving error types and priority helpers (counterpart of the
admission part of ``mxnet_tpu/serving/server.py``). The one-shot
``InferenceServer`` waits for a later slice."""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ServerOverloadedError", "RequestTimeoutError",
           "ServerClosedError", "validate_priority",
           "shed_lowest_locked"]


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
