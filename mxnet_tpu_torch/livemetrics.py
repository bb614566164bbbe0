"""The ``/metrics`` registry hooks of the decode server, disarmed
(stands in for ``mxnet_tpu/livemetrics.py``).

In the JAX package a decode server or router registers itself for the
scrape and ``maybe_start`` opens the endpoint only when
``MXNET_METRICS_PORT`` is set. The port has no endpoint yet
(``ROADMAP.md`` queue A, observability), so registration keeps nothing
and nothing starts.
"""
from __future__ import annotations

__all__ = ["register_decode_server", "deregister_decode_server",
           "register_router", "deregister_router", "maybe_start"]


def register_decode_server(server):
    """Track a live decode server for the scrape (no endpoint yet)."""


def deregister_decode_server(server):
    """Drop a decode server from the scrape (no endpoint yet)."""


def register_router(router):
    """Track a live router for the scrape (no endpoint yet)."""


def deregister_router(router):
    """Drop a router from the scrape (no endpoint yet)."""


def maybe_start():
    """Start the endpoint when configured (never, in this slice)."""
