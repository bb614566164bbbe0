"""Execution engine shim (counterpart of ``mxnet_tpu/engine.py``;
reference: src/engine/ and python/mxnet/engine.py).

Op ordering and asynchronous dispatch come from torch: each device's
work is queued on its CUDA stream in program order, the ordering the
reference's read/write dependency tracking gives a single-stream
program. What stays on the host:

- :func:`naive_engine` is the reference's ``NaiveEngine``: inside it,
  hybridized blocks, executors, the fused step and the compile watch's
  programs run op by op, and no CUDA graph is captured or replayed
  (the JAX package's ``jax.disable_jit()``). It holds for the thread
  that enters it.
- the bulking knobs (``set_bulk_size``/``bulk``) are accepted and change
  nothing: a hybridized block already runs as one CUDA graph.
- :func:`wait_for_all` is the sync point, under the fault plan's site
  ``wait``.
"""
from __future__ import annotations

import contextlib
import threading

from . import envs

__all__ = ["bulk", "set_bulk_size", "wait_for_all", "engine_type",
           "naive_engine", "compiler_options"]

_bulk_size = 15
_naive = threading.local()


def compiler_options(ctx=None):
    """None: the port compiles no XLA programs, so it has no compile
    options (its kernels are built by nvcc with fixed flags,
    ``parallel/_build.py``). Kept for the JAX package's signature."""
    return None


def engine_type():
    return envs.get_str("MXNET_ENGINE_TYPE")


def set_bulk_size(size):
    global _bulk_size
    prev = _bulk_size
    _bulk_size = size
    return prev


@contextlib.contextmanager
def bulk(size):
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)


def wait_for_all():
    """Wait for every device's queued work; a planned hang at site
    ``wait`` (``MXNET_FAULT_PLAN``) surfaces as a typed
    ``CollectiveTimeoutError`` instead of wedging the thread."""
    from .ndarray import waitall
    from . import fault
    return fault.guard(waitall, "wait")


def is_naive():
    """True inside :func:`naive_engine` on this thread."""
    return getattr(_naive, "depth", 0) > 0


@contextlib.contextmanager
def naive_engine():
    """Synchronous, op-by-op execution for debugging (NaiveEngine)."""
    _naive.depth = getattr(_naive, "depth", 0) + 1
    try:
        yield
    finally:
        _naive.depth -= 1
