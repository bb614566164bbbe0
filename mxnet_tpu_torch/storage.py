"""Device-memory introspection (counterpart of ``mxnet_tpu/storage.py``;
the reference's pooled Storage managers, src/storage/, are torch's
caching allocator here, so this module exposes its statistics).

:func:`memory_stats` gives the JAX package's keys for a CUDA device,
read from ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info``:
``bytes_in_use`` and ``peak_bytes_in_use`` (the allocator's live and
peak tensor bytes), ``bytes_limit`` (the device's total memory) and
``num_allocs`` (allocations so far); ``{}`` for the CPU, which reports
none."""
from __future__ import annotations

import torch

__all__ = ["memory_stats", "bytes_allocated", "bytes_limit",
           "pool_snapshot"]


def _device(dev=None):
    from .context import Context
    if dev is None:
        return torch.device("cuda", 0) if torch.cuda.is_available() \
            else torch.device("cpu")
    if isinstance(dev, int):
        return torch.device("cuda", dev)
    if isinstance(dev, Context):
        return torch.device("cuda", dev.device_id) \
            if dev.device_type == "gpu" else torch.device("cpu")
    return torch.device(dev)


def memory_stats(device=None):
    """Allocator statistics of one device (an int is a CUDA index, or a
    Context, a ``torch.device`` or its string): ``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit``, ``num_allocs``; ``{}`` for
    the CPU."""
    dev = _device(device)
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                          0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.mem_get_info(dev)[1]),
            "num_allocs": int(stats.get("allocation.all.allocated", 0))}


def bytes_allocated(device=None):
    return int(memory_stats(device).get("bytes_in_use", 0))


def bytes_limit(device=None):
    return int(memory_stats(device).get("bytes_limit", 0))


def pool_snapshot():
    """``{device: stats}`` over the host and every visible CUDA device,
    the analogue of dumping each pooled storage manager's counters."""
    devices = [torch.device("cpu")]
    if torch.cuda.is_available():
        devices += [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
    return {str(d): memory_stats(d) for d in devices}
