"""Bucketed gradient exchange through the kvstore (counterpart of the
eager part of ``mxnet_tpu/parallel/grad_sync.py``).

The gradient roster is partitioned into size-capped, dtype-uniform
buckets (``MXNET_GRAD_BUCKET_MB``) in backward order, late-layer
gradients first (:class:`GradSyncPlan`, PyTorch DDP's bucketing, Li et
al., VLDB 2020). With ``MXNET_GRAD_OVERLAP=1`` the eager exchange of
``Module`` and ``gluon.Trainer`` (:func:`bucketed_kvstore_sync`) pushes
and pulls each bucket's concatenated gradients under one key instead of
one push/pull a key: exact, because concatenation and the store's
elementwise sum commute. Each bucket is one ``grad_sync`` comm span.
Default off.

The in-program half of the JAX module (``make_bucketed_apply``, the
ZeRO-1 sharded state ``ShardedOptState``, the in-program accounting)
needs the mesh of ROADMAP queue A item 12, order step 6.
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import envs

__all__ = ["overlap_enabled", "bucket_cap_bytes", "GradSyncPlan",
           "bucketed_kvstore_sync"]


def overlap_enabled():
    """The ``MXNET_GRAD_OVERLAP`` gate, default off (read per call, so
    tests and benchmarks can toggle it)."""
    return envs.get_bool("MXNET_GRAD_OVERLAP")


def bucket_cap_bytes():
    """The bucket size cap from ``MXNET_GRAD_BUCKET_MB`` (default 4 MiB)."""
    return max(1, int(envs.get_float("MXNET_GRAD_BUCKET_MB") * (1 << 20)))


def _dtype_name(dtype):
    return "bfloat16" if str(dtype) == "bfloat16" else _np.dtype(dtype).name


def _itemsize(name):
    return 2 if name == "bfloat16" else _np.dtype(name).itemsize


class _Bucket:
    """One bucket: member indices in exchange order, their flat sizes and
    offsets in the concatenated vector, and the zero-padded length that
    divides the sync axis."""
    __slots__ = ("indices", "sizes", "offsets", "total", "padded_size",
                 "dtype", "nbytes")

    def __init__(self, indices, sizes, axis_size, dtype):
        self.indices = tuple(indices)
        self.sizes = tuple(sizes)
        self.offsets = tuple(int(o) for o in
                             _np.cumsum((0,) + self.sizes[:-1]))
        self.total = int(sum(self.sizes))
        self.padded_size = -(-self.total // axis_size) * axis_size
        self.dtype = str(dtype)
        self.nbytes = self.padded_size * _itemsize(self.dtype)


class GradSyncPlan:
    """The bucket partition of one parameter roster, built traversing it
    in REVERSE (backward produces late-layer gradients first). A bucket
    closes when the next parameter would pass the byte cap (each holds
    at least one) or changes the dtype."""

    def __init__(self, shapes, dtypes, axis_size, cap_bytes=None):
        cap = bucket_cap_bytes() if cap_bytes is None else int(cap_bytes)
        self.axis_size = int(axis_size)
        self.n_params = len(shapes)
        sizes = [int(_np.prod(s)) if len(s) else 1 for s in shapes]
        buckets = []
        cur, cur_sizes, cur_bytes, cur_dt = [], [], 0, None
        for i in reversed(range(len(shapes))):
            dt = _dtype_name(dtypes[i])
            nb = sizes[i] * _itemsize(dt)
            if cur and (dt != cur_dt or cur_bytes + nb > cap):
                buckets.append(_Bucket(cur, cur_sizes, self.axis_size,
                                       cur_dt))
                cur, cur_sizes, cur_bytes = [], [], 0
            cur.append(i)
            cur_sizes.append(sizes[i])
            cur_bytes += nb
            cur_dt = dt
        if cur:
            buckets.append(_Bucket(cur, cur_sizes, self.axis_size, cur_dt))
        self.buckets = buckets

    def signature(self):
        return tuple((b.indices, b.total, b.padded_size, b.dtype)
                     for b in self.buckets)

    def layout_key(self):
        """Which parameters land in which bucket at which offset, without
        the padding (which depends on the axis size)."""
        return tuple((b.indices, b.sizes, b.dtype) for b in self.buckets)

    def total_bytes(self):
        return sum(b.nbytes for b in self.buckets)

    def describe(self):
        return {"buckets": len(self.buckets), "axis_size": self.axis_size,
                "bytes": self.total_bytes(), "params": self.n_params}


def bucketed_kvstore_sync(kvstore, items, cap_bytes=None):
    """Exchange gradients through ``kvstore`` in size-capped concat
    buckets. ``items`` is an ordered ``[(key_index, grad_nd)]`` roster;
    each bucket is concatenated flat, pushed and pulled under one
    ``__grad_bucketNN`` key, and split back into the gradient buffers IN
    PLACE (a CUDA graph reading them by address keeps replaying).

    Returns True when the bucketed path ran; False (nothing touched) for
    an empty roster, a sparse gradient among them, or a store with 2-bit
    compression, whose residuals are kept per key: the caller keeps its
    per-key loop."""
    from .. import profiler, telemetry, tracing
    from ..ndarray import NDArray

    if not items or getattr(kvstore, "_compression", None) is not None \
            or any(getattr(g, "stype", "default") != "default"
                   for _, g in items):
        return False
    # the plan is a function of the roster's signature: cached on the
    # store, so a step does not rebuild it
    cap = bucket_cap_bytes() if cap_bytes is None else int(cap_bytes)
    sig = (tuple((tuple(g.shape), str(g.dtype)) for _, g in items), cap)
    cached = getattr(kvstore, "_grad_bucket_plan", None)
    if cached is not None and cached[0] == sig:
        plan = cached[1]
    else:
        plan = GradSyncPlan([g.shape for _, g in items],
                            [g.dtype for _, g in items], axis_size=1,
                            cap_bytes=cap)
        kvstore._grad_bucket_plan = (sig, plan)
    inited = kvstore.__dict__.setdefault("_grad_bucket_keys", set())
    for b, bucket in enumerate(plan.buckets):
        key = "__grad_bucket%02d" % b
        flat = torch.cat([items[i][1]._data.detach().reshape(-1)
                          for i in bucket.indices])
        flat_nd = NDArray(flat)
        if key not in inited:
            kvstore.init(key, NDArray(torch.zeros_like(flat)))
            inited.add(key)
        nbytes = 2 * flat.numel() * flat.element_size()
        t_tr = tracing.now() if tracing._tracer is not None else None
        # 2x: the bucket's bytes once each way (push, then pull)
        with telemetry.comm_span("grad_sync", "bucket%02d" % b,
                                 nbytes=nbytes):
            kvstore.push(key, flat_nd, priority=-b)
            kvstore.pull(key, flat_nd, priority=-b)
        if t_tr is not None:
            tracing.add("bucket%02d" % b, "comm", t_tr,
                        tracing.now() - t_tr, tid=tracing.track("grad_sync"),
                        args={"bytes": nbytes, "in_program": False})
        with torch.no_grad():
            for i, off, size in zip(bucket.indices, bucket.offsets,
                                    bucket.sizes):
                g = items[i][1]._data
                g.copy_(flat_nd._data[off:off + size].view(g.shape))
    profiler.increment_counter("grad_sync_kvstore_buckets",
                               len(plan.buckets))
    return True
