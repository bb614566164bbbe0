"""KVStore — parameter synchronization on ``torch.distributed``
(counterpart of ``mxnet_tpu/kvstore.py``).

Types, matched by substring as the reference factory matches them
(:func:`create`):

- ``local`` / ``device`` — single-process aggregation. A list push sums
  the per-context copies in list order on the first copy's device (the
  CommDevice Reduce role); the stored value lives on one device.
- ``dist_sync`` / ``dist_device_sync`` / ``tpu_sync`` / ``dist`` — the
  sum also runs across processes: ONE ``torch.distributed.all_reduce``
  (SUM) over the process group per pushed key, under
  ``fault.with_retries`` (site ``push``) and ``telemetry.comm_span``.
  A dist store created in a launched worker joins the launcher's group
  (``fault.join_process_group``). Outside a launched world
  ``num_workers`` is 1 and the reduce is the identity, as in the JAX
  package: the semantics of one worker, not a fallback. The backend is
  ``parallel.distributed.backend_for``'s (``stats()["backend"]``). A
  collective that keeps failing raises ``CollectiveTimeoutError``
  after its retries; there is no second path.
- ``dist_async`` — accepted; degrades to synchronous updates, announced
  by a one-time warning (the JAX package's documented divergence).

``init`` stores this worker's own value, as the JAX package does; MXNet
1.5's dist store keeps rank 0's. Ranks must start from equal values
(seed alike).

**Pulls write in place.** A pull copies the stored value into each
destination's tensor when its shape, dtype and device match (a CUDA
graph that reads a gradient or weight buffer by address keeps
replaying); otherwise the destination takes a copy of the value.

``update_on_kvstore`` hosting (``set_optimizer``, ``set_updater``),
2-bit gradient compression with the worker-side residual, and the
optimizer-state files are kept.

**Sparse values.** A row_sparse push is not compressed; without an
updater the stored value becomes the pushed (reduced) row_sparse array.
Across processes it is reduced by row union
(:meth:`KVStore._global_reduce_rsp`): the ranks all-reduce (MAX) a
one-byte presence mask a row, agree on the sorted union of their rows
and all-reduce only that (U, ...) block, so the value never densifies to
its full shape. A csr push is reduced dense and cast back. ``pull``
skips a sparse stored value unless ``ignore_sparse=False``;
``row_sparse_pull`` gathers the requested rows (deduplicated and
sorted) into row_sparse destinations, and a dense ``out`` raises
``MXNetError`` (the reference asserts the same).

Observability: with a telemetry run active, every push and pull is
accounted per key under the comm kinds ``push``/``pull`` (bytes and
caller-observed latency, retry backoff included); a cross-process
reduce also books ``bytes x (workers - 1)`` under ``dcn`` for
``kvstore_push``.
"""
from __future__ import annotations

import functools
import logging

import torch

from . import fault
from . import optimizer as opt
from . import telemetry
from .base import MXNetError
from .ndarray import NDArray

__all__ = ["KVStore", "create"]

_TYPES = ("local", "device", "nccl", "tpu_sync", "dist_sync",
          "dist_device_sync", "dist_async", "dist")


def _ctype_key_value(key, vals):
    if isinstance(key, (tuple, list)):
        return list(key), list(vals)
    return [key], [vals]


def _sparse(arr):
    return getattr(arr, "stype", "default") != "default"


def _clone(arr):
    """A detached copy of ``arr`` on its device, outside any autograd
    graph (a sparse array's components copied)."""
    if _sparse(arr):
        return arr.copy()
    return NDArray(arr._data.detach().clone())


class _TwoBitCompressor:
    """Threshold quantizer with per-key error feedback (the worker side
    of the reference's gradient_compression.h: Quantize2Bit with the
    residual kept local). Values land in {-t, 0, +t}; the dropped mass
    feeds the next push."""

    def __init__(self, threshold):
        if threshold <= 0:
            raise ValueError("2bit compression threshold must be > 0")
        self.threshold = threshold
        self._residual = {}

    def compress(self, key, arr):
        t = self.threshold
        x = arr._data.detach()
        res = self._residual.get(key)
        if res is not None:
            x = x + res
        pos = torch.full((), t, dtype=x.dtype, device=x.device)
        q = torch.where(x >= t, pos,
                        torch.where(x <= -t, -pos, torch.zeros_like(pos)))
        self._residual[key] = x - q
        return NDArray(q)


def _ensure_process_group():
    """A dist store in a worker spawned by ``python -m
    mxnet_tpu_torch.tools.launch -n N ...`` joins the DMLC_* process
    group; a process in a group already, or without a contract, is left
    as it is."""
    from .parallel import distributed
    if not distributed.is_initialized():
        fault.join_process_group()


_DIST_ASYNC_WARNED = False


def _warn_dist_async_once():
    """dist_async degrades to synchronous updates (the JAX package's
    documented divergence); say so once."""
    global _DIST_ASYNC_WARNED
    if not _DIST_ASYNC_WARNED:
        _DIST_ASYNC_WARNED = True
        logging.warning(
            "kvstore 'dist_async' degrades to synchronous updates on "
            "this backend (documented divergence, SURVEY §2.2 Async SGD "
            "row): pushes are all-reduced across workers like "
            "'dist_sync', with the same retry/timeout guarding.")


class KVStore:
    """Key-value store for parameter synchronization
    (reference: kvstore.py:61)."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._data = {}
        self._updater = None
        self._optimizer = None
        self._compression = None
        self._compression_params = None
        self._key_order = {}
        self._is_dist = ("dist" in kv_type) or ("tpu" in kv_type)
        if self._is_dist:
            if "async" in kv_type:
                _warn_dist_async_once()
            _ensure_process_group()

    # -- identity --------------------------------------------------------
    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        from .parallel import distributed
        return distributed.rank()

    @property
    def num_workers(self):
        from .parallel import distributed
        return distributed.num_workers()

    def stats(self):
        """The store's type, the process group's backend (None for a
        single-process store or one worker), rank and workers."""
        from .parallel import distributed
        return dict(type=self._type,
                    backend=distributed.backend() if self._is_dist else None,
                    rank=self.rank, num_workers=self.num_workers)

    # -- core ops --------------------------------------------------------
    def init(self, key, value):
        """Store a copy of this worker's value for each key."""
        keys, vals = _ctype_key_value(key, value)
        for k, v in zip(keys, vals):
            if isinstance(v, (list, tuple)):
                v = v[0]
            self._data[k] = _clone(v)

    def _guarded(self, fn, site):
        """One sync phase under ``fault.with_retries`` on dist stores (and
        whenever a fault plan is active); a direct call otherwise. State
        changes stay OUT of the retried region: only communication runs
        again after a failure."""
        if self._is_dist:
            return fault.with_retries(fn, site=site)
        return fault.guard(fn, site)

    def push(self, key, value, priority=0):
        """Aggregate value(s) into the store: a list of per-context copies
        is summed in list order; a dist store then sums across
        processes."""
        keys, vals = _ctype_key_value(key, value)
        for k, v in zip(keys, vals):
            self._push_one(k, v)

    def _push_one(self, k, v):
        # local phase: aggregation and compression mutate worker-local
        # state (the compression residual), so they run exactly once
        if isinstance(v, (list, tuple)):
            agg = self._tree_sum([v[0]] + [self._like(x, v[0])
                                           for x in v[1:]])
        else:
            agg = v
        if self._compression is not None and not _sparse(agg):
            agg = self._compression.compress(k, agg)
        # communication phase: the only retried region; the latency is
        # the caller's, retry backoff included
        with telemetry.comm_span("push", k, agg):
            agg = self._guarded(
                functools.partial(self._global_reduce, agg), site="push")
        # apply phase: at most once a push, so a retried transport
        # failure never applies an optimizer update twice
        if self._optimizer is not None:
            self._ensure_updater()
        if self._updater is not None:
            self._updater(self._key_index(k), agg, self._data[k])
        elif _sparse(agg):
            # no updater: the merged value replaces the stored one
            self._data[k] = agg.copy()
        else:
            # no updater: the merged value replaces the stored one; a
            # value that is still a caller's tensor is copied first
            srcs = v if isinstance(v, (list, tuple)) else [v]
            if any(agg._data.data_ptr() == s._data.data_ptr()
                   for s in srcs):
                agg = _clone(agg)
            self._data[k] = agg

    @staticmethod
    def _tree_sum(vals):
        """The Reduce of a list push: the per-context copies summed in
        list order (``((v0 + v1) + v2) + ...``), outside autograd; sparse
        copies by their own sum (row_sparse by row union)."""
        if any(_sparse(v) for v in vals):
            agg = vals[0]
            for other in vals[1:]:
                agg = agg + other
            return agg
        agg = vals[0]._data.detach()
        for other in vals[1:]:
            agg = agg + other._data.detach()
        return NDArray(agg)

    @staticmethod
    def _like(arr, ref):
        """``arr`` on ``ref``'s device (itself when it is there; a
        sparse array keeps its own placement)."""
        if _sparse(arr) or _sparse(ref) \
                or arr._data.device == ref._data.device:
            return arr
        return NDArray(arr._data.detach().to(ref._data.device))

    def _global_reduce(self, arr):
        """The cross-process sum of a dist store: one
        ``torch.distributed.all_reduce(SUM)`` over the process group on a
        copy (the retried region must not change its input). One worker
        returns ``arr`` itself."""
        if not self._is_dist or self.num_workers == 1:
            return arr
        if arr.stype == "row_sparse":
            return self._global_reduce_rsp(arr)
        if arr.stype == "csr":
            # csr is no dist-push format of the reference (its server
            # merges row_sparse only): reduced dense, cast back
            return self._global_reduce(arr.tostype("default")) \
                .tostype("csr")
        import torch.distributed as dist
        buf = arr._data.detach().clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        telemetry.comm_links("kvstore_push", 0, buf.numel()
                             * buf.element_size() * (self.num_workers - 1))
        return NDArray(buf)

    def _global_reduce_rsp(self, arr):
        """The cross-process sum of a row_sparse value by row union (the
        reference server's row_sparse merge, kvstore_dist_server.h:499):
        each rank marks its rows in a one-byte mask of the value's
        first dimension, one all-reduce (MAX) of the masks gives every
        rank the same sorted union, each rank scatters its rows onto
        their union slots (the rows are unique: exact), and only that
        (U, ...) block is summed across ranks by :meth:`_global_reduce`.
        The value never densifies to its full shape."""
        import torch.distributed as dist
        from .ndarray.sparse import RowSparseNDArray
        data = arr.data._data.detach()
        idx = arr.indices._data.to(torch.long)
        mask = torch.zeros(arr.shape[0], dtype=torch.uint8,
                           device=data.device)
        mask[idx] = 1
        dist.all_reduce(mask, op=dist.ReduceOp.MAX)
        union = torch.nonzero(mask).squeeze(1)
        block = torch.zeros((union.numel(),) + tuple(arr.shape[1:]),
                            dtype=data.dtype, device=data.device)
        block.index_add_(0, torch.searchsorted(union, idx), data)
        summed = self._global_reduce(NDArray(block))
        return RowSparseNDArray(summed, NDArray(union.to(torch.int32)),
                                arr.shape, ctx=arr.context)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each key's stored value into ``out`` (an NDArray or a list
        of them), in place where shape, dtype and device match. A sparse
        stored value is skipped, unless ``ignore_sparse=False``: then it
        is copied (``copyto``) into each destination."""
        keys, outs = _ctype_key_value(key, out)
        for k, o in zip(keys, outs):
            with telemetry.comm_span("pull", k, self._data.get(k)):
                self._guarded(functools.partial(self._pull_one, k, o,
                                                ignore_sparse),
                              site="pull")

    def _pull_one(self, k, o, ignore_sparse=True):
        if k not in self._data:
            raise MXNetError("kvstore: key %s not initialized" % str(k))
        if _sparse(self._data[k]):
            if not ignore_sparse:
                for dst in o if isinstance(o, (list, tuple)) else [o]:
                    self._data[k].copyto(dst)
            return
        v = self._data[k]._data
        for dst in o if isinstance(o, (list, tuple)) else [o]:
            d = dst._data
            if d.shape == v.shape and d.dtype == v.dtype \
                    and d.device == v.device:
                with torch.no_grad():
                    d.copy_(v)
            else:
                dst._set_data(v.detach().to(d.device, copy=True))

    def pushpull(self, key, value, out=None, priority=0):
        self.push(key, value, priority)
        if out is not None:
            self.pull(key, out, priority)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """The rows ``row_ids`` names of each key's value, into row_sparse
        destinations (reference: kvstore.py row_sparse_pull): the ids
        deduplicated and sorted on the device (one host sync for their
        count), the rows gathered there. ``row_ids`` is one NDArray for
        every key or one a key; a dense ``out`` raises ``MXNetError``."""
        from .ndarray.sparse import RowSparseNDArray
        if out is None or row_ids is None:
            raise AssertionError("row_sparse_pull needs out and row_ids")
        keys, outs = _ctype_key_value(key, out)
        if isinstance(row_ids, NDArray):
            row_ids = [row_ids] * len(keys)
        for k, o, rid in zip(keys, outs, row_ids):
            v = self._data[k]
            if _sparse(v):
                v = v.tostype("default")
            dev = v._data.device
            ids = rid._data.detach() if isinstance(rid, NDArray) \
                else torch.as_tensor(rid)
            ids = torch.unique(ids.reshape(-1).to(dev, torch.long))
            rows = v.take(NDArray(ids))
            for tgt in o if isinstance(o, (list, tuple)) else [o]:
                if not isinstance(tgt, RowSparseNDArray):
                    raise MXNetError(
                        "row_sparse_pull requires 'out' arrays with "
                        "stype='row_sparse', got a dense NDArray for key "
                        "%s" % (k,))
                tgt._sp_data = rows.copy()
                tgt._sp_indices = NDArray(ids.to(torch.int32))
                tgt._shape = v.shape

    # -- updater/optimizer ----------------------------------------------
    def set_updater(self, updater):
        self._updater = updater

    _updater_func = property(lambda self: self._updater)

    def set_optimizer(self, optimizer):
        """Host the optimizer in the store (the update_on_kvstore path):
        each push applies it to the stored value."""
        self._optimizer = optimizer
        self._ensure_updater()

    def _ensure_updater(self):
        if self._updater is None and self._optimizer is not None:
            self._updater = opt.get_updater(self._optimizer)

    def _key_index(self, key):
        """The optimizer index of ``key``: its order of first update."""
        if key not in self._key_order:
            self._key_order[key] = len(self._key_order)
        return self._key_order[key]

    # -- gradient compression -------------------------------------------
    def set_gradient_compression(self, compression_params):
        """2-bit gradient compression with worker-side error feedback
        (reference: src/kvstore/gradient_compression.h:52): each push
        quantizes grad + residual to {-threshold, 0, +threshold} before
        the cross-worker reduce and keeps the quantization error as the
        residual of the next push."""
        if "type" not in compression_params:
            raise ValueError("compression_params requires 'type'")
        ctype = compression_params["type"]
        if ctype not in ("2bit", "none"):
            raise ValueError(
                "unsupported gradient compression type %r (2bit|none)"
                % (ctype,))
        self._compression_params = dict(compression_params)
        self._compression = _TwoBitCompressor(float(
            compression_params.get("threshold", 0.5))) \
            if ctype == "2bit" else None

    # -- distributed control --------------------------------------------
    def barrier(self):
        if self.num_workers > 1:
            from .parallel import distributed
            distributed.barrier("kvstore_barrier")

    _barrier = barrier

    def _send_command_to_servers(self, head, body):
        pass

    def save_optimizer_states(self, fname, dump_optimizer=False):
        assert self._updater is not None, "Cannot save states for " \
            "distributed training without updater"
        from .checkpoint import atomic_write_file
        atomic_write_file(fname, self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        assert self._updater is not None, "Cannot load states for " \
            "distributed training without updater"
        with open(fname, "rb") as src:
            self._updater.set_states(src.read())


def create(name="local"):
    """Factory (reference: kvstore.py:649; type matching kvstore.cc:40)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in _TYPES and not any(
            t in name for t in ("local", "device", "dist", "tpu")):
        raise MXNetError("unknown KVStore type %s" % name)
    return KVStore(name)
