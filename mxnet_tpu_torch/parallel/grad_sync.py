"""Bucketed gradient exchange: through the kvstore, and over a rank mesh
with the ZeRO-1 sharded update (counterpart of
``mxnet_tpu/parallel/grad_sync.py``).

The gradient roster is partitioned into size-capped, dtype-uniform
buckets (``MXNET_GRAD_BUCKET_MB``) in backward order, late-layer
gradients first (:class:`GradSyncPlan`, PyTorch DDP's bucketing, Li et
al., VLDB 2020).

- **Through the kvstore** (``MXNET_GRAD_OVERLAP=1`` on ``Module`` and
  ``gluon.Trainer``): :func:`bucketed_kvstore_sync` pushes and pulls
  each bucket's concatenated gradients under one key instead of one
  push/pull a key: exact, because concatenation and the store's
  elementwise sum commute. Each bucket is one ``grad_sync`` comm span.
- **Over a rank mesh** (``parallel.data_parallel``):
  :func:`make_bucketed_apply` reduce-scatters each bucket of the ranks'
  gradient contributions (``collectives``' rank-order sum), runs the
  optimizer's ``fused_step_fn`` once over this rank's slice with per-
  element lr/wd vectors, against optimizer state that lives sharded
  along the same flat layout (:class:`ShardedOptState`, ZeRO-1,
  Rajbhandari et al., SC 2020: ``1/N`` a rank), and all-gathers the
  updated parameters only. Every supported rule is elementwise, and the
  sums are taken in rank order whatever the bucket layout, so a
  monolithic plan and a bucketed one give the same bits. The JAX
  package schedules these exchanges inside its compiled step, against
  the backward; the port runs them after the backward, bucket by bucket.
- **Over the in-process mesh** (a ``DeviceMesh``: the Gluon Trainer's
  fused update over contexts on distinct devices with
  ``MXNET_GRAD_OVERLAP=1``): :func:`make_bucketed_apply` takes each
  bucket's gradient contributions (autograd has already added the
  shards' into each parameter's one gradient, so there is one), reduce-
  scatters them over the devices (``collectives.device_reduce_scatter``:
  slice ``k`` on device ``k``), runs the update rule on each device's
  slice against its slice of the ZeRO-1 state, and all-gathers the
  updated parameters onto the first device. It carries the JAX form's
  non-finite guard (a parameter whose gradient is not finite keeps its
  weight and state on every slice) and fault splice (a planned poison
  replaces the gradient before the test).

Default off. Sharded optimizer state round-trips through
``checkpoint.py``'s per-shard manifest (each rank writes its slice), and
:meth:`ShardedOptState.load_host_flats` re-pads for the current axis
size: a run saved on N ranks (or JAX devices) resumes on M.
"""
from __future__ import annotations

import hashlib
import time

import numpy as _np
import torch

from .. import envs
from ..base import MXNetError

__all__ = ["overlap_enabled", "bucket_cap_bytes", "GradSyncPlan",
           "MONOLITH_CAP", "make_bucketed_apply", "ShardedOptState",
           "account_in_program_sync", "bucketed_kvstore_sync"]


def overlap_enabled():
    """The ``MXNET_GRAD_OVERLAP`` gate, default off (read per call, so
    tests and benchmarks can toggle it)."""
    return envs.get_bool("MXNET_GRAD_OVERLAP")


def bucket_cap_bytes():
    """The bucket size cap from ``MXNET_GRAD_BUCKET_MB`` (default 4 MiB)."""
    return max(1, int(envs.get_float("MXNET_GRAD_BUCKET_MB") * (1 << 20)))


def _dtype_name(dtype):
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
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


MONOLITH_CAP = 1 << 62   # a one-blob plan: the unbucketed baseline


def _slice_of(bucket, lo, hi, fill, pad_value):
    """The flat ``[lo, hi)`` window of a bucket whose member ``i`` holds
    ``fill(i, a, b)`` over its own ``[a, b)``; the pad tail holds
    ``pad_value(n)``."""
    parts = []
    for i, off, size in zip(bucket.indices, bucket.offsets, bucket.sizes):
        a, b = max(lo, off), min(hi, off + size)
        if a < b:
            parts.append(fill(i, a - off, b - off))
    if hi > bucket.total:
        parts.append(pad_value(hi - max(lo, bucket.total)))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def make_bucketed_apply(step_fns, n_slots, plan, mesh, axis="dp",
                        shard_state=True, gather_params=True, guard=False,
                        inject=False):
    """The bucketed, sharded form of ``fused_step.make_apply``:
    ``apply(grads, weights, states, scalars) -> (new_weights,
    new_states)`` over tensors. ``grads`` are this rank's
    CONTRIBUTIONS (the sum over the axis is the gradient), ``weights``
    the whole parameters, ``states`` the flat bucket layout: ``n_slots``
    vectors a bucket (``[b0s0..b0s{k-1}, b1s0, ...]``), this rank's
    ``padded / n`` slice each with ``shard_state``, the whole padded
    vector without.

    Per bucket: reduce-scatter the flat gradients (zero pad), take this
    rank's slice of the weights and of the per-element lr/wd vectors, run
    the bucket's update rule once over the slice, and all-gather the
    updated parameters (and, without ``shard_state``, the updated
    states). The update always runs on the slice, in both state layouts.
    With ``gather_params=False`` (FSDP) the updated parameters stay this
    rank's slices: ``new_weights`` holds one flat vector a bucket, the
    layout of :func:`bucket_slices`. ``apply.sync_seconds`` holds the last call's exchange time per bucket.

    Over a ``DeviceMesh`` (inside one process) the form is the JAX
    package's whole contract, ``apply(grads, weights, states, scalars,
    poisons) -> (new_weights, new_states, finite_mask)``: ``states`` are
    ``MeshTensor`` s (one slice a device), ``guard`` keeps the old
    weight and state of a parameter whose gradient is not finite (mask
    None without it), ``inject`` splices ``poisons`` into the gradients
    first (:func:`_device_bucketed_apply`)."""
    from .mesh import DeviceMesh
    if isinstance(mesh, DeviceMesh):
        return _device_bucketed_apply(step_fns, n_slots, plan, mesh, guard,
                                      inject)
    from .collectives import _scatter_sum, all_gather
    n = len(step_fns)
    group, ranks = mesh.group(axis)
    n_rank = len(ranks)
    me = ranks.index(mesh.rank)

    def apply(grads, weights, states, scalars):
        new_ws = [None] * (n if gather_params else len(plan.buckets))
        new_sts = [None] * len(states)
        sync_s = []
        si = 0
        for b, bucket in enumerate(plan.buckets):
            per = bucket.padded_size // n_rank
            lo, hi = me * per, (me + 1) * per
            dt = grads[bucket.indices[0]].dtype
            dev = grads[bucket.indices[0]].device
            segs = [grads[i].reshape(-1) for i in bucket.indices]
            pad = bucket.padded_size - bucket.total
            if pad:
                segs.append(torch.zeros(pad, dtype=dt, device=dev))
            t0 = time.perf_counter()
            gflat = torch.cat(segs)
            g_loc = gflat if n_rank == 1 else \
                _scatter_sum(gflat, group, n_rank)
            dt_rs = time.perf_counter() - t0
            del gflat, segs
            w_loc = _slice_of(bucket, lo, hi,
                              lambda i, a, b: weights[i].reshape(-1)[a:b],
                              lambda k: torch.zeros(k, dtype=dt, device=dev))
            fn = step_fns[bucket.indices[0]]
            sdt = getattr(fn, "scalar_dtype", None) or dt
            lr_v = _slice_of(
                bucket, lo, hi,
                lambda i, a, b: scalars[i].to(sdt).expand(b - a),
                lambda k: torch.zeros(k, dtype=sdt, device=dev))
            wd_v = _slice_of(
                bucket, lo, hi,
                lambda i, a, b: scalars[n + i].to(sdt).expand(b - a),
                lambda k: torch.zeros(k, dtype=sdt, device=dev))
            st = tuple(states[si + k] for k in range(n_slots))
            if not shard_state:
                st = tuple(s[lo:hi] for s in st)
            nw, nst = fn(g_loc, w_loc, st, lr_v, wd_v,
                         scalars[2 * n].to(sdt))
            t0 = time.perf_counter()
            for k in range(n_slots):
                new_sts[si + k] = nst[k] if shard_state or n_rank == 1 \
                    else all_gather(nst[k], mesh, axis, account=False)
            si += n_slots
            if not gather_params:
                new_ws[b] = nw
                sync_s.append(dt_rs + time.perf_counter() - t0)
                continue
            # the all-gather of UPDATED parameters only
            full_w = nw if n_rank == 1 else \
                all_gather(nw, mesh, axis, account=False)
            sync_s.append(dt_rs + time.perf_counter() - t0)
            for i, off, size in zip(bucket.indices, bucket.offsets,
                                    bucket.sizes):
                new_ws[i] = full_w[off:off + size].view(weights[i].shape)
        apply.sync_seconds = sync_s
        return new_ws, new_sts
    apply.sync_seconds = []
    return apply


def _device_bucketed_apply(step_fns, n_slots, plan, mesh, guard, inject):
    """:func:`make_bucketed_apply` over the devices of one process."""
    from .collectives import device_gather, device_reduce_scatter
    from .mesh import MeshTensor
    n = len(step_fns)
    devices = mesh.devices

    def apply(grads, weights, states, scalars, poisons=None):
        new_ws = [None] * n
        new_sts = [None] * len(states)
        oks = [None] * n
        sync_s = []
        si = 0
        for bucket in plan.buckets:
            dt = grads[bucket.indices[0]].dtype
            fn = step_fns[bucket.indices[0]]
            sdt = getattr(fn, "scalar_dtype", None) or dt
            pad = bucket.padded_size - bucket.total
            segs_g, segs_w, segs_lr, segs_wd, segs_ok = [], [], [], [], []
            for i, size in zip(bucket.indices, bucket.sizes):
                g = grads[i].reshape(-1)
                if inject:
                    g = torch.where(torch.isfinite(poisons[i]), g,
                                    poisons[i].to(g.dtype))
                if guard:
                    oks[i] = torch.isfinite(g).all()
                    segs_ok.append(oks[i].expand(size))
                segs_g.append(g)
                segs_w.append(weights[i].reshape(-1))
                segs_lr.append(scalars[i].to(sdt).expand(size))
                segs_wd.append(scalars[n + i].to(sdt).expand(size))
            if pad:
                for segs, fill in ((segs_g, 0), (segs_w, 0), (segs_lr, 0),
                                   (segs_wd, 0), (segs_ok, True)):
                    if segs:
                        segs.append(torch.full((pad,), fill,
                                               dtype=segs[0].dtype,
                                               device=segs[0].device))
            t0 = time.perf_counter()
            g_sl = device_reduce_scatter([torch.cat(segs_g)], devices)
            dt_rs = time.perf_counter() - t0
            # the weights, per-element scalars and guard flags are
            # replicated: their slices are copies, not sums
            w_sl, lr_sl, wd_sl = (device_reduce_scatter([torch.cat(segs)],
                                                        devices)
                                  for segs in (segs_w, segs_lr, segs_wd))
            ok_sl = device_reduce_scatter([torch.cat(segs_ok)], devices) \
                if guard else None
            rescale = scalars[2 * n].to(sdt)
            nws, nsts = [], []
            for k, dev in enumerate(devices):
                st = tuple(states[si + j].shards[k] for j in range(n_slots))
                nw, nst = fn(g_sl[k], w_sl[k], st, lr_sl[k], wd_sl[k],
                             rescale.to(dev))
                if guard:
                    nw = torch.where(ok_sl[k], nw, w_sl[k])
                    nst = tuple(torch.where(ok_sl[k], a, b)
                                for a, b in zip(nst, st))
                nws.append(nw)
                nsts.append(nst)
            for j in range(n_slots):
                new_sts[si + j] = MeshTensor([nst[j] for nst in nsts], mesh,
                                             0)
            si += n_slots
            t0 = time.perf_counter()
            # the all-gather of UPDATED parameters only
            full_w = device_gather(nws, devices[0])
            sync_s.append(dt_rs + time.perf_counter() - t0)
            for i, off, size in zip(bucket.indices, bucket.offsets,
                                    bucket.sizes):
                new_ws[i] = full_w[off:off + size].view(weights[i].shape)
        apply.sync_seconds = sync_s
        mask = torch.stack(oks) if guard else None
        return new_ws, new_sts, mask
    apply.sync_seconds = []
    return apply


def bucket_slices(plan, weights, index):
    """This rank's slice (``index`` on the sync axis) of every bucket's
    flat, zero-padded parameter vector: FSDP's layout at rest, the one
    the update produces."""
    out = []
    for bucket in plan.buckets:
        per = bucket.padded_size // plan.axis_size
        w0 = weights[bucket.indices[0]]
        out.append(_slice_of(
            bucket, index * per, (index + 1) * per,
            lambda i, a, b: weights[i].reshape(-1)[a:b],
            lambda k: torch.zeros(k, dtype=w0.dtype, device=w0.device))
            .clone())
    return out


def gather_bucket_slices(plan, slices, shapes, mesh, axis="dp"):
    """The whole parameters from the ranks' :func:`bucket_slices`, one
    all-gather a bucket: FSDP's gather at step entry."""
    from .collectives import all_gather
    out = [None] * plan.n_params
    for bucket, part in zip(plan.buckets, slices):
        full = part if plan.axis_size == 1 else \
            all_gather(part, mesh, axis, account=False)
        for i, off, size in zip(bucket.indices, bucket.offsets,
                                bucket.sizes):
            out[i] = full[off:off + size].view(shapes[i])
    return out


class ShardedOptState:
    """Flat, bucket-aligned optimizer state sharded over a mesh axis:
    each bucket holds ``n_slots`` vectors, this rank's ``padded / N``
    slice of each (the ZeRO-1 layout; ``sharded=False`` keeps the whole
    padded vectors on every rank, the unbucketed baseline). Slot count
    and dtypes come from the optimizer's own
    ``create_state_multi_precision``; the values start at zeros, as every
    fused optimizer's states do."""

    def __init__(self, plan, mesh, axis="dp", sharded=True):
        self.plan = plan
        self.mesh = mesh
        self.axis = axis
        self.sharded = bool(sharded)
        self.n_slots = None
        self.device = None
        self._slot_dtypes = None
        self._flats = None        # a list over buckets of tuples

    def probe(self, optimizer, indices, weights_nd):
        """Slot count and dtypes from one parameter per bucket; False
        when a bucket's layout disagrees (the caller refuses)."""
        from ..fused_step import _flat_state_handles
        n_slots, dtypes = None, None
        for bucket in self.plan.buckets:
            i = bucket.indices[0]
            flat = _flat_state_handles(optimizer.create_state_multi_precision(
                indices[i], weights_nd[i]))
            if flat is None:
                return False
            names = [h._data.dtype for h in flat]
            if n_slots is None:
                n_slots, dtypes = len(flat), names
            elif len(flat) != n_slots or names != dtypes:
                return False
        self.n_slots = n_slots
        self._slot_dtypes = dtypes
        if weights_nd:
            self.device = weights_nd[0]._data.device
        return True

    def _span(self, bucket):
        """This rank's ``[lo, hi)`` of a bucket's padded vector."""
        if not self.sharded:
            return 0, bucket.padded_size
        per = bucket.padded_size // self.plan.axis_size
        idx = self.mesh.axis_index(self.axis) if self.plan.axis_size > 1 \
            else 0
        return idx * per, (idx + 1) * per

    def _on_devices(self):
        from .mesh import DeviceMesh
        return isinstance(self.mesh, DeviceMesh)

    def ensure(self):
        """The flat state tuple of a step, zeros on first use (over a
        ``DeviceMesh``: one ``MeshTensor`` a vector, a slice on each
        device). Call :meth:`probe` first."""
        assert self.n_slots is not None, "probe() before ensure()"
        if self._flats is None and self._on_devices():
            self._flats = [tuple(self.mesh.split(
                torch.zeros(bucket.padded_size, dtype=dt), 0)
                for dt in self._slot_dtypes) for bucket in self.plan.buckets]
        if self._flats is None:
            self._flats = [tuple(
                torch.zeros(hi - lo, dtype=dt, device=self.device)
                for dt in self._slot_dtypes)
                for lo, hi in map(self._span, self.plan.buckets)]
        return tuple(a for b in self._flats for a in b)

    def store(self, new_flat_tuple):
        """Keep a step's output states (the same flat order)."""
        k, flats = self.n_slots, list(new_flat_tuple)
        self._flats = [tuple(flats[b * k:(b + 1) * k])
                       for b in range(len(self.plan.buckets))]

    def state_bytes_per_device(self):
        """Resident state bytes a rank: ``1/N`` of the replicated layout
        when sharded."""
        if self.n_slots is None:
            return 0
        per_dev = 0
        for bucket in self.plan.buckets:
            n = bucket.padded_size // self.plan.axis_size \
                if self.sharded else bucket.padded_size
            per_dev += sum(n * torch.empty((), dtype=dt).element_size()
                           for dt in self._slot_dtypes)
        return per_dev

    def _whole(self, arr):
        from .collectives import all_gather
        if self._on_devices():
            return arr.host()
        if not self.sharded or self.plan.axis_size == 1:
            return arr
        return all_gather(arr, self.mesh, self.axis, account=False)

    def export_per_param(self, shapes):
        """The states split back per parameter, on the host:
        ``{index: [slot arrays]}`` (gathers the slices: every rank
        calls it)."""
        from ..ndarray.ndarray import host_numpy
        out = {}
        if self._flats is None:
            return out
        for bucket, slots in zip(self.plan.buckets, self._flats):
            host = [host_numpy(self._whole(s)) for s in slots]
            for i, off, size in zip(bucket.indices, bucket.offsets,
                                    bucket.sizes):
                out[i] = [h[off:off + size].reshape(shapes[i]) for h in host]
        return out

    def _seed(self, full_of):
        from ..ndarray.ndarray import tensor_from_numpy
        if self._on_devices():
            self._flats = [tuple(self.mesh.split(tensor_from_numpy(
                full_of(b, bucket, k)), 0) for k in range(self.n_slots))
                for b, bucket in enumerate(self.plan.buckets)]
            return
        flats = []
        for b, bucket in enumerate(self.plan.buckets):
            lo, hi = self._span(bucket)
            flats.append(tuple(
                tensor_from_numpy(full_of(b, bucket, k)[lo:hi].copy())
                .to(self.device) for k in range(self.n_slots)))
        self._flats = flats

    def _np_dtype(self, k):
        from ..ndarray.ndarray import numpy_dtype
        return numpy_dtype(self._slot_dtypes[k])

    def seed_per_param(self, per_param):
        """Fill the flats from per-parameter host states ``{index:
        [slot arrays]}``; missing indices keep zeros."""
        assert self.n_slots is not None, "probe() before seeding"

        def full_of(b, bucket, k):
            full = _np.zeros((bucket.padded_size,), self._np_dtype(k))
            for i, off, size in zip(bucket.indices, bucket.offsets,
                                    bucket.sizes):
                st = per_param.get(i)
                if st is not None:
                    full[off:off + size] = _np.asarray(st[k]).reshape(-1)
            return full
        self._seed(full_of)

    def checkpoint_roster(self):
        """``{'opt:bucketBB.slotS': ShardedTensor}`` for the manifest
        writer (each rank's slice is one piece), plus ``opt:layout``, a
        fingerprint of the bucket partition that refuses a restore under
        another partition."""
        from .mesh import NamedSharding, PartitionSpec, ShardedTensor
        out = {}
        if self._flats is None:
            return out
        spec = PartitionSpec(self.axis) if self.sharded else PartitionSpec()
        sharding = NamedSharding(self.mesh, spec)
        for b, (bucket, slots) in enumerate(zip(self.plan.buckets,
                                                self._flats)):
            for k, arr in enumerate(slots):
                out["opt:bucket%02d.slot%d" % (b, k)] = ShardedTensor(
                    arr, (bucket.padded_size,), sharding)
        out["opt:layout"] = self._layout_fingerprint()
        return out

    def _layout_fingerprint(self):
        digest = hashlib.sha256(
            repr(self.plan.layout_key()).encode()).digest()
        return _np.frombuffer(digest, _np.uint8).copy()

    def load_host_flats(self, flat_dict):
        """Restore from a checkpoint's ``opt:bucketBB.slotS`` host arrays
        of any save-time topology: strip the save-time padding, re-pad
        for the current axis size, keep this rank's slice. Checks every
        entry before it changes anything."""
        assert self.n_slots is not None, "probe() before restore"
        saved_layout = flat_dict.get("opt:layout")
        if saved_layout is not None and not _np.array_equal(
                _np.asarray(saved_layout).reshape(-1).astype(_np.uint8),
                self._layout_fingerprint()):
            raise MXNetError(
                "sharded optimizer state: the checkpoint's bucket "
                "partition differs from the current plan (different "
                "MXNET_GRAD_BUCKET_MB / roster?) — refusing to slice "
                "state into the wrong parameters")
        hosts = {}
        for b, bucket in enumerate(self.plan.buckets):
            for k in range(self.n_slots):
                key = "opt:bucket%02d.slot%d" % (b, k)
                if key not in flat_dict:
                    raise MXNetError("sharded optimizer state: checkpoint "
                                     "is missing %s" % key)
                host = _np.asarray(flat_dict[key]).reshape(-1)
                if host.size < bucket.total:
                    raise MXNetError(
                        "sharded optimizer state: %s holds %d elements but "
                        "the roster needs %d (bucket layout changed?)"
                        % (key, host.size, bucket.total))
                hosts[b, k] = host

        def full_of(b, bucket, k):
            full = _np.zeros((bucket.padded_size,), self._np_dtype(k))
            full[:bucket.total] = hosts[b, k][:bucket.total]
            return full
        self._seed(full_of)


def account_in_program_sync(plan, mesh=None, axis="dp", seconds=None):
    """Ledger one step's bucket traffic over the mesh: a ``grad_sync``
    comm record per bucket (the reduce-scatter's and the updated
    parameters' all-gather bytes, once each way; ``seconds[b]`` the
    bucket's measured exchange time, 0 when not given), the per-link
    split of the whole under ``grad_sync`` with ``mesh``, a
    ``grad_sync_steps`` event, and, under an armed tracer, an event per
    bucket on the ``grad_sync`` track."""
    from .. import telemetry, tracing
    seconds = list(seconds or [])
    if tracing._tracer is not None:
        tid = tracing.track("grad_sync")
        ctx = tracing.context() or {}
        for b, bucket in enumerate(plan.buckets):
            tracing.instant("bucket%02d" % b, "comm", tid=tid,
                            args=dict(ctx, bytes=2 * bucket.nbytes,
                                      in_program=True))
    if not telemetry.enabled():
        return
    total = 0
    for b, bucket in enumerate(plan.buckets):
        telemetry.comm("grad_sync", "bucket%02d" % b,
                       nbytes=2 * bucket.nbytes,
                       seconds=seconds[b] if b < len(seconds) else 0.0)
        total += 2 * bucket.nbytes
    if mesh is not None:
        from .mesh import link_split
        try:
            ici, dcn = link_split(mesh, axis, total)
        except ValueError:
            ici = dcn = None
        if ici is not None:
            telemetry.comm_links("grad_sync", ici, dcn)
    telemetry.note("grad_sync_steps")


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
