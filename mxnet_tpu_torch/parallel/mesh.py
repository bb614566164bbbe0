"""The rank mesh (counterpart of ``mxnet_tpu/parallel/mesh.py``).

The JAX package runs one controller over N devices: its mesh is a
``jax.sharding.Mesh``. PyTorch runs one process per device, so the
port's :class:`Mesh` names axes over the RANKS of the process group
(``parallel.distributed``):

- ``dp`` — data parallel (each rank takes its rows of the batch);
- ``fsdp`` / ``data`` / ``tp`` — the sharding-rules layer's axes
  (:func:`make_mesh`);
- ``sp`` — sequence parallel (ring attention / Ulysses): each rank holds
  its slice of dim 1 (:func:`sequence_offset` places it);
- ``pp`` — pipeline stages (``pipeline.pipeline_apply``); ``ep`` — the
  experts of ``moe.moe_ffn`` (often riding ``tp``).

**Rank order.** Ranks follow JAX's device order, row-major over the axes:
rank ``r`` sits where JAX's device ``r`` sits in a mesh of the same
sizes, so rank ``r`` holds the shard JAX's device ``r`` holds.
**Size rules.** A mesh whose size is not the world size raises, naming
the launcher; on a world of 1 every axis has size 1 and the callers run
their single-device path. Each axis gets one ``torch.distributed``
group per slice (``dist.new_group``, made by every rank in the same
order when the mesh is built); a rank's collectives over an axis run in
the group of its own slice.

:class:`PartitionSpec`, :class:`NamedSharding` and :class:`ShardedTensor`
are the port's forms of JAX's placement types: a spec names the mesh
axes each dim is split over, a sharding binds it to a mesh, and a
sharded tensor is one rank's piece of a global array with the global
shape beside it.

**Inside one process.** :class:`DeviceMesh` is the JAX package's mesh
over a context list whose contexts resolve to distinct torch devices
(``[gpu(0), cpu(0)]`` on the card, ``[gpu(0), gpu(1)]`` on a host with
two): one ``dp`` axis over those devices, in the list's order.
:func:`dp_mesh` gives it for a tuple of ``torch.device`` s
(:func:`distinct_devices` of the contexts; contexts that resolve to one
device act as one and make no mesh). A :class:`MeshTensor` is one
logical array over it: split along one axis, one shard a device in mesh
order, or replicated (then it holds one tensor, on the first device).
A shard is known by its POSITION in the mesh, never by its tensor's
``device`` (on the host, ``cpu:1`` tensors report ``cpu``). The
ops run on it shard by shard where that is what one device computes
on the whole (``ops.registry``'s mesh rules), so the gradient of a
shard's loss reaches a parameter through the copy each shard takes of
it, and torch autograd adds the shards' contributions into the one
master gradient: the in-process all-reduce.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "create_mesh", "auto_mesh", "make_mesh", "mesh_axes",
           "local_mesh", "PartitionSpec", "NamedSharding", "ShardedTensor",
           "replicated", "shard_batch", "dp_mesh", "distinct_devices",
           "DeviceMesh", "MeshTensor", "is_split", "context_mesh",
           "use_mesh", "current_mesh", "set_current_mesh",
           "axis_hosts", "link_split", "data_axis", "sequence_offset"]

_LAUNCH = "python -m mxnet_tpu_torch.tools.launch -n %d"
_DP_MESH_CACHE = {}
_CURRENT_MESH = [None]


def set_current_mesh(mesh):
    """Install ``mesh`` as the process-wide active mesh; returns the
    previous one. Ops that use mesh axes consult it: the sequence-
    parallel impls of ``_contrib_flash_attention`` (``sp``) and
    BatchNorm's global-batch statistics (``dp``)."""
    prev = _CURRENT_MESH[0]
    _CURRENT_MESH[0] = mesh
    return prev


def current_mesh():
    return _CURRENT_MESH[0]


class use_mesh:
    """``with use_mesh(mesh): ...`` scoped :func:`set_current_mesh`."""

    def __init__(self, mesh):
        self._mesh = mesh
        self._prev = None

    def __enter__(self):
        self._prev = set_current_mesh(self._mesh)
        return self._mesh

    def __exit__(self, *exc):
        set_current_mesh(self._prev)


class Mesh:
    """Named axes over the ranks of the process group.

    ``devices`` is the array of rank ids shaped by the axis sizes (row-
    major over ``axis_names``); ``shape`` maps each name to its size.
    :meth:`group` returns the ``torch.distributed`` group of this rank's
    slice along an axis (None on an axis of size 1) and its member
    ranks in axis order."""

    def __init__(self, axis_sizes, ranks=None):
        from . import distributed
        names = [str(n) for n in axis_sizes]
        sizes = [int(axis_sizes[n]) for n in axis_sizes]
        world, me = distributed.num_workers(), distributed.rank()
        total = int(np.prod(sizes)) if sizes else 1
        ranks = list(range(world)) if ranks is None \
            else [int(r) for r in ranks]
        if total != len(ranks):
            raise ValueError("mesh axes %s product %d != device count %d"
                             % (dict(axis_sizes), total, len(ranks)))
        if sorted(ranks) != list(range(world)):
            raise ValueError(
                "mesh axes %s: a mesh spans every rank of the process "
                "group (world size %d); launch %d ranks with %s"
                % (dict(axis_sizes), world, total, _LAUNCH % total))
        self.axis_names = tuple(names)
        self.devices = np.asarray(ranks, dtype=np.int64).reshape(sizes)
        self.shape = OrderedDict(zip(names, sizes))
        self.size = total
        self.rank = me
        where = np.argwhere(self.devices == me)[0]
        self._coords = {n: int(c) for n, c in zip(names, where)}
        self._groups = {}
        import torch.distributed as dist
        for k, name in enumerate(names):
            rows = np.moveaxis(self.devices, k, -1).reshape(-1, sizes[k])
            for row in rows:
                row = [int(r) for r in row]
                # every rank makes every group, in one order
                group = dist.new_group(row) \
                    if world > 1 and sizes[k] > 1 else None
                if me in row:
                    self._groups[name] = (group, row)

    def __repr__(self):
        return "Mesh(%s, rank=%d)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()), self.rank)

    def axis_size(self, axis):
        if axis not in self.shape:
            raise ValueError("mesh has no axis %r (axes: %s)"
                             % (axis, list(self.axis_names)))
        return self.shape[axis]

    def axis_index(self, axis):
        """This rank's coordinate along ``axis``."""
        self.axis_size(axis)
        return self._coords[axis]

    def group(self, axis):
        """``(group, ranks)`` of this rank's slice along ``axis``."""
        self.axis_size(axis)
        return self._groups[axis]

    def peer(self, axis, index):
        """The global rank at ``index`` along ``axis`` in this rank's
        slice."""
        return self.group(axis)[1][int(index) % self.axis_size(axis)]


def sequence_offset(local_len):
    """The global position of this rank's first element along the
    sequence dim, whose local length is ``local_len``: ``index * local_
    len`` on the active mesh's ``sp`` axis, 0 without one (or at size
    1). The ring/Ulysses convention: rank ``i`` of the axis holds the
    ``i``-th slice."""
    mesh = current_mesh()
    if mesh is None or "sp" not in mesh.axis_names \
            or mesh.axis_size("sp") == 1:
        return 0
    return mesh.axis_index("sp") * int(local_len)


def data_axis(mesh):
    """The batch axis of ``mesh``: ``dp``, else ``data``; None when it
    has neither."""
    for name in ("dp", "data"):
        if mesh is not None and name in mesh.axis_names:
            return name
    return None


def dp_mesh(devices):
    """The shared 1-axis ``dp`` mesh over an ordered device tuple, cached
    so every caller of one list agrees on one mesh: a
    :class:`DeviceMesh` over ``torch.device`` s (inside one process), a
    rank :class:`Mesh` over rank ids."""
    key = tuple(devices)
    mesh = _DP_MESH_CACHE.get(key)
    if mesh is None:
        if key and all(isinstance(d, torch.device) for d in key):
            mesh = DeviceMesh(key)
        else:
            mesh = create_mesh({"dp": len(key)}, devices=list(key))
        _DP_MESH_CACHE[key] = mesh
    return mesh


def distinct_devices(ctx_list):
    """The contexts' torch devices, duplicates dropped, order kept. A
    gpu context raises where its CUDA device is not visible."""
    from ..context import as_context
    devices = []
    for ctx in ctx_list:
        dev = as_context(ctx).torch_device()
        if dev not in devices:
            devices.append(dev)
    return devices


def context_mesh(ctx_list):
    """The :class:`DeviceMesh` of a context list, None when its contexts
    resolve to one torch device."""
    if ctx_list is None or len(ctx_list) < 2:
        return None
    devices = distinct_devices(ctx_list)
    return dp_mesh(devices) if len(devices) > 1 else None


class DeviceMesh:
    """The ``dp`` axis over distinct torch devices of one process (the
    JAX package's mesh over a context list). ``devices`` holds them in
    mesh order; the first holds a parameter's master and every
    replicated or gathered value."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        self.size = len(self.devices)

    def __repr__(self):
        return "DeviceMesh(dp=%s)" % ", ".join(map(str, self.devices))

    def split(self, tensor, axis):
        """``tensor`` (any device) split along ``axis`` over the mesh;
        differentiable."""
        from .collectives import device_scatter
        axis = int(axis) % tensor.dim()
        return MeshTensor(device_scatter(tensor, self.devices, axis), self,
                          axis)

    def replicate(self, tensor):
        """``tensor`` as one replicated value (held on the first
        device)."""
        return MeshTensor([tensor.to(self.devices[0])], self, None)


class MeshTensor:
    """One logical array over a :class:`DeviceMesh`: ``shards[k]`` on
    ``mesh.devices[k]`` split along ``axis``, or (``axis`` None) one
    replicated value held on the first device. Its shape is the global
    one."""

    __slots__ = ("shards", "mesh", "axis")

    def __init__(self, shards, mesh, axis):
        self.shards = list(shards)
        self.mesh = mesh
        self.axis = axis

    def __repr__(self):
        return "MeshTensor(shape=%s, axis=%s, %r)" % (self.shape, self.axis,
                                                       self.mesh)

    @property
    def shape(self):
        shape = list(self.shards[0].shape)
        if self.axis is not None:
            shape[self.axis] = sum(s.shape[self.axis] for s in self.shards)
        return tuple(shape)

    def dim(self):
        return self.shards[0].dim()

    def numel(self):
        return sum(s.numel() for s in self.shards)

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def device(self):
        """The first device: where the value gathers."""
        return self.mesh.devices[0]

    @property
    def requires_grad(self):
        return any(s.requires_grad for s in self.shards)

    def full(self):
        """The whole value on the first device (differentiable)."""
        if self.axis is None:
            return self.shards[0]
        from .collectives import device_gather
        return device_gather(self.shards, self.device, self.axis)

    def map(self, fn):
        """``fn`` of each shard, laid out as this one."""
        return MeshTensor([fn(s) for s in self.shards], self.mesh, self.axis)

    def detach(self):
        return self.map(lambda s: s.detach())

    def host(self):
        """The whole value as one host tensor (no copy through the first
        device)."""
        parts = [s.detach().to("cpu") for s in self.shards]
        return parts[0] if self.axis is None else torch.cat(parts, self.axis)


def is_split(value):
    """Whether ``value`` is a :class:`MeshTensor` split over its mesh."""
    return type(value) is MeshTensor and value.axis is not None


class PartitionSpec(tuple):
    """The mesh axes each dim is split over (None: whole); an entry may
    be a tuple of axes (split over their product, row-major)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


def _dim_split(mesh, entry, coords=None):
    """``(pieces, index)`` of one spec entry at ``coords`` (an ``{axis:
    index}`` map; this rank's by default)."""
    if entry is None:
        return 1, 0
    n, idx = 1, 0
    for a in entry if isinstance(entry, tuple) else (entry,):
        size = mesh.axis_size(a)
        idx = idx * size + (mesh.axis_index(a) if coords is None
                            else coords[a])
        n *= size
    return n, idx


class NamedSharding:
    """A :class:`PartitionSpec` bound to a mesh: :meth:`shard` cuts a
    global value down to this rank's piece, :meth:`place` wraps that
    piece as a :class:`ShardedTensor`."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, PartitionSpec) \
            else PartitionSpec(*spec)

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)

    def __eq__(self, other):
        return isinstance(other, NamedSharding) \
            and other.mesh is self.mesh and other.spec == self.spec

    def __hash__(self):
        return hash((id(self.mesh), self.spec))

    def index(self, shape, coords=None):
        """``[(start, stop), ...]`` of the piece held at ``coords`` (an
        ``{axis: index}`` map; this rank's by default)."""
        out = []
        for d, size in enumerate(shape):
            entry = self.spec[d] if d < len(self.spec) else None
            n, idx = _dim_split(self.mesh, entry, coords)
            if size % n:
                raise ValueError(
                    "dim %d of size %d does not split over %s (%d pieces)"
                    % (d, size, entry, n))
            step = size // n
            out.append((idx * step, (idx + 1) * step))
        return out

    def shard(self, value):
        """This rank's piece of the global ``value``."""
        ix = self.index(tuple(value.shape))
        return value[tuple(slice(a, b) for a, b in ix)]

    def place(self, value):
        return ShardedTensor(self.shard(value), tuple(value.shape), self)

    @property
    def is_fully_replicated(self):
        return all(_dim_split(self.mesh, e)[0] == 1 for e in self.spec)


class ShardedTensor:
    """One rank's piece (``local``) of a global array of ``shape`` laid
    out by ``sharding``: the port's counterpart of a sharded
    ``jax.Array`` (a replicated one holds the whole value)."""

    __slots__ = ("local", "shape", "sharding")

    def __init__(self, local, shape, sharding):
        self.local = local
        self.shape = tuple(int(s) for s in shape)
        self.sharding = sharding

    def __repr__(self):
        return "ShardedTensor(shape=%s, local=%s, spec=%r)" % (
            self.shape, tuple(self.local.shape), self.sharding.spec)

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def is_fully_replicated(self):
        return tuple(self.local.shape) == self.shape

    @property
    def index(self):
        return self.sharding.index(self.shape)

    def pieces(self):
        """``[(rank, [(start, stop), ...]), ...]`` for every rank of the
        mesh, in rank order: the layout a checkpoint manifest records."""
        mesh = self.sharding.mesh
        out = []
        for pos in np.ndindex(*mesh.devices.shape):
            coords = dict(zip(mesh.axis_names, pos))
            out.append((int(mesh.devices[pos]),
                        self.sharding.index(self.shape, coords)))
        return out

    def full(self):
        """The whole value on every rank (an all-gather per sharded dim,
        over the dim's axes from the innermost out)."""
        from .collectives import all_gather
        out = self.local
        spec = self.sharding.spec
        for d in range(len(spec)):
            entry = spec[d]
            if entry is None:
                continue
            for a in reversed(entry if isinstance(entry, tuple)
                              else (entry,)):
                if self.sharding.mesh.axis_size(a) == 1:
                    continue
                moved = out.movedim(d, 0).contiguous()
                gathered = all_gather(moved, self.sharding.mesh, a,
                                      account=False)
                out = gathered.movedim(0, d)
        return out


def create_mesh(axis_sizes: Dict[str, int], devices=None):
    """A :class:`Mesh` from ``{'dp': 2, 'sp': 2, ...}`` (axis order is the
    dict order) over the ranks ``devices`` (every rank, in rank order,
    by default). The product must equal the world size."""
    from . import distributed
    world = distributed.num_workers()
    total = int(np.prod([int(v) for v in axis_sizes.values()])) \
        if axis_sizes else 1
    if devices is None and total != world:
        raise ValueError(
            "mesh axes %s need %d ranks but the world has %d: launch them "
            "with %s" % (dict(axis_sizes), total, world, _LAUNCH % total))
    return Mesh(axis_sizes, ranks=devices)


def auto_mesh(n_devices: Optional[int] = None,
              prefer: Sequence[str] = ("dp", "tp", "sp")):
    """Factor the world size into a default mesh: factors of 2 to the
    trailing preferred axes first, the rest to the first."""
    from . import distributed
    n = n_devices if n_devices is not None else distributed.num_workers()
    sizes = {k: 1 for k in prefer}
    axes = list(prefer)
    i, rem = len(axes) - 1, n
    while i > 0 and rem % 2 == 0 and rem > 2:
        sizes[axes[i]] *= 2
        rem //= 2
        i -= 1
    sizes[axes[0]] = rem
    return create_mesh(sizes)


def make_mesh(data=None, fsdp=None, tp=None, devices=None, hosts=None):
    """The ``data`` x ``fsdp`` x ``tp`` mesh of the sharding-rules layer
    (data outermost). Sizes left None are 1, except ``data``, which takes
    the ranks that remain. ``hosts``, when given, must equal the number
    of processes the ranks span (each rank is a process) and the inner
    ``fsdp*tp`` block must divide the ranks of each."""
    from . import distributed
    ranks = list(devices) if devices is not None \
        else list(range(distributed.num_workers()))
    n = len(ranks)
    if hosts is not None:
        hosts = int(hosts)
        if hosts != n:
            raise ValueError(
                "make_mesh(hosts=%d): the %d available devices span %d "
                "process(es) — launch contract and topology disagree"
                % (hosts, n, n))
        inner_block = (int(fsdp) if fsdp else 1) * (int(tp) if tp else 1)
        if inner_block != 1:
            raise ValueError(
                "make_mesh(hosts=%d): fsdp*tp = %d does not divide the 1 "
                "device local to each process" % (hosts, inner_block))
    fsdp = int(fsdp) if fsdp is not None else 1
    tp = int(tp) if tp is not None else 1
    if fsdp < 1 or tp < 1:
        raise ValueError("make_mesh: axis sizes must be >= 1, got fsdp=%s "
                         "tp=%s" % (fsdp, tp))
    inner = fsdp * tp
    if data is None:
        if n % inner:
            raise ValueError("make_mesh: fsdp*tp = %d does not divide the "
                             "%d available devices" % (inner, n))
        data = n // inner
    data = int(data)
    if data < 1:
        raise ValueError("make_mesh: axis sizes must be >= 1, got data=%s"
                         % data)
    if data * inner > n:
        raise ValueError(
            "make_mesh: data=%d x fsdp=%d x tp=%d needs %d devices, only "
            "%d available" % (data, fsdp, tp, data * inner, n))
    return create_mesh({"data": data, "fsdp": fsdp, "tp": tp},
                       devices=ranks[:data * inner])


def local_mesh(axis_name="dp"):
    """A 1-axis mesh over every rank."""
    from . import distributed
    return create_mesh({axis_name: distributed.num_workers()})


def mesh_axes(mesh):
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def replicated(mesh):
    return NamedSharding(mesh, PartitionSpec())


def shard_batch(mesh, batch_axes=("dp",)):
    """The sharding of a batch: dim 0 split over ``batch_axes``."""
    return NamedSharding(mesh, PartitionSpec(tuple(batch_axes)))


def axis_hosts(mesh, axis):
    """``(group_size, hosts_per_group)`` of one axis: how many ranks a
    collective over ``axis`` spans and how many processes each of its
    groups touches. Every rank is its own process, so the two agree."""
    if axis not in mesh.axis_names:
        raise ValueError("mesh has no axis %r (axes: %s)"
                         % (axis, list(mesh.axis_names)))
    n = int(mesh.shape[axis])
    return n, n


def link_split(mesh, axis, nbytes):
    """Split one collective's payload into ``(ici_bytes, dcn_bytes)`` by
    the JAX package's hop model (``h - 1`` of the ``n - 1`` combine hops
    cross a process boundary). Every hop between ranks crosses one, so
    the port books the whole payload under ``dcn``, as
    ``telemetry.comm_links`` states."""
    n, h = axis_hosts(mesh, axis)
    if n <= 1:
        return 0, 0
    dcn = int(round(nbytes * max(h - 1, 0) / (n - 1)))
    return int(nbytes) - dcn, dcn
