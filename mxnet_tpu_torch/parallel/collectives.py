"""Collectives over the axes of a rank mesh (counterpart of
``mxnet_tpu/parallel/collectives.py``).

Each function is one rank's side of the collective: it takes this rank's
piece and returns this rank's result, in the group of its slice along
``axis`` (``Mesh.group``). On an axis of size 1 the input comes back as
it is. Shapes follow the JAX package's ``shard_map`` forms: the input of
:func:`all_reduce`/:func:`all_gather` is a shard, the input of
:func:`reduce_scatter` a whole contribution.

**Sums are deterministic.** :func:`reduce_scatter` (and the bucket forms
built on it) exchange the pieces with one all-to-all and add the ranks'
contributions in rank order on each rank, so a value's sum does not
depend on where it sits in the buffer: bucketed and monolithic exchanges
of one gradient agree bit for bit. It moves what a ring reduce-scatter
moves, ``(n - 1) / n`` of the buffer.

**The gloo staging rule.** Where the group's backend is ``gloo`` (ranks
that share a card, or the host) a CUDA tensor goes through a host copy
and back: gloo's collectives are host code. The staged bytes count in
``profiler.counters()['collective_staged_bytes']``. The rule is keyed on
``distributed.backend()``, not on a failed call.

Each eager call is accounted under comm kind ``collective`` keyed by its
name (bytes and caller-observed latency) and split by link
(``telemetry.comm_links``); the bucket forms are ``grad_sync`` spans.

**Under autograd.** The functions above carry no gradient. The model-
parallel code differentiates through the ``torch.autograd`` forms below,
each a pair of collectives (Megatron-LM's operators, Shoeybi et al.,
2019, and the JAX package's ``shard_map`` transposes):

- :func:`copy_to_axis` — identity forward, all-reduce backward: the
  entry of a computation split over ``axis`` whose input is replicated;
- :func:`reduce_from_axis` — all-reduce forward, identity backward: the
  exit of such a computation (partial sums to a replicated value);
- :func:`psum` — all-reduce both ways: a sum of the ranks' pieces whose
  every rank's loss reads it (the partial-loss convention of ``dp``);
- :func:`gather_from_axis` — all-gather along a dim; backward this
  rank's slice of the gradient (``grad="slice"``) or its reduce-scatter
  (``grad="sum"``);
- :func:`ppermute_grad` / :func:`all_to_all_grad` — the point-to-point
  ring and the all-to-all, backward along the reversed pairs / with
  split and concat swapped.

``axis`` may be a tuple of axes: the collective runs over each in turn
(the group of their product, in a fixed order).

**Inside one process** (the ``dp`` mesh over a context list,
``mesh.DeviceMesh``): :func:`device_scatter`, :func:`device_gather`,
:func:`device_sum` and :func:`device_reduce_scatter` take and return one
tensor a mesh position. They are plain torch copies and adds, so torch
autograd differentiates through them (a copy's gradient is a copy back,
a sum's a broadcast). Sums are taken in mesh position order on the
target device, whatever the layout.
"""
from __future__ import annotations

import torch

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "broadcast",
           "ppermute", "barrier", "psum_eager", "all_to_all",
           "bucket_reduce_scatter", "bucket_all_gather", "copy_to_axis",
           "reduce_from_axis", "psum", "gather_from_axis", "ppermute_grad",
           "all_to_all_grad", "device_scatter", "device_gather",
           "device_sum", "device_reduce_scatter"]


def _account_links(name, mesh, axis, value=None, nbytes=None):
    """Book one collective's bytes by link (``mesh.link_split``)."""
    from .. import telemetry
    if not telemetry.enabled():
        return
    if nbytes is None:
        nbytes = value.numel() * value.element_size() \
            if isinstance(value, torch.Tensor) else 0
    from .mesh import link_split
    try:
        ici, dcn = link_split(mesh, axis, nbytes)
    except ValueError:
        return
    telemetry.comm_links(name, ici, dcn)


def _stages(t):
    from . import distributed
    return t.is_cuda and distributed.backend() == "gloo"


def _to_wire(t):
    """``t`` where the group's backend can reach it: a host copy under
    the gloo staging rule (counted), else ``t``."""
    if _stages(t):
        from .. import profiler
        profiler.increment_counter("collective_staged_bytes",
                                   t.numel() * t.element_size())
        return t.cpu()
    return t


def _from_wire(t, like):
    if t.device != like.device:
        from .. import profiler
        profiler.increment_counter("collective_staged_bytes",
                                   t.numel() * t.element_size())
        return t.to(like.device)
    return t


def _unwrap(x):
    from ..ndarray import NDArray
    if isinstance(x, NDArray):
        return x._data, lambda t: NDArray(t)
    return x, lambda t: t


def _span(name, nbytes):
    from .. import telemetry
    return telemetry.comm_span("collective", name, nbytes=nbytes)


def _nbytes(t):
    return t.numel() * t.element_size()


def all_reduce(x, mesh, axis="dp", op="sum"):
    """Reduce the ranks' ``x`` along ``axis`` (``sum``/``max``/``mean``);
    every rank gets the reduced value. Visits the ``allreduce`` fault
    site under an active plan (``fault.guard``)."""
    import torch.distributed as dist
    from .. import fault
    if op not in ("sum", "max", "mean"):
        raise ValueError(op)
    t, wrap = _unwrap(x)
    group, ranks = mesh.group(axis)
    if len(ranks) == 1:
        return x

    def run():
        buf = _to_wire(t).clone()
        dist.all_reduce(buf, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=group)
        if op == "mean":
            buf = buf / len(ranks)
        return _from_wire(buf, t)

    _account_links("all_reduce", mesh, axis, t)
    with _span("all_reduce", _nbytes(t)):
        return wrap(fault.guard(run, "allreduce"))


def all_gather(x, mesh, axis="dp", tiled=True, account=True):
    """Every rank's ``x`` along ``axis``, in axis order: concatenated on
    dim 0 (``tiled``) or stacked on a new dim 0."""
    import torch.distributed as dist
    t, wrap = _unwrap(x)
    group, ranks = mesh.group(axis)
    if len(ranks) == 1:
        return wrap(t if tiled else t.unsqueeze(0))
    src = _to_wire(t.contiguous())
    out = torch.empty((len(ranks) * t.shape[0],) + tuple(t.shape[1:])
                      if t.dim() else (len(ranks),),
                      dtype=t.dtype, device=src.device)

    def run():
        dist.all_gather_into_tensor(out, src.reshape(-1) if not t.dim()
                                    else src, group=group)
        return _from_wire(out, t)

    if not account:
        res = run()
    else:
        _account_links("all_gather", mesh, axis, t)
        with _span("all_gather", _nbytes(t)):
            res = run()
    if not tiled:
        res = res.reshape((len(ranks),) + tuple(t.shape))
    return wrap(res)


def _sum_in_rank_order(blocks):
    acc = blocks[0].clone()
    for b in blocks[1:]:
        acc += b
    return acc


def _scatter_sum(flat, group, n):
    """This rank's ``1/n`` slice of the sum of every rank's ``flat`` (its
    length divides ``n``): one all-to-all, then the contributions added
    in rank order."""
    import torch.distributed as dist
    src = _to_wire(flat.contiguous())
    recv = torch.empty_like(src)
    dist.all_to_all_single(recv, src, group=group)
    return _from_wire(_sum_in_rank_order(recv.view(n, -1).unbind(0)), flat)


def reduce_scatter(x, mesh, axis="dp"):
    """Sum the ranks' whole contributions ``x`` and return this rank's
    rows of the sum (``ceil(d0 / n)`` a rank). A leading dim that does
    not divide the axis size is zero-padded through the collective and
    the pad rows are cut off the result, so the last ranks may hold
    fewer rows (the sum is unaffected: the pad adds exact zeros)."""
    t, wrap = _unwrap(x)
    group, ranks = mesh.group(axis)
    n = len(ranks)
    if n == 1:
        return x
    me = ranks.index(mesh.rank)
    d0 = int(t.shape[0]) if t.dim() else 1
    rows = -(-d0 // n)
    body = t.reshape((d0,) + tuple(t.shape[1:]))
    if rows * n != d0:
        body = torch.cat([body, body.new_zeros(
            (rows * n - d0,) + tuple(body.shape[1:]))])
    _account_links("reduce_scatter", mesh, axis, t)
    with _span("reduce_scatter", _nbytes(t)):
        mine = _scatter_sum(body.reshape(-1), group, n).view(
            (rows,) + tuple(body.shape[1:]))
    return wrap(mine[:max(0, min(rows, d0 - me * rows))])


def bucket_reduce_scatter(contribs, mesh, axis="dp", key="bucket"):
    """One collective for a whole gradient bucket: this rank's
    contributions (a list of same-dtype tensors) flattened, concatenated,
    zero-padded to a multiple of the axis size and reduce-scattered;
    returns this rank's ``padded / n`` slice of the summed flat bucket.
    One ``grad_sync`` comm span under ``key``."""
    from .. import telemetry
    group, ranks = mesh.group(axis)
    n = len(ranks)
    parts = [_unwrap(c)[0].reshape(-1) for c in contribs]
    flat, total = torch.cat(parts), sum(p.numel() for p in parts)
    pad = -(-total // n) * n - total
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    nbytes = (total + pad) * flat.element_size()
    _account_links("bucket_reduce_scatter", mesh, axis, nbytes=nbytes)
    with telemetry.comm_span("grad_sync", key, nbytes=nbytes):
        return flat if n == 1 else _scatter_sum(flat, group, n)


def bucket_all_gather(flat, mesh, axis="dp", key="bucket"):
    """Gather a reduce-scattered flat bucket back to the whole vector on
    every rank; one ``grad_sync`` comm span under ``key``."""
    from .. import telemetry
    t, wrap = _unwrap(flat)
    _account_links("bucket_all_gather", mesh, axis, t)
    with telemetry.comm_span("grad_sync", key, nbytes=_nbytes(t)):
        return wrap(all_gather(t, mesh, axis, account=False))


def all_to_all(x, mesh, axis, split_axis, concat_axis):
    """Split ``x`` into ``n`` chunks along ``split_axis``, send chunk
    ``j`` to the rank at index ``j`` of the axis, and concatenate the
    chunks received along ``concat_axis`` in axis order (JAX's tiled
    ``all_to_all``)."""
    import torch.distributed as dist
    t, wrap = _unwrap(x)
    group, ranks = mesh.group(axis)
    n = len(ranks)
    if n == 1:
        return x
    chunks = torch.stack(t.chunk(n, dim=split_axis))
    src = _to_wire(chunks.contiguous())
    recv = torch.empty_like(src)

    _account_links("all_to_all", mesh, axis, t)
    with _span("all_to_all", _nbytes(t)):
        dist.all_to_all_single(recv, src, group=group)
    return wrap(torch.cat(_from_wire(recv, t).unbind(0), dim=concat_axis))


def ppermute(x, mesh, axis, perm):
    """Send ``x`` along the ``(source, destination)`` pairs of ``perm``
    (axis indices): each rank returns what its source sent, zeros where
    no pair names it as a destination (JAX's ``ppermute``). One batch of
    point-to-point sends and receives."""
    import torch.distributed as dist
    t, wrap = _unwrap(x)
    group, ranks = mesh.group(axis)
    me = mesh.axis_index(axis)
    perm = [(int(s) % len(ranks), int(d) % len(ranks)) for s, d in perm]
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(ranks) == 1:
        return wrap(t.clone() if src else torch.zeros_like(t))
    wire = _to_wire(t.contiguous())
    recv = torch.zeros_like(wire)

    ops = [dist.P2POp(dist.isend, wire, ranks[d], group=group)
           for d in dst if d != me]
    ops += [dist.P2POp(dist.irecv, recv, ranks[s], group=group)
            for s in src if s != me]
    _account_links("ppermute", mesh, axis, t)
    with _span("ppermute", _nbytes(t)):
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    if me in src:
        recv.copy_(wire)
    return wrap(_from_wire(recv, t))


def broadcast(x, mesh, axis="dp", root=0):
    """The ``x`` of the rank at index ``root`` along ``axis``, on every
    rank of the slice."""
    import torch.distributed as dist
    t, wrap = _unwrap(x)
    group, ranks = mesh.group(axis)
    if len(ranks) == 1:
        return x
    buf = _to_wire(t).clone()
    _account_links("broadcast", mesh, axis, t)
    with _span("broadcast", _nbytes(t)):
        dist.broadcast(buf, src=ranks[int(root)], group=group)
    return wrap(_from_wire(buf, t))


def psum_eager(arrays):
    """Sum a list of same-shape arrays in list order (the one-process
    CommDevice Reduce role)."""
    out = arrays[0]
    for a in arrays[1:]:
        out = out + a
    return out


def barrier(name="barrier"):
    """A barrier over every rank (a no-op on a world of 1)."""
    from . import distributed
    if distributed.num_workers() > 1:
        with _span("barrier", 0):
            distributed.barrier(name)


# ---------------------------------------------------------------------------
# under autograd
# ---------------------------------------------------------------------------

def _axes(axis):
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _sum_over(t, mesh, axes):
    for a in axes:
        t = all_reduce(t, mesh, a)
    return t


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g.contiguous(), ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _sum_over(x.contiguous(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _sum_over(x.contiguous(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g.contiguous(), ctx.mesh, ctx.axes), None, None


def _gather_dim(t, mesh, axis, dim):
    moved = t.movedim(dim, 0).contiguous()
    return all_gather(moved, mesh, axis).movedim(0, dim)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, grad):
        ctx.args = (mesh, axes, dim, grad)
        for a in reversed(axes):
            x = _gather_dim(x, mesh, a, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, grad = ctx.args
        g = g.contiguous()
        for a in axes:
            if grad == "sum":
                g = reduce_scatter(g.movedim(dim, 0).contiguous(), mesh,
                                   a).movedim(0, dim)
            else:
                n, i = mesh.axis_size(a), mesh.axis_index(a)
                step = g.shape[dim] // n
                g = g.narrow(dim, i * step, step)
        return g.contiguous(), None, None, None, None


class _PPermute(torch.autograd.Function):
    """``ppermute`` whose backward sends the gradient back along the
    reversed pairs."""

    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.perm]
        return ppermute(g.contiguous(), ctx.mesh, ctx.axis, back), \
            None, None, None


class _AllToAll(torch.autograd.Function):
    """The tiled ``all_to_all``; its backward is the all-to-all with
    split and concat swapped."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.args = (mesh, axis, split_axis, concat_axis)
        return all_to_all(x, mesh, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_axis, concat_axis = ctx.args
        return all_to_all(g.contiguous(), mesh, axis, concat_axis,
                          split_axis), None, None, None, None


def _live(mesh, axis):
    """The axes of ``axis`` that ``mesh`` has with size > 1."""
    if mesh is None:
        return ()
    return tuple(a for a in _axes(axis)
                 if a in mesh.axis_names and mesh.axis_size(a) > 1)


def copy_to_axis(x, mesh, axis):
    """Identity forward; the gradient summed over ``axis`` backward."""
    axes = _live(mesh, axis)
    return _CopyTo.apply(x, mesh, axes) if axes else x


def reduce_from_axis(x, mesh, axis):
    """The ranks' ``x`` summed over ``axis`` forward; the gradient as it
    is backward (every rank holds the whole gradient of the sum)."""
    axes = _live(mesh, axis)
    return _ReduceFrom.apply(x, mesh, axes) if axes else x


def psum(x, mesh, axis):
    """The ranks' ``x`` summed over ``axis``, forward and backward (each
    rank holds a partial gradient of the sum)."""
    axes = _live(mesh, axis)
    return _PSum.apply(x, mesh, axes) if axes else x


def gather_from_axis(x, mesh, axis, dim=0, grad="slice"):
    """Every rank's ``x`` along ``axis``, concatenated on ``dim`` in axis
    order (a tuple of axes: row-major, the first outermost). Backward:
    this rank's slice of the gradient (``grad="slice"``: every rank holds
    the whole gradient) or of its sum over the axis (``grad="sum"``)."""
    if grad not in ("slice", "sum"):
        raise ValueError("gather_from_axis: grad is 'slice' or 'sum', "
                         "not %r" % (grad,))
    axes = _live(mesh, axis)
    return _GatherFrom.apply(x, mesh, axes, dim, grad) if axes else x


def ppermute_grad(x, mesh, axis, perm):
    """:func:`ppermute` under autograd."""
    return _PPermute.apply(x, mesh, axis, perm)


def all_to_all_grad(x, mesh, axis, split_axis, concat_axis):
    """:func:`all_to_all` under autograd."""
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


# ---------------------------------------------------------------------------
# inside one process: one tensor a mesh position
# ---------------------------------------------------------------------------

def device_scatter(x, devices, dim=0):
    """``x`` cut into ``len(devices)`` equal pieces along ``dim``, piece
    ``k`` on ``devices[k]`` (a view where it already lives there)."""
    n = len(devices)
    if x.shape[dim] % n:
        raise ValueError("dim %d of size %d does not split over %d devices"
                         % (dim, x.shape[dim], n))
    return [piece.to(dev) for piece, dev in
            zip(torch.split(x, x.shape[dim] // n, dim), devices)]


def device_gather(pieces, device, dim=0):
    """The pieces joined along ``dim`` on ``device``."""
    if len(pieces) == 1:
        return pieces[0].to(device)
    return torch.cat([p.to(device) for p in pieces], dim)


def device_sum(parts, device):
    """The sum of ``parts`` on ``device``, added in position order."""
    out = parts[0].to(device)
    for p in parts[1:]:
        out = out + p.to(device)
    return out


def device_reduce_scatter(parts, devices):
    """The sum of the flat contributions ``parts`` (each a length that
    divides over the devices; they may live anywhere), slice ``k`` of it
    on ``devices[k]``, each slice added in position order there."""
    n = len(devices)
    per = parts[0].numel() // n
    return [device_sum([p.reshape(-1)[k * per:(k + 1) * per]
                        for p in parts], dev)
            for k, dev in enumerate(devices)]
