"""Operator placement: ``ctx_group`` / ``group2ctx`` (counterpart of
``mxnet_tpu/placement.py``; the reference's ``AssignContext``,
graph_executor.cc:907, and bind's ``group2ctx``).

A symbol built under ``AttrScope(ctx_group="dev1")`` tags its nodes
with a group; ``bind(..., group2ctx={"dev1": cpu(0), "dev2": gpu(0)})``
runs each group on its device. :func:`op_contexts` gives each op of the
executor's plan the context of its group (a node of a group that
``group2ctx`` does not name runs on the bind's context), so the plan
falls into contiguous segments of ops on one device. The executor runs
the plan op by op: an input made on another device crosses with an
explicit ``.to(device)``, the copy the reference's ``_CrossDeviceCopy``
node made. Training goes through torch autograd across the segments: a
crossing's backward moves the gradient back to the producer's device.

At bind :func:`place` puts each argument, its gradient array and each
auxiliary state on the device of their first consumer, in place (the
NDArray objects keep their identity), so an argument's gradient lands
there, as in the JAX package, and the optimizer updates it there.

A grouped executor never replays a CUDA graph: a graph cannot hold the
segments on the host. Its predict runs are counted as ``grouped`` in
``Executor.stats()``. The conv-bias peephole is off for it (a conv and
its BatchNorm may sit on two devices).
"""
from __future__ import annotations

import torch

from .context import Context

__all__ = ["op_contexts", "place"]


def op_contexts(plan_nodes, group2ctx, default_ctx):
    """The context of each op of the plan, or ``None`` (placement off)
    when ``group2ctx`` names no group that a node of the plan has. A
    list of contexts for one group (one per data-parallel replica in
    the reference) takes the first."""
    table = {}
    for group, ctx in (group2ctx or {}).items():
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        table[group] = ctx if isinstance(ctx, Context) else Context(ctx)
    groups = [n._extra_attrs.get("ctx_group") for n in plan_nodes]
    if not any(g in table for g in groups):
        return None
    return [table.get(g, default_ctx) for g in groups]


def place(plan, op_devices, arg_arrays, grad_arrays, aux_arrays):
    """Move each argument, its gradient array and each auxiliary state
    onto the ``torch.device`` of its first consumer in ``plan``, in
    place."""
    first = {}
    for (_, _, bindings, _, _), dev in zip(plan, op_devices):
        for b in bindings:
            if b[0] in ("arg", "aux"):
                first.setdefault(b, dev)
    tables = {"arg": (arg_arrays, grad_arrays), "aux": (aux_arrays,)}
    with torch.no_grad():
        for (kind, i), dev in first.items():
            for arrays in tables[kind]:
                arr = arrays[i]
                if arr is not None and arr._data.device != dev:
                    arr._set_data(arr._data.to(dev))
