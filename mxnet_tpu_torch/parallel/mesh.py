"""Contexts resolved to torch devices (the ``distinct_devices`` rule of
``mxnet_tpu/parallel/mesh.py``). Contexts that resolve to ONE torch
device act as one: ``[cpu(0), cpu(1)]`` on the host or ``[gpu(0),
gpu(0)]`` on the card bind a single executor, parameter or batch over
the whole batch, which is what the JAX package's mesh program computes.
Contexts on distinct devices form a data-parallel mesh, which is not
ported yet (ROADMAP queue A item 12, order step 6)."""
from __future__ import annotations

__all__ = ["distinct_devices", "one_device"]


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


def one_device(ctx_list, what):
    """The first of ``ctx_list`` when every context resolves to one torch
    device; contexts on distinct devices raise, naming the step that
    brings the mesh."""
    from ..context import as_context
    ctx_list = [as_context(c) for c in ctx_list]
    if len(set(ctx_list)) == 1:
        return ctx_list[0]
    devices = distinct_devices(ctx_list)
    if len(devices) > 1:
        raise NotImplementedError(
            "%s over contexts %s on %d distinct devices (%s) is a "
            "data-parallel mesh, not ported yet (ROADMAP queue A item 12, "
            "order step 6)" % (what, ", ".join(map(str, ctx_list)),
                               len(devices), ", ".join(map(str, devices))))
    return ctx_list[0]
