"""Tensor-creation operators (counterpart of
``mxnet_tpu/ops/init_ops.py``): ``_zeros``, ``_ones``, ``_full``,
``_arange``, ``_linspace``, ``_eye`` and ``_contrib_arange_like``.

An op with no input has no tensor to take its device from: it lands on
the ``ctx`` attribute's device, else the current context's
(``gpu(0)`` unless the caller asks for the CPU). ``_arange`` fills its
float32 values as numpy's ``arange`` (which ``jnp.arange`` calls for
static bounds) does: the first two values, then ``start + i * delta``
with ``delta`` their float32 difference.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .registry import register

def _device(attrs):
    from ..context import as_context, current_context
    ctx = attrs.get("ctx")
    return (as_context(ctx) if ctx else current_context()).torch_device()


def _dtype(attrs):
    from ..ndarray.ndarray import torch_dtype
    return torch_dtype(attrs.get("dtype") or "float32")


def _shape(attrs):
    return tuple(attrs.get("shape", ()))


register("_zeros", lambda attrs: torch.zeros(
    _shape(attrs), dtype=_dtype(attrs), device=_device(attrs)),
    arg_names=(), defaults={"shape": (), "dtype": "float32", "ctx": None})
register("_ones", lambda attrs: torch.ones(
    _shape(attrs), dtype=_dtype(attrs), device=_device(attrs)),
    arg_names=(), defaults={"shape": (), "dtype": "float32", "ctx": None})
register("_full", lambda attrs: torch.full(
    _shape(attrs), attrs.get("value", 0.0), dtype=_dtype(attrs),
    device=_device(attrs)),
    arg_names=(), defaults={"shape": (), "value": 0.0, "dtype": "float32",
                            "ctx": None})


def _float_arange(start, stop, step, device):
    """numpy's float32 ``arange(start, stop, step)``, on ``device``."""
    n = max(int(math.ceil((stop - start) / step)), 0)
    b0, b1 = np.float32(start), np.float32(start + step)
    delta = float(np.float32(b1 - b0))
    i = torch.arange(n, dtype=torch.float32, device=device)
    out = i * delta + float(b0)
    return torch.where(i == 1, torch.full((), float(b1), device=device), out)


def _arange(attrs):
    start = float(attrs.get("start", 0.0))
    stop = attrs.get("stop", None)
    step = float(attrs.get("step", 1.0))
    if stop is None:
        start, stop = 0.0, start
    out = _float_arange(start, float(stop), step, _device(attrs))
    repeat = int(attrs.get("repeat", 1))
    if repeat > 1:
        out = torch.repeat_interleave(out, repeat)
    return out.to(_dtype(attrs))


register("_arange", _arange, arg_names=(),
         defaults={"start": 0.0, "stop": None, "step": 1.0, "repeat": 1,
                   "infer_range": False, "dtype": "float32", "ctx": None})


def _linspace(attrs):
    """``jnp.linspace``'s float32 arithmetic: start * (1 - s) + stop * s
    at s = i / div, the endpoint appended exactly (floored for an
    integer dtype)."""
    num = int(attrs.get("num", 50))
    endpoint = bool(attrs.get("endpoint", True))
    dev = _device(attrs)
    start = torch.full((), float(attrs.get("start", 0.0)), device=dev)
    stop = torch.full((), float(attrs.get("stop", 1.0)), device=dev)
    div = num - 1 if endpoint else num
    if num > 1:
        step = torch.arange(div, dtype=torch.float32, device=dev) / div
        out = start * (1 - step) + stop * step
        if endpoint:
            out = torch.cat([out, stop.reshape(1)])
    else:
        out = start.reshape(1)[:num]
    dtype = _dtype(attrs)
    if not dtype.is_floating_point:
        out = torch.floor(out)
    return out.to(dtype)


register("_linspace", _linspace, arg_names=(),
         defaults={"start": 0.0, "stop": 1.0, "num": 50, "endpoint": True,
                   "dtype": "float32", "ctx": None})


def _eye(attrs):
    n = int(attrs.get("N", 0))
    m = int(attrs.get("M", 0) or n)
    k = int(attrs.get("k", 0))
    rows = torch.arange(n, device=_device(attrs)).unsqueeze(1)
    cols = torch.arange(m, device=rows.device)
    return (cols - rows == k).to(_dtype(attrs))


register("_eye", _eye, arg_names=(),
         defaults={"N": 0, "M": 0, "k": 0, "dtype": "float32", "ctx": None})


def _arange_like(attrs, x):
    """``start + step * i`` over ``x``'s elements (its shape), or along
    ``axis`` (1-D), in ``x``'s dtype; ``repeat`` repeats each value.
    Along axis 1 under a mesh with an ``sp`` axis (``parallel.use_mesh``)
    ``i`` counts from this rank's first global position."""
    from ..parallel.mesh import sequence_offset
    axis = attrs.get("axis", None)
    start, step = float(attrs.get("start", 0.0)), float(attrs.get("step", 1.0))
    n = x.numel() if axis is None else x.shape[int(axis)]
    # under a sequence-parallel mesh dim 1 is this rank's slice of the
    # sequence: its positions are the global ones
    first = sequence_offset(n) if axis is not None and int(axis) == 1 \
        else 0
    out = start + step * torch.arange(first, first + n, dtype=x.dtype,
                                      device=x.device)
    if axis is None:
        out = out.reshape(x.shape)
    repeat = int(attrs.get("repeat", 1))
    if repeat > 1:
        out = torch.repeat_interleave(out.reshape(-1), repeat)
    return out


register("_contrib_arange_like", _arange_like, arg_names=("data",),
         defaults={"start": 0.0, "step": 1.0, "repeat": 1, "axis": None})
