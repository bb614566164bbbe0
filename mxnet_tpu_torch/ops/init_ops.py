"""Tensor-creation (nullary) operators (counterpart of
``mxnet_tpu/ops/init_ops.py``), as far as the RNN cells' begin states
reach them: ``_zeros``.

An op with no input has no tensor to take its device from: it lands on
the ``ctx`` attribute's device, else the current context's
(``gpu(0)`` unless the caller asks for the CPU).
"""
from __future__ import annotations

import torch

from .registry import register


def _zeros(attrs):
    from ..context import as_context, current_context
    from ..ndarray.ndarray import torch_dtype
    ctx = attrs.get("ctx")
    ctx = as_context(ctx) if ctx else current_context()
    return torch.zeros(tuple(attrs.get("shape", ())),
                       dtype=torch_dtype(attrs.get("dtype") or "float32"),
                       device=ctx.torch_device())


register("_zeros", _zeros, arg_names=(),
         defaults={"shape": (), "dtype": "float32", "ctx": None})
