"""Registered operators (counterpart of ``mxnet_tpu/ops``): every op of
the JAX package's elemwise, reduce, matrix, indexing, init, nn, linalg,
attention, optimizer, RNN, random and quantization modules, its
``extra`` module without the image and spatial ops, and ``cast_storage``
of its ``deformable`` module, and its ``control_flow`` module (``_foreach``,
``_while_loop``, ``_cond``); ``Custom`` is registered by
``mxnet_tpu_torch.operator``; ``ROADMAP.md`` queue A lists the rest with
the step that brings each."""
from .registry import (OpDef, register, get_op, find_op, list_ops, invoke,
                       normalize_attrs)
from . import (elemwise, matrix, reduce, nn, indexing, attention,  # noqa: F401
               optimizer_ops, init_ops, rnn_op, random_ops, linalg, extra,
               deformable, quantization, control_flow)

__all__ = ["OpDef", "register", "get_op", "find_op", "list_ops", "invoke",
           "normalize_attrs"]
