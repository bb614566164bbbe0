"""Registered operators (counterpart of ``mxnet_tpu/ops``): every op of
the JAX package's elemwise, reduce, matrix, indexing, init, nn, linalg,
attention, optimizer, RNN, random, quantization, extra, detection,
deformable, dgl and control-flow modules (``_foreach``, ``_while_loop``,
``_cond``); with ``Custom``, which ``mxnet_tpu_torch.operator``
registers, all 382 of its op names."""
from .registry import (OpDef, register, get_op, find_op, list_ops, invoke,
                       normalize_attrs)
from . import (elemwise, matrix, reduce, nn, indexing, attention,  # noqa: F401
               optimizer_ops, init_ops, rnn_op, random_ops, linalg, extra,
               detection, deformable, dgl, quantization, control_flow)

__all__ = ["OpDef", "register", "get_op", "find_op", "list_ops", "invoke",
           "normalize_attrs"]
