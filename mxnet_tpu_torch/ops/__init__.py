"""Registered operators (counterpart of ``mxnet_tpu/ops``), limited to
what the ported paths reach; ``ROADMAP.md`` queue A lists the rest."""
from .registry import (OpDef, register, get_op, find_op, list_ops, invoke,
                       normalize_attrs)
from . import (elemwise, matrix, reduce, nn, indexing, attention,  # noqa: F401
               optimizer_ops, init_ops, rnn_op, random_ops)

__all__ = ["OpDef", "register", "get_op", "find_op", "list_ops", "invoke",
           "normalize_attrs"]
