"""Contrib nn layers (counterpart of ``mxnet_tpu/gluon/contrib/nn``)."""
from .basic_layers import Concurrent, HybridConcurrent, Identity
from .attention import MeshMultiHeadAttention

__all__ = ["Concurrent", "HybridConcurrent", "Identity",
           "MeshMultiHeadAttention"]
