"""Contrib nn layers (counterpart of ``mxnet_tpu/gluon/contrib/nn``)."""
from .attention import MeshMultiHeadAttention

__all__ = ["MeshMultiHeadAttention"]
