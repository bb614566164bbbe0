"""Contrib nn layers (counterpart of ``mxnet_tpu/gluon/contrib/nn``)."""
from .basic_layers import (Concurrent, HybridConcurrent, Identity,
                           SparseEmbedding, SyncBatchNorm, PixelShuffle1D,
                           PixelShuffle2D, PixelShuffle3D)
from .attention import MeshMultiHeadAttention

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D", "PixelShuffle3D",
           "MeshMultiHeadAttention"]
