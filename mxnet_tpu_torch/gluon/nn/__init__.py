"""Gluon nn namespace (counterpart of ``mxnet_tpu/gluon/nn``), limited to
the layers the slice's training loop uses."""
from .basic_layers import (Sequential, HybridSequential, Dense, Embedding,
                           LayerNorm, Activation)

__all__ = ["Sequential", "HybridSequential", "Dense", "Embedding",
           "LayerNorm", "Activation"]
