"""Gluon nn namespace (counterpart of ``mxnet_tpu/gluon/nn``): the layers
of the Gluon training loop and of the model zoo's ResNets."""
from .basic_layers import (Sequential, HybridSequential, Dense, Embedding,
                           BatchNorm, LayerNorm, Flatten, Activation)
from .conv_layers import (Conv1D, Conv2D, Conv3D, MaxPool1D, MaxPool2D,
                          MaxPool3D, AvgPool1D, AvgPool2D, AvgPool3D,
                          GlobalMaxPool1D, GlobalMaxPool2D, GlobalMaxPool3D,
                          GlobalAvgPool1D, GlobalAvgPool2D, GlobalAvgPool3D)

__all__ = ["Sequential", "HybridSequential", "Dense", "Embedding",
           "BatchNorm", "LayerNorm", "Flatten", "Activation", "Conv1D",
           "Conv2D", "Conv3D", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D"]
