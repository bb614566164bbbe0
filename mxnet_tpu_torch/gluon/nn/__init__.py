"""Gluon nn namespace (counterpart of ``mxnet_tpu/gluon/nn``): the layers
of the Gluon training loop and of the model zoo."""
from .basic_layers import (Sequential, HybridSequential, Dense, Dropout,
                           Embedding, BatchNorm, LayerNorm, Flatten,
                           Activation)
from .conv_layers import (Conv1D, Conv2D, Conv3D, Conv1DTranspose,
                          Conv2DTranspose, Conv3DTranspose, MaxPool1D,
                          MaxPool2D, MaxPool3D, AvgPool1D, AvgPool2D,
                          AvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, ReflectionPad2D)

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "Embedding", "BatchNorm", "LayerNorm", "Flatten", "Activation",
           "Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]
