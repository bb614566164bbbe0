"""Gluon (counterpart of ``mxnet_tpu/gluon``): blocks, parameters, the
layers, losses and Trainer of the slice's training loop."""
from .parameter import Parameter, ParameterDict, DeferredInitializationError
from .block import Block, HybridBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import contrib
from . import convert

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError",
           "Block", "HybridBlock", "Trainer", "nn", "loss", "contrib",
           "convert"]
