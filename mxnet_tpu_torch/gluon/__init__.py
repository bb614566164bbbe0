"""Gluon (counterpart of ``mxnet_tpu/gluon``): blocks, parameters, the
layers, losses and Trainer, ``SymbolBlock`` and the model zoo."""
from .parameter import Parameter, ParameterDict, DeferredInitializationError
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import loss
from . import contrib
from . import convert
from . import model_zoo

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError",
           "Block", "HybridBlock", "SymbolBlock", "Trainer", "nn", "loss",
           "contrib", "convert", "model_zoo"]
