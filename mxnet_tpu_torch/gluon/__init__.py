"""Gluon (counterpart of ``mxnet_tpu/gluon``): blocks, parameters, the
layers, the recurrent cells and layers (``rnn``), losses and Trainer,
``SymbolBlock``, the model zoo and ``data`` (datasets, samplers, the
DataLoader, vision transforms)."""
from .parameter import Parameter, ParameterDict, DeferredInitializationError
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import rnn
from . import loss
from . import contrib
from . import convert
from . import model_zoo
from . import data

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError",
           "Block", "HybridBlock", "SymbolBlock", "Trainer", "nn", "rnn", "loss",
           "contrib", "convert", "model_zoo", "data"]
