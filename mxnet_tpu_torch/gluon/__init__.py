"""Gluon (counterpart of ``mxnet_tpu/gluon``): blocks, parameters and
constants, the layers, the recurrent cells and layers (``rnn``), losses
and Trainer, ``SymbolBlock``, the model zoo, ``data`` (datasets,
samplers, the DataLoader, vision transforms) and ``utils``."""
from .parameter import (Parameter, Constant, ParameterDict,
                        DeferredInitializationError)
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import rnn
from . import loss
from . import contrib
from . import convert
from . import model_zoo
from . import data
from . import utils
from .utils import split_data, split_and_load, clip_global_norm

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "Block", "HybridBlock",
           "SymbolBlock", "Trainer", "nn", "rnn", "loss", "contrib",
           "convert", "model_zoo", "data", "utils", "split_data",
           "split_and_load", "clip_global_norm"]
