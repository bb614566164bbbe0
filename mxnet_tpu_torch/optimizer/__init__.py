"""Optimizer package (counterpart of ``mxnet_tpu/optimizer``)."""
from .optimizer import (Optimizer, SGD, Adam, Updater, get_updater,
                        register, create)

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater",
           "register", "create"]
