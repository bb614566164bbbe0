"""Optimizer package (counterpart of ``mxnet_tpu/optimizer``)."""
from .optimizer import (Optimizer, SGD, Signum, FTML, DCASGD, NAG, SGLD,
                        Adam, AdaGrad, AdaDelta, RMSProp, Ftrl, Adamax,
                        Nadam, LBSGD, Test, Updater, get_updater, register,
                        create)

opt_registry_create = create

__all__ = ["Optimizer", "SGD", "Signum", "FTML", "DCASGD", "NAG", "SGLD",
           "Adam", "AdaGrad", "AdaDelta", "RMSProp", "Ftrl", "Adamax",
           "Nadam", "LBSGD", "Test", "Updater", "get_updater", "register",
           "create", "opt_registry_create"]
