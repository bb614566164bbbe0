"""Gluon contrib (counterpart of ``mxnet_tpu/gluon/contrib``)."""
from . import nn  # noqa: F401
