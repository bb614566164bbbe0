"""Gluon contrib (counterpart of ``mxnet_tpu/gluon/contrib``)."""
from . import nn   # noqa: F401
from . import rnn  # noqa: F401
