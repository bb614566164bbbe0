"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``)."""
from . import vision
from .vision import get_model
