"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``)."""
from . import model_store
from . import vision
from .vision import get_model
