"""NDArray namespace (``mx.nd``): the array type, its creation functions,
one generated function per registered op (``nd.FullyConnected``,
``nd._contrib_flash_attention``, ...) and the sampling functions
(``nd.random``)."""
from .ndarray import (NDArray, invoke_nd, array, zeros, ones, full,
                      concatenate, save, load)
from .register import install_ops as _install_ops

_install_ops(globals())
from . import random  # noqa: E402
