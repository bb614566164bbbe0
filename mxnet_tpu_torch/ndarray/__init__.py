"""NDArray namespace (``mx.nd``): the array type, its creation and
elementwise functions, one generated function per registered op
(``nd.FullyConnected``, ``nd.topk``, ...; the same stubs in ``nd.op``),
the sampling functions (``nd.random``) and ``nd.contrib`` (the
``_contrib_*`` ops by their short names, ``foreach``, ``while_loop`` and
``cond``)."""
from .ndarray import (NDArray, invoke_nd, array, zeros, ones, full, empty,
                      arange, linspace, eye, moveaxis, concatenate, save,
                      load, waitall, add, subtract, multiply, divide, modulo,
                      power, maximum, minimum, hypot, equal, not_equal,
                      greater, greater_equal, lesser, lesser_equal,
                      logical_and, logical_or, logical_xor, true_divide)
from .register import install_ops as _install_ops

_install_ops(globals())

import types as _types  # noqa: E402

op = _types.ModuleType(__name__ + ".op")
_install_ops(op.__dict__)

from . import random  # noqa: E402
from . import contrib  # noqa: E402
