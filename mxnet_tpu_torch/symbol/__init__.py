"""Symbol namespace (``mx.sym``): the graph IR, its constructors, one
generated function per registered op (``sym.Convolution``,
``sym.batch_dot``, ...; the same stubs in ``sym.op``), the sampling
functions (``sym.random``) and ``sym.contrib`` (the ``_contrib_*`` ops
by their short names)."""
from .symbol import (Symbol, var, Variable, Group, load, load_json, create,
                     zeros, ones, full, arange, pow, maximum, minimum, hypot)
from .register import install_ops as _install_ops

_install_ops(globals())

import types as _types  # noqa: E402

op = _types.ModuleType(__name__ + ".op")
_install_ops(op.__dict__)

from . import random  # noqa: E402
from . import contrib  # noqa: E402
