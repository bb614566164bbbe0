"""Symbol namespace (``mx.sym``): the graph IR, its constructors and one
generated function per registered op (``sym.Convolution``, ...) and the
sampling functions (``sym.random``)."""
from .symbol import (Symbol, var, Variable, Group, load, load_json, create,
                     zeros)
from .register import install_ops as _install_ops

_install_ops(globals())
from . import random  # noqa: E402
