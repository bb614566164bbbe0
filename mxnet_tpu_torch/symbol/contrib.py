"""``mx.sym.contrib`` (counterpart of ``mxnet_tpu/symbol/contrib.py``):
the ``_contrib_*`` ops under their short names. The symbolic
``foreach``, ``while_loop`` and ``cond`` build ``_foreach``,
``_while_loop`` and ``_cond`` nodes, whose ops come with ROADMAP queue A
item 13's control-flow part (order step 8): until then they raise."""
from __future__ import annotations

__all__ = ["foreach", "while_loop", "cond"]


def _control_flow(name):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            "sym.contrib.%s needs the _%s op (control_flow.py), not "
            "ported yet (ROADMAP queue A item 13, order step 8); the "
            "imperative nd.contrib.%s runs now" % (name, name, name))
    stub.__name__ = name
    return stub


foreach = _control_flow("foreach")
while_loop = _control_flow("while_loop")
cond = _control_flow("cond")


def _install():
    from ..ndarray.contrib import install_contrib_ops
    from . import register as _register
    install_contrib_ops(globals(), _register.make_stub)


_install()
