"""The optimizer-state pickle that crosses between the packages.

The JAX package's ``Updater.get_states`` pickles ``states`` or
``(states, optimizer)`` with its own classes: ``mxnet_tpu.optimizer
.optimizer.SGD`` and the like (their ``__dict__``), and NDArrays that
pickle as ``{"data": numpy, "ctx": str}``. Neither package imports the
other, so the classes are exchanged by NAME:

- :func:`loads` maps a global under ``mxnet_tpu.`` to the same path
  under ``mxnet_tpu_torch.`` when that is an NDArray, an optimizer or a
  learning-rate schedule; any other class of the JAX package (a Gluon
  ``Parameter`` in a Trainer's ``param_dict``, which both Trainers reset
  after loading) becomes an inert :class:`_Opaque`;
- :func:`dumps` writes the port's classes under their ``mxnet_tpu.``
  paths, and an optimizer's ``param_dict`` as ``{}``.

Protocol 2, so the globals are written as plain ``GLOBAL`` opcodes.
"""
from __future__ import annotations

import importlib
import io
import pickle

__all__ = ["dumps", "loads"]

_PORT, _JAX = "mxnet_tpu_torch", "mxnet_tpu"


class _Opaque:
    """A stand-in for a JAX-package object the port has no use for."""

    def __setstate__(self, state):
        self.__dict__["_state"] = state


def _port_class(module, name):
    from ..ndarray import NDArray
    from ..lr_scheduler import LRScheduler
    from .optimizer import Optimizer
    try:
        mod = importlib.import_module(_PORT + module[len(_JAX):])
        obj = getattr(mod, name)
    except (ImportError, AttributeError):
        return _Opaque
    if isinstance(obj, type) and issubclass(obj, (NDArray, Optimizer,
                                                  LRScheduler)):
        return obj
    return _Opaque


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == _JAX or module.startswith(_JAX + ".") \
                or module == _PORT or module.startswith(_PORT + "."):
            if module.startswith(_PORT):
                module = _JAX + module[len(_PORT):]
            return _port_class(module, name)
        return super().find_class(module, name)


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, with the port's globals written under
    the JAX package's module paths."""

    def save_global(self, obj, name=None):
        mod = getattr(obj, "__module__", None) or ""
        if mod == _PORT or mod.startswith(_PORT + "."):
            target = _JAX + mod[len(_PORT):]
            qual = name or obj.__qualname__
            self.write(pickle.GLOBAL + target.encode("utf-8") + b"\n"
                       + qual.encode("utf-8") + b"\n")
            self.memoize(obj)
            return
        super().save_global(obj, name)

    def reducer_override(self, obj):
        from .optimizer import Optimizer
        if isinstance(obj, Optimizer):
            import copyreg
            state = obj.__getstate__()
            state["param_dict"] = {}
            return copyreg.__newobj__, (type(obj),), state
        return NotImplemented


def dumps(obj):
    buf = io.BytesIO()
    _Pickler(buf, protocol=2).dump(obj)
    return buf.getvalue()


def loads(payload):
    return _Unpickler(io.BytesIO(payload)).load()
