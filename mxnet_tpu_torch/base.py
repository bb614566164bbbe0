"""Base errors, registry and small helpers (counterpart of
``mxnet_tpu/base.py``)."""
from __future__ import annotations

import os
import threading

__all__ = ["MXNetError", "NotImplementedForSymbol", "get_env", "Registry",
           "string_types", "numeric_types", "integer_types",
           "classproperty", "atomic_write_bytes", "build_param_doc"]

string_types = (str,)
numeric_types = (float, int)
integer_types = (int,)


def atomic_write_bytes(fname, payload):
    """Write then rename: a preempted save leaves the old file intact,
    never a truncated new one (symbol JSON, ONNX files)."""
    tmp = fname + ".tmp"
    with open(tmp, "wb") as sink:
        sink.write(payload)
    os.replace(tmp, fname)


class MXNetError(RuntimeError):
    """Error raised by the framework (parity with mxnet.base.MXNetError)."""


class NotImplementedForSymbol(MXNetError):
    """A function that exists for NDArray and not for Symbol."""

    def __init__(self, function, alias, *args):
        super().__init__()
        self.function = function.__name__
        self.alias = alias
        self.args = [str(type(a)) for a in args]

    def __str__(self):
        msg = 'Function {}'.format(self.function)
        if self.alias:
            msg += ' (namely operator "{}")'.format(self.alias)
        if self.args:
            msg += ' with arguments ({})'.format(', '.join(self.args))
        msg += ' is not supported for Symbol and only available in NDArray.'
        return msg


_TRUE = ("1", "true", "True", "TRUE", "yes", "on")


def get_env(name, default=None, dtype=None):
    """``dmlc::GetEnv``: a typed environment lookup of any variable. The
    framework's own ``MXNET_*`` knobs read through :mod:`.envs`."""
    val = os.environ.get(name)
    if val is None:
        return default
    if dtype is None and default is not None:
        dtype = type(default)
    if dtype is bool:
        return val in _TRUE
    if dtype is not None:
        try:
            return dtype(val)
        except ValueError:
            return default
    return val


class classproperty:
    """A read-only property of the class."""

    def __init__(self, fget):
        self.fget = fget

    def __get__(self, obj, owner):
        return self.fget(owner)


class Registry:
    """Name → object registry (the role of ``dmlc::Registry``). Lookup is
    case-insensitive for creation-by-name registries (optimizers,
    initializers), as in the reference."""

    def __init__(self, name, case_sensitive=True):
        self.name = name
        self._case_sensitive = case_sensitive
        self._entries = {}
        self._lock = threading.Lock()

    def _key(self, name):
        return name if self._case_sensitive else name.lower()

    def register(self, name=None, allow_override=False):
        def _do(obj, reg_name):
            key = self._key(reg_name)
            with self._lock:
                if key in self._entries and not allow_override:
                    raise ValueError(
                        "%s '%s' already registered in registry '%s'"
                        % (self.name, reg_name, self.name))
                self._entries[key] = obj
            return obj

        if callable(name):  # used as a bare decorator
            return _do(name, name.__name__)

        def deco(obj):
            return _do(obj, name or obj.__name__)
        return deco

    def get(self, name):
        key = self._key(name)
        if key not in self._entries:
            raise KeyError("%s '%s' is not registered. Known: %s"
                           % (self.name, name, sorted(self._entries)))
        return self._entries[key]

    def find(self, name):
        return self._entries.get(self._key(name))

    def __contains__(self, name):
        return self._key(name) in self._entries

    def keys(self):
        return list(self._entries.keys())

    def items(self):
        return list(self._entries.items())


def build_param_doc(arg_names, arg_types, arg_descs, remove_dup=True):
    """The numpydoc ``Parameters`` block of an operator's arguments
    (mxnet.base.build_param_doc): ``name : type`` and its description
    indented below, a repeated name once unless ``remove_dup`` is
    False."""
    param_keys = set()
    param_str = []
    for key, type_info, desc in zip(arg_names, arg_types, arg_descs):
        if key in param_keys and remove_dup:
            continue
        param_keys.add(key)
        ret = "%s : %s" % (key, type_info)
        if len(desc) != 0:
            ret += "\n    " + desc
        param_str.append(ret)
    return "Parameters\n----------\n%s\n" % "\n".join(param_str)
