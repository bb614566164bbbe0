"""Base error type and registry (counterpart of ``mxnet_tpu/base.py``)."""
from __future__ import annotations

import threading

__all__ = ["MXNetError", "Registry", "numeric_types", "integer_types"]

numeric_types = (float, int)
integer_types = (int,)


class MXNetError(RuntimeError):
    """Error raised by the framework (parity with mxnet.base.MXNetError)."""


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
