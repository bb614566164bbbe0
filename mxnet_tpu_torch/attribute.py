"""Attribute scoping for symbols (counterpart of
``mxnet_tpu/attribute.py``): ``with mx.AttrScope(ctx_group='dev1'):``
attaches string attributes to every Symbol node created inside it. The
port stores them on the nodes and in the JSON; ``bind(group2ctx=)``
places the ``ctx_group`` segments on their devices
(:mod:`~mxnet_tpu_torch.placement`)."""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        self._old_scope = None
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("Attributes need to be a string")
        self._attr = kwargs

    def get(self, attr):
        """The scope's attributes updated with ``attr``."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        self._old_scope = AttrScope.current()
        attr = self._old_scope._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, ptype, value, trace):
        AttrScope._current.value = self._old_scope

    @staticmethod
    def current():
        if not hasattr(AttrScope._current, "value"):
            AttrScope._current.value = AttrScope()
        return AttrScope._current.value
