"""Generic class registry (counterpart of ``mxnet_tpu/registry.py``;
parity: python/mxnet/registry.py — the
factory machinery behind ``mx.optimizer.register``/``create`` style
APIs, reimplemented over plain dicts)."""
from __future__ import annotations

import json
import warnings

__all__ = ["get_registry", "get_register_func", "get_alias_func",
           "get_create_func"]

_REGISTRY = {}


def get_registry(base_class):
    """A copy of the name -> class table for ``base_class``."""
    if base_class not in _REGISTRY:
        _REGISTRY[base_class] = {}
    return _REGISTRY[base_class].copy()


def get_register_func(base_class, nickname):
    """Build a registrator for subclasses of ``base_class``."""
    if base_class not in _REGISTRY:
        _REGISTRY[base_class] = {}
    registry = _REGISTRY[base_class]

    def register(klass, name=None):
        assert issubclass(klass, base_class), \
            "Can only register subclass of %s" % base_class.__name__
        if name is None:
            name = klass.__name__
        name = name.lower()
        if name in registry:
            warnings.warn(
                "New %s %s.%s registered with name %s is overriding "
                "existing %s %s.%s" % (
                    nickname, klass.__module__, klass.__name__, name,
                    nickname, registry[name].__module__,
                    registry[name].__name__),
                UserWarning, stacklevel=2)
        registry[name] = klass
        return klass

    register.__doc__ = "Register %s to the %s factory" % (nickname,
                                                          nickname)
    return register


def get_alias_func(base_class, nickname):
    """Registrator that records a class under several names."""
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            for name in aliases:
                register(klass, name)
            return klass
        return reg
    return alias


def get_create_func(base_class, nickname):
    """Factory: ``create(name_or_instance, **kwargs)`` resolving names
    (or ``'{"name": ..., attr: ...}'`` JSON strings, the reference's
    serialized form) through the registry."""
    if base_class not in _REGISTRY:
        _REGISTRY[base_class] = {}
    registry = _REGISTRY[base_class]

    def create(*args, **kwargs):
        if len(args):
            name = args[0]
            args = args[1:]
        else:
            name = kwargs.pop(nickname)
        if isinstance(name, base_class):
            assert not args and not kwargs, (
                "%s is already an instance; additional arguments are "
                "invalid" % nickname)
            return name
        if isinstance(name, str) and name.startswith("{"):
            payload = json.loads(name)
            name = payload.pop("name")
            payload.update(kwargs)
            kwargs = payload
        assert isinstance(name, str), \
            "%s must be of string type" % nickname
        name = name.lower()
        assert name in registry, \
            "%s is not registered. Known: %s" % (
                name, sorted(registry))
        return registry[name](*args, **kwargs)

    create.__doc__ = "Create a %s instance from config" % nickname
    return create
