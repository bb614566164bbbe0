"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``).

A parameter is routed by its name's suffix (``*weight``, ``*bias``,
``*gamma``, ``*beta``, BatchNorm's ``*running_mean`` / ``*moving_mean``
to zeros and ``*running_var`` / ``*moving_var`` to ones) to a handler,
which fills the array in place.
Every random draw takes the generator of the array's device from
:mod:`mxnet_tpu_torch.random` (the JAX package draws from numpy's global
state), so a seed fixes the weights on each device.
"""
from __future__ import annotations

import json
import math

import torch

from .base import MXNetError, Registry
from . import random as _random

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Constant", "Uniform", "Normal", "Xavier"]

_REG = Registry("initializer", case_sensitive=False)


class InitDesc(str):
    """Parameter name enriched with attrs and the global initializer
    (reference: initializer.py:37)."""

    def __new__(cls, name, attrs=None, global_init=None):
        self = str.__new__(cls, name)
        self.attrs = attrs or {}
        self.global_init = global_init
        return self


def register(klass):
    _REG.register(klass.__name__)(klass)
    return klass


# suffix -> handler method, first match wins
_SUFFIX_ROUTES = (
    (("weight",), "_init_weight"),
    (("bias",), "_init_bias"),
    (("gamma",), "_init_gamma"),
    (("beta",), "_init_beta"),
    (("moving_mean", "running_mean", "moving_inv_var", "moving_avg",
      "min", "max"), "_init_zero"),
    (("moving_var", "running_var"), "_init_one"),
)


class Initializer:
    """Base initializer: routes a parameter by name suffix and fills the
    NDArray in place (reference: initializer.py:95)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """Serialized ``[name, kwargs]`` form (a Symbol variable's
        ``__init__`` attribute)."""
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("initializer expects a parameter name "
                            "(str/InitDesc), got %s" % type(desc))
        for suffixes, method in _SUFFIX_ROUTES:
            if str(desc).endswith(suffixes):
                getattr(self, method)(desc, arr)
                return
        self._init_default(desc, arr)

    # -- per-kind handlers (subclass extension points) --------------------
    def _init_zero(self, name, arr):
        with torch.no_grad():
            arr._data.zero_()

    def _init_one(self, name, arr):
        with torch.no_grad():
            arr._data.fill_(1)

    _init_bias = _init_zero
    _init_beta = _init_zero
    _init_gamma = _init_one

    def _init_weight(self, name, arr):
        with torch.no_grad():
            self._fill(name, arr._data,
                       _random.generator(arr._data.device))

    def _fill(self, name, data, gen):
        """Fill ``data`` (a torch tensor) in place, drawing from ``gen``."""
        raise NotImplementedError(
            "%s must implement _fill or override _init_weight"
            % type(self).__name__)

    def _init_default(self, name, arr):
        raise ValueError(
            "no initialization rule for %r: only *weight/*bias/*gamma/"
            "*beta (and BatchNorm stats) route automatically — pass an "
            "explicit Initializer for this array" % str(name))


class _EverywhereMixin:
    """Initializers that apply to any parameter kind, not just weights."""

    def _init_default(self, name, arr):
        self._init_weight(name, arr)


@register
class Zero(_EverywhereMixin, Initializer):
    def _fill(self, name, data, gen):
        data.zero_()


@register
class One(_EverywhereMixin, Initializer):
    def _fill(self, name, data, gen):
        data.fill_(1)


@register
class Constant(_EverywhereMixin, Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _fill(self, name, data, gen):
        data.fill_(self.value)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _fill(self, name, data, gen):
        data.uniform_(-self.scale, self.scale, generator=gen)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _fill(self, name, data, gen):
        data.normal_(0.0, self.sigma, generator=gen)


def _fans(name, shape):
    """(fan_in, fan_out) with conv receptive-field scaling."""
    if len(shape) < 2:
        raise ValueError(
            "Xavier-family initializers need >= 2 dims; %r has shape %s"
            % (str(name), tuple(shape)))
    field = math.prod(shape[2:]) if len(shape) > 2 else 1.0
    return shape[1] * field, shape[0] * field


@register
class Xavier(Initializer):
    """Glorot scaling with MXNet's defaults: uniform, factor ``avg``,
    magnitude 3 (reference: initializer.py:540)."""

    _FACTORS = {
        "avg": lambda fi, fo: (fi + fo) / 2.0,
        "in": lambda fi, fo: fi,
        "out": lambda fi, fo: fo,
    }

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type, self.factor_type = rnd_type, factor_type
        self.magnitude = float(magnitude)

    def _fill(self, name, data, gen):
        try:
            factor = self._FACTORS[self.factor_type](
                *_fans(name, data.shape))
        except KeyError:
            raise ValueError("factor_type must be avg/in/out, got %r"
                             % (self.factor_type,))
        bound = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            data.uniform_(-bound, bound, generator=gen)
        elif self.rnd_type == "gaussian":
            data.normal_(0.0, bound, generator=gen)
        else:
            raise ValueError("rnd_type must be uniform/gaussian, got %r"
                             % (self.rnd_type,))


for _alias, _cls in (("zeros", Zero), ("ones", One), ("gaussian", Normal)):
    _REG.register(_alias, allow_override=True)(_cls)


def create(name, **kwargs):
    """Resolve an initializer from an instance, name or alias."""
    if isinstance(name, Initializer):
        return name
    cls = _REG.find(str(name))
    if cls is None:
        raise MXNetError("unknown initializer %r" % (name,))
    return cls(**kwargs)
