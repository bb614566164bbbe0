"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``).

A parameter is routed by its name's suffix (``*weight``, ``*bias``,
``*gamma``, ``*beta``, BatchNorm's ``*running_mean`` / ``*moving_mean``
to zeros and ``*running_var`` / ``*moving_var`` to ones) to a handler,
which fills the array in place.
The random draws of ``Uniform``, ``Normal`` and ``Xavier`` take the
generator of the array's device from :mod:`mxnet_tpu_torch.random` (the
JAX package draws from numpy's global state), so a seed fixes the
weights on each device. ``Orthogonal``, ``MSRAPrelu``, ``Bilinear`` and
``LSTMBias`` copy the JAX package's numpy arithmetic instead, drawing
from numpy's global state, so one ``np.random.seed`` gives the same
arrays in both packages; ``Mixed`` picks an initializer by name.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

from .base import MXNetError, Registry
from . import random as _random

__all__ = ["InitDesc", "Initializer", "register", "create", "Zero", "One",
           "Constant", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Bilinear", "LSTMBias", "Mixed"]

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


class _NumpyDraw:
    """A weight made on the host by ``_generate(name, shape)``, the JAX
    package's numpy arithmetic, then copied into the array."""

    def _init_weight(self, name, arr):
        value = np.asarray(self._generate(name, arr.shape),
                           dtype=np.dtype(arr.dtype))
        with torch.no_grad():
            arr._data.copy_(torch.from_numpy(value))


@register
class Orthogonal(_NumpyDraw, Initializer):
    """An orthonormal basis from the SVD of a random matrix (uniform in
    [-1, 1] or standard normal), scaled (reference:
    initializer.py:482)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale, self.rand_type = scale, rand_type

    def _generate(self, name, shape):
        rows, cols = shape[0], int(np.prod(shape[1:]))
        seed = np.random.uniform(-1, 1, (rows, cols)) \
            if self.rand_type == "uniform" \
            else np.random.normal(0, 1, (rows, cols))
        u, _, vt = np.linalg.svd(seed, full_matrices=False)
        basis = u if u.shape == seed.shape else vt
        return (self.scale * basis).reshape(shape)


@register
class MSRAPrelu(_NumpyDraw, Xavier):
    """He/MSRA scaling for PReLU slopes: Xavier gaussian with magnitude
    ``2 / (1 + slope**2)`` (reference: initializer.py:626)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}

    def _generate(self, name, shape):
        try:
            factor = self._FACTORS[self.factor_type](*_fans(name, shape))
        except KeyError:
            raise ValueError("factor_type must be avg/in/out, got %r"
                             % (self.factor_type,))
        return np.random.normal(0.0, np.sqrt(self.magnitude / factor),
                                shape)


@register
class Bilinear(_NumpyDraw, Initializer):
    """The bilinear upsampling kernel of a deconvolution, on every
    (out, in) pair (reference: initializer.py:657)."""

    def _generate(self, name, shape):
        kw = shape[3]
        kh = shape[2]
        f = np.ceil(kw / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        xs = np.arange(kw)
        ys = np.arange(kh)
        kernel = np.outer(1 - np.abs(ys / f - c), 1 - np.abs(xs / f - c))
        return np.broadcast_to(kernel, shape)


@register
class LSTMBias(_NumpyDraw, Initializer):
    """``forget_bias`` on the forget gate's quarter of an LSTM bias,
    zero elsewhere (reference: initializer.py:685)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _generate(self, name, shape):
        vec = np.zeros(shape, dtype="float32")
        h = shape[0] // 4
        vec[h:2 * h] = self.forget_bias
        return vec

    def _init_default(self, name, arr):
        self._init_weight(name, arr)

    _init_bias = _NumpyDraw._init_weight


@register
class Mixed(Initializer):
    """The initializer of the first pattern (a regex) that matches a
    parameter's name (reference: initializer.py:286)."""

    def __init__(self, patterns, initializers):
        super().__init__()
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must pair up")
        self.map = [(re.compile(p), ini)
                    for p, ini in zip(patterns, initializers)]

    def __call__(self, name, arr):
        for pattern, ini in self.map:
            if pattern.match(str(name)):
                ini(name, arr)
                return
        raise ValueError(
            "parameter %r matched none of the Mixed patterns; add a "
            "'.*' catch-all if that is intended" % str(name))


for _alias, _cls in (("zeros", Zero), ("ones", One), ("gaussian", Normal),
                     ("msra", MSRAPrelu)):
    _REG.register(_alias, allow_override=True)(_cls)


def create(name, **kwargs):
    """Resolve an initializer from an instance, name or alias."""
    if isinstance(name, Initializer):
        return name
    cls = _REG.find(str(name))
    if cls is None:
        raise MXNetError("unknown initializer %r" % (name,))
    return cls(**kwargs)
