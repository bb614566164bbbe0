"""Basic Gluon layers (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``): the two Sequential containers,
``Dense``, ``Embedding``, ``BatchNorm``, ``LayerNorm``, ``Flatten`` and
``Activation``. Each lowers to registered ops; a parameter shape that
waits for the first input (``in_units=0``, ``in_channels=0``) is fixed
by shape inference over the block's traced graph."""
from __future__ import annotations

import numpy as np

from ..block import Block, HybridBlock

__all__ = ["Sequential", "HybridSequential", "Dense", "Embedding",
           "BatchNorm", "LayerNorm", "Flatten", "Activation"]


class _Stack:
    """Shared container plumbing for Sequential/HybridSequential."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __getitem__(self, key):
        picked = list(self._children.values())[key]
        if not isinstance(picked, list):
            return picked
        sub = type(self)(prefix=self._prefix)
        with sub.name_scope():
            sub.add(*picked)
        return sub

    def __len__(self):
        return len(self._children)


class Sequential(_Stack, Block):
    """Imperative stack of Blocks (reference: basic_layers.py:35)."""

    def forward(self, x):
        for child in self._children.values():
            x = child(x)
        return x


class HybridSequential(_Stack, HybridBlock):
    """Stack of HybridBlocks (reference: basic_layers.py:117)."""

    def hybrid_forward(self, F, x):
        for child in self._children.values():
            x = child(x)
        return x


class Dense(HybridBlock):
    """Affine layer, optionally flattening trailing dims and applying an
    activation (reference: basic_layers.py:142). ``weight`` is
    ``(units, in_units)``; ``in_units=0`` is taken from the first input:
    its last dim with ``flatten=False``, else the product of all but the
    first."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units, self._in_units = units, in_units
        self._flatten = flatten
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(units,), dtype=dtype,
                init=bias_initializer, allow_deferred_init=True) \
                if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, no_bias=bias is None,
                               num_hidden=self._units,
                               flatten=self._flatten, name="fwd")
        return out if self.act is None else self.act(out)

    def __repr__(self):
        n_out, n_in = self.weight.shape
        return "{}({} -> {}, {})".format(
            type(self).__name__, n_in if n_in else None, n_out,
            self.act if self.act else "linear")


class Embedding(HybridBlock):
    """Index → row lookup (reference: basic_layers.py:372)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        if sparse_grad:
            raise NotImplementedError(
                "Embedding(sparse_grad=True): row_sparse gradients are not "
                "ported yet (ROADMAP queue A item 13)")
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype, "sparse_grad": sparse_grad}
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim), dtype=dtype,
            init=weight_initializer, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, name="fwd", **self._kwargs)

    def __repr__(self):
        return "{}({input_dim} -> {output_dim}, {dtype})".format(
            type(self).__name__, **self._kwargs)


class BatchNorm(HybridBlock):
    """Batch normalization with running statistics (reference:
    basic_layers.py:276): ``fix_gamma = not scale``; ``running_mean`` and
    ``running_var`` are auxiliary states (``grad_req='null'``), updated
    in train mode as ``momentum * old + (1 - momentum) * batch``.
    ``in_channels=0`` is taken from the first input's ``axis`` dim."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        if in_channels != 0:
            self.in_channels = in_channels
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True, differentiable=scale)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True, differentiable=center)
        for stat, init in (("running_mean", running_mean_initializer),
                           ("running_var", running_variance_initializer)):
            setattr(self, stat, self.params.get(
                stat, grad_req="null", shape=(in_channels,), init=init,
                allow_deferred_init=True, differentiable=False))

    def cast(self, dtype):
        # float16 batch statistics lose too much precision: keep fp32
        if np.dtype(dtype).name == "float16":
            dtype = "float32"
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           name="fwd", **self._kwargs)

    def __repr__(self):
        inner = ", ".join("=".join((k, repr(v)))
                          for k, v in self._kwargs.items())
        c = self.gamma.shape[0]
        return "{}({}, in_channels={})".format(
            type(self).__name__, inner, c if c else None)


class LayerNorm(HybridBlock):
    """Normalization over one axis, the last by default (reference:
    basic_layers.py:535). ``in_channels=0`` is taken from the first
    input's ``axis`` dim."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._kwargs = {"eps": epsilon, "axis": axis, "center": center,
                        "scale": scale}
        self._axis, self._epsilon = axis, epsilon
        self.gamma = self.params.get(
            "gamma", grad_req="write" if scale else "null",
            shape=(in_channels,), init=gamma_initializer,
            allow_deferred_init=True)
        self.beta = self.params.get(
            "beta", grad_req="write" if center else "null",
            shape=(in_channels,), init=beta_initializer,
            allow_deferred_init=True)

    def hybrid_forward(self, F, data, gamma, beta):
        return F.LayerNorm(data, gamma=gamma, beta=beta, axis=self._axis,
                           eps=self._epsilon)

    def __repr__(self):
        inner = ", ".join("=".join((k, repr(v)))
                          for k, v in self._kwargs.items())
        c = self.gamma.shape[0]
        return "{}({}, in_channels={})".format(
            type(self).__name__, inner, c if c else None)


class Flatten(HybridBlock):
    """Collapse all but the batch dim (reference: basic_layers.py:418)."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return type(self).__name__


class Activation(HybridBlock):
    """Named activation via the Activation op."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type, name="fwd")

    def __repr__(self):
        return "{}({})".format(type(self).__name__, self._act_type)
