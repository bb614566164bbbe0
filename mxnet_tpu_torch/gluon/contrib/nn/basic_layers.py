"""Contrib layers (counterpart of
``mxnet_tpu/gluon/contrib/nn/basic_layers.py``): ``Concurrent`` and
``HybridConcurrent`` (children run on one input, their outputs joined
by ``Concat``) and ``Identity``."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn.basic_layers import Sequential, HybridSequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity"]


class Concurrent(Sequential):
    """Parallel branches concatenated along ``axis`` (reference:
    basic_layers.py:38)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        from .... import ndarray as nd
        out = [block(x) for block in self._children.values()]
        return nd.Concat(*out, dim=self.axis)


class HybridConcurrent(HybridSequential):
    """Hybridizable parallel branches concatenated along ``axis``
    (reference: basic_layers.py:69)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.Concat(*out, dim=self.axis)


class Identity(HybridBlock):
    """Its input, unchanged (a branch of a Concurrent block)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        return x
