"""Convolution and pooling layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``): ``Conv1D/2D/3D`` over the
``Convolution`` op and the max / average / global pooling family over
``Pooling``. The transposed convolutions and ``ReflectionPad2D`` wait
for the ``Deconvolution`` and ``Pad`` ops (ROADMAP queue A item 9).
``in_channels=0`` is taken from the first input by shape inference."""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D"]


def _ntuple(value, n):
    return (value,) * n if isinstance(value, int) else tuple(value)


class _Conv(HybridBlock):
    """Base convolution (reference: conv_layers.py:37): weight
    ``(channels, in_channels / groups, *kernel_size)``, bias
    ``(channels,)``."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            n = len(kernel_size)
            self._kwargs = {
                "kernel": tuple(kernel_size),
                "stride": _ntuple(strides, n), "dilate": _ntuple(dilation, n),
                "pad": _ntuple(padding, n), "num_filter": channels,
                "num_group": groups, "no_bias": not use_bias,
                "layout": layout}
            self.weight = self.params.get(
                "weight", shape=(channels, in_channels // groups
                                 if in_channels else 0) + tuple(kernel_size),
                init=weight_initializer, allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            out = F.Convolution(x, weight, name="fwd", **self._kwargs)
        else:
            out = F.Convolution(x, weight, bias, name="fwd", **self._kwargs)
        return out if self.act is None else self.act(out)

    def _alias(self):
        return "conv"

    def __repr__(self):
        s = "{name}({mapping}, kernel_size={kernel}, stride={stride}"
        n = len(self._kwargs["kernel"])
        if self._kwargs["pad"] != (0,) * n:
            s += ", padding={pad}"
        if self._kwargs["dilate"] != (1,) * n:
            s += ", dilation={dilate}"
        if self._kwargs["num_group"] != 1:
            s += ", groups={num_group}"
        if self.bias is None:
            s += ", bias=False"
        if self.act:
            s += ", {}".format(self.act)
        shape = self.weight.shape
        return (s + ")").format(
            name=type(self).__name__,
            mapping="{0} -> {1}".format(shape[1] if shape[1] else None,
                                        shape[0]), **self._kwargs)


def _conv_class(n, layout, doc):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout=layout, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        kernel_size = _ntuple(kernel_size, n)
        assert len(kernel_size) == n, \
            "kernel_size must be a number or a list of %d ints" % n
        _Conv.__init__(self, channels, kernel_size, strides, padding,
                       dilation, groups, layout, in_channels, activation,
                       use_bias, weight_initializer, bias_initializer,
                       **kwargs)
    return type("Conv%dD" % n, (_Conv,), {"__init__": __init__,
                                          "__doc__": doc})


Conv1D = _conv_class(1, "NCW", "1-D convolution over (N, C, W).")
Conv2D = _conv_class(2, "NCHW", "2-D convolution over (N, C, H, W).")
Conv3D = _conv_class(3, "NCDHW", "3-D convolution over (N, C, D, H, W).")


class _Pooling(HybridBlock):
    """Base pooling (reference: conv_layers.py:270): ``strides`` default
    to ``pool_size``; ``ceil_mode`` is MXNet's "full" convention."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": _ntuple(strides, len(pool_size)),
            "pad": _ntuple(padding, len(pool_size)),
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, name="fwd", **self._kwargs)

    def __repr__(self):
        return "{name}(size={kernel}, stride={stride}, padding={pad}, " \
            "ceil_mode={ceil_mode})".format(
                name=type(self).__name__,
                ceil_mode=self._kwargs["pooling_convention"] == "full",
                **self._kwargs)


def _pool_size(pool_size, n, layout, want):
    assert layout == want, "Only %s layout is supported for now" % want
    pool_size = _ntuple(pool_size, n)
    assert len(pool_size) == n
    return pool_size


# the positional order of each class's arguments is the reference's
class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_pool_size(pool_size, 1, layout, "NCW"), strides,
                         padding, ceil_mode, False, "max", layout, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_pool_size(pool_size, 2, layout, "NCHW"), strides,
                         padding, ceil_mode, False, "max", layout, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCDHW", **kwargs):
        super().__init__(_pool_size(pool_size, 3, layout, "NCDHW"), strides,
                         padding, ceil_mode, False, "max", layout, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(_pool_size(pool_size, 1, layout, "NCW"), strides,
                         padding, ceil_mode, False, "avg", layout,
                         count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCHW", count_include_pad=True,
                 **kwargs):
        super().__init__(_pool_size(pool_size, 2, layout, "NCHW"), strides,
                         padding, ceil_mode, False, "avg", layout,
                         count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCDHW", count_include_pad=True,
                 **kwargs):
        super().__init__(_pool_size(pool_size, 3, layout, "NCDHW"), strides,
                         padding, ceil_mode, False, "avg", layout,
                         count_include_pad, **kwargs)


def _global_pool_class(name, n, pool_type, want):
    def __init__(self, layout=want, **kwargs):
        _Pooling.__init__(self, _pool_size(1, n, layout, want), None, 0,
                          True, True, pool_type, layout, **kwargs)
    return type(name, (_Pooling,), {
        "__init__": __init__,
        "__doc__": "Global %s pooling over %d spatial dim(s)."
                   % (pool_type, n)})


GlobalMaxPool1D = _global_pool_class("GlobalMaxPool1D", 1, "max", "NCW")
GlobalMaxPool2D = _global_pool_class("GlobalMaxPool2D", 2, "max", "NCHW")
GlobalMaxPool3D = _global_pool_class("GlobalMaxPool3D", 3, "max", "NCDHW")
GlobalAvgPool1D = _global_pool_class("GlobalAvgPool1D", 1, "avg", "NCW")
GlobalAvgPool2D = _global_pool_class("GlobalAvgPool2D", 2, "avg", "NCHW")
GlobalAvgPool3D = _global_pool_class("GlobalAvgPool3D", 3, "avg", "NCDHW")
