"""Parameter-shape inference hooks (counterpart of
``mxnet_tpu/symbol/infer.py``).

Output shapes come from running each op body on ``meta`` tensors (or
its registered ``output_shapes`` rule). What needs per-op knowledge is
inferring a learnable parameter's shape BACKWARD from the data shape
(FullyConnected's weight is ``(num_hidden, in_dim)``), which deferred
initialization depends on. Only the parameter-bearing ops need a hook.

Hook signature: ``hook(attrs, in_shapes) -> {input_index: shape}``,
where ``in_shapes`` holds a tuple for each known input and None for
each unknown one.
"""
from __future__ import annotations

import math

PARAM_SHAPE_HOOKS = {}


def hook(op_name):
    def deco(fn):
        PARAM_SHAPE_HOOKS[op_name] = fn
        return fn
    return deco


@hook("FullyConnected")
def _fc(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return {}
    num_hidden = int(attrs["num_hidden"])
    in_dim = math.prod(data[1:]) if attrs.get("flatten", True) else data[-1]
    out = {1: (num_hidden, in_dim)}
    if not attrs.get("no_bias", False):
        out[2] = (num_hidden,)
    return out


@hook("Convolution")
def _conv(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return {}
    num_filter = int(attrs["num_filter"])
    groups = int(attrs.get("num_group", 1))
    out = {1: (num_filter, data[1] // groups) + tuple(attrs["kernel"])}
    if not attrs.get("no_bias", False):
        out[2] = (num_filter,)
    return out


@hook("Deconvolution")
def _deconv(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return {}
    num_filter = int(attrs["num_filter"])
    groups = int(attrs.get("num_group", 1))
    out = {1: (data[1], num_filter // groups) + tuple(attrs["kernel"])}
    if not attrs.get("no_bias", True):
        out[2] = (num_filter,)
    return out


def _channel_param(axis_default):
    def fn(attrs, in_shapes):
        data = in_shapes[0]
        if data is None:
            return {}
        c = data[int(attrs.get("axis", axis_default)) % len(data)]
        return {i: (c,) for i in range(1, len(in_shapes))}
    return fn


PARAM_SHAPE_HOOKS["BatchNorm"] = _channel_param(1)
PARAM_SHAPE_HOOKS["LayerNorm"] = _channel_param(-1)
PARAM_SHAPE_HOOKS["InstanceNorm"] = _channel_param(1)


@hook("LeakyReLU")
def _leaky(attrs, in_shapes):
    if attrs.get("act_type", "leaky") != "prelu":
        return {}
    data = in_shapes[0]
    if data is None:
        return {}
    return {1: (data[1] if len(data) > 1 else 1,)}


@hook("Embedding")
def _embedding(attrs, in_shapes):
    return {1: (int(attrs["input_dim"]), int(attrs["output_dim"]))}


@hook("RNN")
def _rnn(attrs, in_shapes):
    data = in_shapes[0]
    if data is None:
        return {}
    from ..ops.rnn_op import param_size
    return {1: (param_size(attrs.get("mode", "lstm"),
                           attrs.get("num_layers", 1),
                           attrs.get("bidirectional", False), data[2],
                           attrs["state_size"]),)}
