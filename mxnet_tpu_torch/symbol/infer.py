"""Parameter-shape inference hooks (counterpart of
``mxnet_tpu/symbol/infer.py``).

Output shapes come from running each op body on ``meta`` tensors (or
its registered ``output_shapes`` rule). What needs per-op knowledge is
inferring a learnable parameter's shape BACKWARD from the data shape
(FullyConnected's weight is ``(num_hidden, in_dim)``), which deferred
initialization depends on. Only the parameter-bearing ops need a hook.

Hook signature: ``hook(attrs, in_shapes) -> {input_index: shape}``,
where ``in_shapes`` holds a tuple for each known input and None for
each unknown one. The control-flow ops' hooks run their subgraphs' own
inference, so a parameter used in a loop body gets its shape from the
data, where the JAX package asks for it explicitly.
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


# -- control flow: a free input's shape from the subgraph that reads it ----

def _from_subgraph(sub, pools, offset, in_shapes):
    """``{node input index: shape}`` of the free inputs of ``sub`` whose
    shape its own inference resolves from the known data and state
    shapes (the reference infers through the subgraph; a Gluon parameter
    used in a loop body is such a free input)."""
    known = {}
    for name, (kind, i) in zip(sub.arg_names, sub.layout):
        shape = pools[kind][i]
        if shape is not None:
            known[name] = tuple(shape)
    arg_shapes = sub.sym.infer_shape_partial(**known)[0]
    out = {}
    for (kind, i), shape in zip(sub.layout, arg_shapes):
        if kind == "free" and shape is not None \
                and in_shapes[offset + i] is None:
            out[offset + i] = tuple(shape)
    return out


@hook("_foreach")
def _foreach(attrs, in_shapes):
    n_data, n_state = attrs["num_data"], attrs["num_states"]
    data = [None if s is None else tuple(s[1:]) for s in in_shapes[:n_data]]
    pools = {"data": data,
             "state": in_shapes[n_data:n_data + n_state],
             "free": in_shapes[n_data + n_state:]}
    return _from_subgraph(attrs["subgraph"], pools, n_data + n_state,
                          in_shapes)


@hook("_while_loop")
def _while_loop(attrs, in_shapes):
    n_state, n_cf = attrs["num_states"], attrs["num_free_cond"]
    states = in_shapes[:n_state]
    out = _from_subgraph(attrs["cond_subgraph"], {
        "state": states, "free": in_shapes[n_state:n_state + n_cf]},
        n_state, in_shapes)
    out.update(_from_subgraph(attrs["body_subgraph"], {
        "state": states, "free": in_shapes[n_state + n_cf:]},
        n_state + n_cf, in_shapes))
    return out


@hook("_cond")
def _cond(attrs, in_shapes):
    n_state = attrs["num_states"]
    states = in_shapes[:n_state]
    out = {}
    offset = n_state
    for key, count in (("cond_subgraph", attrs["num_free_cond"]),
                       ("then_subgraph", attrs["num_free_then"]),
                       ("else_subgraph", None)):
        free = in_shapes[offset:] if count is None \
            else in_shapes[offset:offset + count]
        out.update(_from_subgraph(attrs[key], {"state": states,
                                               "free": free},
                                  offset, in_shapes))
        offset += 0 if count is None else count
    return out
