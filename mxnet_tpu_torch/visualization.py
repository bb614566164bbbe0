"""Network visualization (counterpart of ``mxnet_tpu/visualization.py``;
reference: python/mxnet/visualization.py): ``print_summary`` counts
parameters by layer, ``plot_network`` returns a graphviz ``Digraph``.
``graphviz`` is imported inside ``plot_network`` alone, so the package
and ``print_summary`` need no graphviz."""
from __future__ import annotations

import json

from .symbol import Symbol

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120, positions=(.44, .64,
                                                                  .74, 1.)):
    """Print layer summary with param counts
    (reference: visualization.py:47)."""
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be Symbol")
    show_shape = False
    shape_dict = {}
    if shape is not None:
        show_shape = True
        interals = symbol.get_internals()
        _, out_shapes, _ = interals.infer_shape(**shape)
        if out_shapes is None:
            raise ValueError("Input shape is incomplete")
        shape_dict = dict(zip(interals.list_outputs(), out_shapes))
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    heads = {x[0] for x in conf["heads"]}
    if positions[-1] <= 1:
        positions = [int(line_length * p) for p in positions]
    to_display = ['Layer (type)', 'Output Shape', 'Param #',
                  'Previous Layer']

    def print_row(fields, positions):
        line = ''
        for i, field in enumerate(fields):
            line += str(field)
            line = line[:positions[i]]
            line += ' ' * (positions[i] - len(line))
        print(line)

    print('_' * line_length)
    print_row(to_display, positions)
    print('=' * line_length)

    total_params = 0
    param_counts = _param_counts(symbol, shape)
    for node in nodes:
        op = node["op"]
        name = node["name"]
        if op == "null":
            continue
        out_shape = None
        if show_shape:
            key = name + "_output"
            if key in shape_dict and shape_dict[key]:
                out_shape = shape_dict[key][1:]
        cur_param = param_counts.get(name, 0)
        pre_node = []
        for item in node["inputs"]:
            input_node = nodes[item[0]]
            if input_node["op"] != "null" or item[0] in heads:
                pre_node.append(input_node["name"])
        print_row([name + '(' + op + ')', str(out_shape), cur_param,
                   pre_node[0] if pre_node else ''], positions)
        print('_' * line_length)
        total_params += cur_param
    print("Total params: {params}".format(params=total_params))
    print('_' * line_length)
    return total_params


def _param_counts(symbol, shape):
    counts = {}
    if shape is None:
        return counts
    try:
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape)
    except Exception:
        return counts
    arg_names = symbol.list_arguments()
    data_like = set(shape.keys())
    for name, s in zip(arg_names, arg_shapes):
        if name in data_like or s is None:
            continue
        n = 1
        for d in s:
            n *= d
        # attribute param to its owning layer prefix
        owner = name.rsplit("_", 1)[0]
        counts[owner] = counts.get(owner, 0) + n
    return counts


def plot_network(symbol, title="plot", save_format='pdf', shape=None,
                 dtype=None, node_attrs=None, hide_weights=True):
    """Graphviz digraph of the network (reference: visualization.py:211).
    Requires the ``graphviz`` package."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError("plot_network requires graphviz library")
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be a Symbol")
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]
    draw_shape = shape is not None
    shape_dict = {}
    if draw_shape:
        interals = symbol.get_internals()
        _, out_shapes, _ = interals.infer_shape(**shape)
        shape_dict = dict(zip(interals.list_outputs(), out_shapes))
    node_attr = {"shape": "box", "fixedsize": "true", "width": "1.3",
                 "height": "0.8034", "style": "filled"}
    if node_attrs:
        node_attr.update(node_attrs)
    dot = Digraph(name=title, format=save_format)
    hidden_nodes = set()
    for node in nodes:
        op = node["op"]
        name = node["name"]
        attrs = node.get("attrs", {})
        label = name
        if op == "null":
            if name.endswith("weight") or name.endswith("bias") or \
                    name.endswith("gamma") or name.endswith("beta") or \
                    name.endswith("moving_mean") or \
                    name.endswith("moving_var"):
                if hide_weights:
                    hidden_nodes.add(name)
                continue
            label = name
            color = "#8dd3c7"
        elif op in ("Convolution", "Deconvolution"):
            label = "%s\n%s/%s, %s" % (op, attrs.get("kernel", ""),
                                       attrs.get("stride", "1"),
                                       attrs.get("num_filter", ""))
            color = "#fb8072"
        elif op == "FullyConnected":
            label = "FullyConnected\n%s" % attrs.get("num_hidden", "")
            color = "#fb8072"
        elif op == "BatchNorm":
            color = "#bebada"
        elif op in ("Activation", "LeakyReLU"):
            label = "%s\n%s" % (op, attrs.get("act_type", ""))
            color = "#ffffb3"
        elif op == "Pooling":
            label = "Pooling\n%s, %s/%s" % (attrs.get("pool_type", ""),
                                            attrs.get("kernel", ""),
                                            attrs.get("stride", "1"))
            color = "#80b1d3"
        elif op in ("Concat", "Flatten", "Reshape"):
            color = "#fdb462"
        elif op == "Softmax" or op == "SoftmaxOutput":
            color = "#b3de69"
        else:
            color = "#fccde5"
        dot.node(name=name, label=label, fillcolor=color, **node_attr)
    for node in nodes:
        op = node["op"]
        name = node["name"]
        if op == "null":
            continue
        for item in node["inputs"]:
            input_node = nodes[item[0]]
            input_name = input_node["name"]
            if input_name in hidden_nodes:
                continue
            attrs = {"dir": "back", "arrowtail": "open"}
            if draw_shape:
                key = input_name
                if input_node["op"] != "null":
                    key += "_output"
                if key in shape_dict and shape_dict[key]:
                    attrs["label"] = "x".join(
                        str(x) for x in shape_dict[key][1:])
            dot.edge(tail_name=name, head_name=input_name, **attrs)
    return dot
