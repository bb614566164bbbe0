"""INT8 model quantization flow (counterpart of
``mxnet_tpu/contrib/quantization.py``; reference:
python/mxnet/contrib/quantization.py + the graph rewrite pass
src/operator/quantization/quantize_graph_pass.cc).

The flow mirrors the reference's three stages:

1. :func:`quantize_symbol` — graph rewrite: eligible FullyConnected /
   Convolution nodes become quantize_v2 -> quantized op -> requantize
   -> dequantize chains over ``ops.quantization`` (the pass's node
   substitution, done on the Symbol IR);
2. calibration — run calibration batches op by op and record the
   min/max of every quantizable node's output (the ``naive`` calib
   mode; entropy calibration is a documented omission, as in the JAX
   package);
3. :func:`quantize_model` — 1 with the ranges of 2 set on the
   requantize nodes, returning ``(qsym, arg_params, aux_params)``.
"""
from __future__ import annotations

from ..base import MXNetError
from .. import ndarray as nd
from .. import symbol as sym_mod

__all__ = ["quantize_model", "quantize_symbol", "calib_graph",
           "calibrate_ranges"]

_QUANTIZABLE = {"FullyConnected", "Convolution"}


def _collect_layer_ranges(symbol, arg_params, aux_params, calib_data,
                          num_calib_batches, data_name):
    """Run calibration batches eagerly, recording min/max of every
    quantizable node's output (naive calibration). Label variables get
    the batch's labels when provided, else zeros: loss heads like
    SoftmaxOutput pass activations through unchanged, so the recorded
    ranges are label-independent."""
    from ..ndarray.ndarray import invoke_nd
    ranges = {}
    batches = 0
    for batch in calib_data:
        datas = batch.data if hasattr(batch, "data") else [batch]
        x = datas[0]
        labels = list(getattr(batch, "label", None) or [])
        env = {}
        label_cursor = [0]

        def _label_value():
            if label_cursor[0] < len(labels):
                val = labels[label_cursor[0]]
                label_cursor[0] += 1
                return val
            return nd.zeros((x.shape[0],),
                            ctx=getattr(x, "context", None))

        for node in symbol._topo_nodes():
            if node.is_variable():
                if node.name == data_name:
                    env[(id(node), 0)] = x
                elif node.name in arg_params:
                    env[(id(node), 0)] = arg_params[node.name]
                elif node.name in aux_params:
                    env[(id(node), 0)] = aux_params[node.name]
                else:
                    # a label (or other unbound) variable
                    env[(id(node), 0)] = _label_value()
                continue
            ins = [env[(id(s), i)] for (s, i) in node.inputs]
            outs = invoke_nd(node.op, ins, dict(node.attrs))
            outs = outs if isinstance(outs, list) else [outs]
            for i, o in enumerate(outs):
                env[(id(node), i)] = o
            if node.op.name in _QUANTIZABLE:
                v = outs[0]._data
                lo, hi = float(v.min()), float(v.max())
                if node.name in ranges:
                    plo, phi = ranges[node.name]
                    lo, hi = min(lo, plo), max(hi, phi)
                ranges[node.name] = (lo, hi)
        batches += 1
        if num_calib_batches and batches >= num_calib_batches:
            break
    if hasattr(calib_data, "reset"):
        calib_data.reset()
    return ranges


def calibrate_ranges(symbol, arg_params, aux_params, calib_data,
                     num_calib_batches=None, data_name="data"):
    """Naive calibration as a standalone step: run ``calib_data``
    batches through ``symbol`` op by op and return the per-node
    ``{name: (min, max)}`` ranges of every quantizable node's output —
    the dict :func:`quantize_symbol` sets on requantize nodes and
    ``deploy.export_compiled(quantize=True)`` records in the format-3
    artifact's meta."""
    return _collect_layer_ranges(symbol, arg_params, aux_params,
                                 calib_data, num_calib_batches, data_name)


def quantize_symbol(symbol, excluded_symbols=(), offline_params=(),
                    calib_ranges=None):
    """Rewrite a Symbol graph to its INT8 form (reference: the
    MXQuantizeSymbol pass). Eligible nodes are replaced by quantize_v2
    -> ``_contrib_quantized_*`` -> requantize -> dequantize."""
    from ..symbol.symbol import create

    calib_ranges = calib_ranges or {}
    memo = {}

    def convert(node):
        if id(node) in memo:
            return memo[id(node)]
        if node.is_variable():
            out = sym_mod.Symbol([(node, 0)])
        else:
            ins = [convert(s)[i] for (s, i) in node.inputs]
            if node.op.name in _QUANTIZABLE \
                    and node.name not in excluded_symbols:
                out = _quantized_replacement(node, ins,
                                             calib_ranges.get(node.name))
            else:
                out = create(node.op, ins, dict(node.attrs),
                             name=node.name)
        memo[id(node)] = out
        return out

    heads = [convert(n)[i] for (n, i) in symbol._outputs]
    return sym_mod.Group(heads) if len(heads) > 1 else heads[0]


def _quantized_replacement(node, ins, crange):
    """One float node -> its int8 chain."""
    from ..symbol.symbol import create
    name = node.name
    qname = "_contrib_quantized_" + \
        ("fully_connected" if node.op.name == "FullyConnected" else "conv")
    no_bias = bool(node.attrs.get("no_bias", False))
    data, weight = ins[0], ins[1]
    bias = None if no_bias or len(ins) < 3 else ins[2]

    qd = create("_contrib_quantize_v2", [data], {},
                name=name + "_quantize_data")
    qw = create("_contrib_quantize_v2", [weight], {},
                name=name + "_quantize_weight")
    operands = [qd[0], qw[0]]
    attrs = dict(node.attrs, no_bias=bias is None)
    if bias is not None:
        qb = create("_contrib_quantize_v2", [bias], {},
                    name=name + "_quantize_bias")
        operands.append(qb[0])
    operands += [qd[1], qd[2], qw[1], qw[2]]
    if bias is not None:
        operands += [qb[1], qb[2]]
    qout = create(qname, operands, attrs, name=name + "_quantized")
    req_attrs = {}
    if crange is not None:
        req_attrs = {"min_calib_range": crange[0],
                     "max_calib_range": crange[1]}
    req = create("_contrib_requantize", [qout[0], qout[1], qout[2]],
                 req_attrs, name=name + "_requantize")
    return create("_contrib_dequantize", [req[0], req[1], req[2]], {},
                  name=name + "_dequantize")


def calib_graph(qsym, arg_params, aux_params, collector, **kwargs):
    """API-parity shim: the ranges are applied in :func:`quantize_model`."""
    return qsym


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   label_names=("softmax_label",), ctx=None,
                   excluded_sym_names=(), calib_mode="naive",
                   calib_data=None, num_calib_examples=None,
                   num_calib_batches=None, quantized_dtype="int8",
                   logger=None):
    """Quantize a trained model (reference: quantization.py:388
    quantize_model). Returns ``(qsym, arg_params, aux_params)``; the
    calibration runs on the device the parameters and batches are on
    (``ctx`` is accepted for the reference's signature)."""
    if quantized_dtype != "int8":
        raise MXNetError(
            "quantization supports int8 only, got %s" % quantized_dtype)
    ranges = None
    if calib_mode is not None and calib_mode != "none":
        if calib_mode != "naive":
            raise MXNetError(
                "calib_mode '%s' is not supported (use 'naive'; entropy "
                "calibration is a documented omission)" % calib_mode)
        if calib_data is None:
            raise MXNetError("calib_mode='naive' requires calib_data")
        if num_calib_batches is None and num_calib_examples is not None:
            bs = getattr(calib_data, "batch_size", 0) or 1
            num_calib_batches = max(1, -(-int(num_calib_examples) // bs))
        ranges = _collect_layer_ranges(sym, arg_params, aux_params,
                                       calib_data, num_calib_batches,
                                       data_names[0])
    qsym = quantize_symbol(sym, excluded_symbols=set(excluded_sym_names),
                           calib_ranges=ranges)
    return qsym, dict(arg_params), dict(aux_params)
