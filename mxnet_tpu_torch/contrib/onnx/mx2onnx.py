"""Symbol graph -> ONNX export (parity:
python/mxnet/contrib/onnx/mx2onnx/export_onnx.py + _op_translations.py;
counterpart of ``mxnet_tpu/contrib/onnx/mx2onnx.py``).

Two layers:
1. ``symbol_to_onnx_ir`` — the real work: walk the Symbol JSON graph
   through a per-op converter registry into a plain-dict ONNX graph IR
   (node dicts with op_type/inputs/outputs/attrs + numpy initializers).
   Needs NO onnx package, so the converter logic is fully testable in
   this environment, and ``onnx2mx.ir_to_symbol`` can round-trip it.
2. ``ir_to_onnx`` / ``export_model`` — mechanical proto assembly via
   onnx.helper, gated on ``import onnx`` (ImportError carries the
   deploy-pair alternative).

Covered op subset = the Gluon model zoo: Convolution, BatchNorm,
Activation, Pooling, FullyConnected, Flatten, Concat, Dropout, clip,
softmax/SoftmaxOutput, elementwise/broadcast add-mul-sub-div, Reshape,
transpose, Pad, mean.
"""
from __future__ import annotations

import json

import numpy as _np

from ...base import MXNetError, atomic_write_bytes
from ...ops.registry import get_op, normalize_attrs

__all__ = ["symbol_to_onnx_ir", "ir_to_onnx", "export_model",
           "register_converter"]

MX2ONNX = {}


def register_converter(*op_names):
    def deco(fn):
        for n in op_names:
            MX2ONNX[n] = fn
        return fn
    return deco


def _node(op_type, inputs, outputs, name, **attrs):
    return {"op_type": op_type, "inputs": list(inputs),
            "outputs": list(outputs), "name": name, "attrs": attrs}


def _pair(v, default):
    if v is None or v == ():
        return (default, default)
    if isinstance(v, int):
        return (v, v)
    t = tuple(int(x) for x in v)
    return t if len(t) == 2 else (t[0], t[0])


class _Ctx:
    """Converter context: initializer dict (converters may add or
    rewrite entries, e.g. fix_gamma) and a unique-name counter."""

    def __init__(self, initializers):
        self.initializers = initializers
        self._n = 0

    def fresh(self, base):
        self._n += 1
        return "%s__%d" % (base, self._n)


# ---------------------------------------------------------------------------
# converters (mx node, input names, normalized attrs, out name, ctx)
# ---------------------------------------------------------------------------

@register_converter("Convolution")
def _conv(node, inputs, a, out, ctx):
    kh, kw = tuple(int(k) for k in a["kernel"])
    sh, sw = _pair(a.get("stride"), 1)
    dh, dw = _pair(a.get("dilate"), 1)
    ph, pw = _pair(a.get("pad"), 0)
    ins = inputs[:2] if a.get("no_bias") else inputs[:3]
    return [_node("Conv", ins, [out], node["name"],
                  kernel_shape=(kh, kw), strides=(sh, sw),
                  dilations=(dh, dw), pads=(ph, pw, ph, pw),
                  group=int(a.get("num_group", 1)))]


@register_converter("BatchNorm", "BatchNorm_v1")
def _bn(node, inputs, a, out, ctx):
    if a.get("fix_gamma", True):
        gname = inputs[1]
        if gname in ctx.initializers:
            ctx.initializers[gname] = _np.ones_like(
                ctx.initializers[gname])
    return [_node("BatchNormalization", inputs[:5], [out],
                  node["name"], epsilon=float(a.get("eps", 1e-3)),
                  momentum=float(a.get("momentum", 0.9)))]


_ACT = {"relu": "Relu", "sigmoid": "Sigmoid", "tanh": "Tanh",
        "softrelu": "Softplus", "softsign": "Softsign"}


@register_converter("Activation")
def _act(node, inputs, a, out, ctx):
    t = a.get("act_type", "relu")
    if t not in _ACT:
        raise MXNetError("ONNX export: unsupported act_type %r" % t)
    return [_node(_ACT[t], inputs[:1], [out], node["name"])]


@register_converter("Pooling")
def _pool(node, inputs, a, out, ctx):
    ptype = a.get("pool_type", "max")
    if ptype not in ("max", "avg"):
        raise MXNetError("ONNX export: unsupported pool_type %r"
                         % ptype)
    if a.get("global_pool", False):
        op = "GlobalMaxPool" if ptype == "max" else "GlobalAveragePool"
        return [_node(op, inputs[:1], [out], node["name"])]
    kh, kw = _pair(a.get("kernel"), 1)
    sh, sw = _pair(a.get("stride"), 1)
    ph, pw = _pair(a.get("pad"), 0)
    op = "MaxPool" if ptype == "max" else "AveragePool"
    extra = {} if ptype == "max" else {
        "count_include_pad": 1
        if a.get("count_include_pad", True) else 0}
    return [_node(op, inputs[:1], [out], node["name"],
                  kernel_shape=(kh, kw), strides=(sh, sw),
                  pads=(ph, pw, ph, pw), **extra)]


@register_converter("FullyConnected")
def _fc(node, inputs, a, out, ctx):
    nodes = []
    data = inputs[0]
    if a.get("flatten", True):
        flat = ctx.fresh(node["name"] + "_flatten")
        nodes.append(_node("Flatten", [data], [flat],
                           flat, axis=1))
        data = flat
    ins = [data, inputs[1]]
    if not a.get("no_bias", False) and len(inputs) > 2:
        ins.append(inputs[2])
    nodes.append(_node("Gemm", ins, [out], node["name"],
                       alpha=1.0, beta=1.0, transA=0, transB=1))
    return nodes


@register_converter("Flatten")
def _flatten(node, inputs, a, out, ctx):
    return [_node("Flatten", inputs[:1], [out], node["name"], axis=1)]


@register_converter("Concat")
def _concat(node, inputs, a, out, ctx):
    return [_node("Concat", inputs, [out], node["name"],
                  axis=int(a.get("dim", 1)))]


@register_converter("Dropout")
def _dropout(node, inputs, a, out, ctx):
    return [_node("Dropout", inputs[:1], [out], node["name"],
                  ratio=float(a.get("p", 0.5)))]


@register_converter("clip")
def _clip(node, inputs, a, out, ctx):
    return [_node("Clip", inputs[:1], [out], node["name"],
                  min=float(a.get("a_min", 0.0)),
                  max=float(a.get("a_max", 1.0)))]


@register_converter("softmax")
def _softmax(node, inputs, a, out, ctx):
    return [_node("Softmax", inputs[:1], [out], node["name"],
                  axis=int(a.get("axis", -1)))]


@register_converter("SoftmaxOutput")
def _softmax_output(node, inputs, a, out, ctx):
    # deploy-time semantics: plain softmax over the class axis
    return [_node("Softmax", inputs[:1], [out], node["name"], axis=1)]


_BINOP = {"broadcast_add": "Add", "elemwise_add": "Add",
          "_plus": "Add", "_Plus": "Add",
          "broadcast_sub": "Sub", "elemwise_sub": "Sub",
          "broadcast_mul": "Mul", "elemwise_mul": "Mul",
          "broadcast_div": "Div", "elemwise_div": "Div"}


@register_converter(*_BINOP)
def _binop(node, inputs, a, out, ctx):
    return [_node(_BINOP[node["op"]], inputs[:2], [out],
                  node["name"])]


@register_converter("Reshape")
def _reshape(node, inputs, a, out, ctx):
    shape_name = ctx.fresh(node["name"] + "_shape")
    ctx.initializers[shape_name] = _np.asarray(
        tuple(a.get("shape", ())), _np.int64)
    return [_node("Reshape", [inputs[0], shape_name], [out],
                  node["name"])]


@register_converter("transpose")
def _transpose(node, inputs, a, out, ctx):
    return [_node("Transpose", inputs[:1], [out], node["name"],
                  perm=tuple(int(x) for x in a.get("axes", ())))]


@register_converter("Pad")
def _pad(node, inputs, a, out, ctx):
    pw = tuple(int(x) for x in a.get("pad_width", ()))
    n = len(pw) // 2
    begins = pw[0::2]
    ends = pw[1::2]
    return [_node("Pad", inputs[:1], [out], node["name"],
                  mode=str(a.get("mode", "constant")),
                  pads=tuple(begins) + tuple(ends),
                  value=float(a.get("constant_value", 0.0)))]


@register_converter("mean")
def _mean(node, inputs, a, out, ctx):
    ax = a.get("axis", None)
    attrs = {"keepdims": 1 if a.get("keepdims", False) else 0}
    if ax is not None and ax != ():
        axes = (ax,) if isinstance(ax, int) else tuple(ax)
        attrs["axes"] = tuple(int(x) for x in axes)
    return [_node("ReduceMean", inputs[:1], [out], node["name"],
                  **attrs)]


# ---------------------------------------------------------------------------
# graph walk
# ---------------------------------------------------------------------------

def symbol_to_onnx_ir(sym, params, input_shapes):
    """Walk ``sym``'s JSON graph into the ONNX IR dict.

    params: name -> numpy array (arg + aux merged).
    input_shapes: name -> shape for the data inputs.
    Returns {"nodes", "initializers", "inputs", "outputs"}.
    """
    graph = json.loads(sym.tojson())
    nodes = graph["nodes"]

    def out_name(nid, idx):
        base = nodes[nid]["name"]
        return base if idx == 0 else "%s_out%d" % (base, idx)

    initializers = {}
    inputs = []
    ctx = _Ctx(initializers)
    ir_nodes = []
    for nid, node in enumerate(nodes):
        if node["op"] == "null":
            name = node["name"]
            if name in params:
                initializers[name] = _np.asarray(params[name])
            else:
                if name not in input_shapes:
                    raise MXNetError(
                        "ONNX export: no value or shape for input %r"
                        % name)
                inputs.append((name, tuple(input_shapes[name])))
            continue
        conv = MX2ONNX.get(node["op"])
        if conv is None:
            raise MXNetError(
                "ONNX export: no converter registered for op %r "
                "(supported: %s)" % (node["op"], sorted(MX2ONNX)))
        in_names = [out_name(i[0], i[1]) for i in node["inputs"]]
        attrs = normalize_attrs(get_op(node["op"]),
                                dict(node.get("attrs", {})))
        ir_nodes.extend(conv(node, in_names, attrs,
                             out_name(nid, 0), ctx))
    outputs = [out_name(h[0], h[1]) for h in graph["heads"]]
    return {"nodes": ir_nodes, "initializers": initializers,
            "inputs": inputs, "outputs": outputs}


def ir_to_onnx(ir, model_name="mxnet_tpu_model"):
    """Assemble an onnx.ModelProto from the IR. Requires the onnx
    package (gated; everything above this line runs without it)."""
    try:
        import onnx
        from onnx import helper, numpy_helper, TensorProto
    except ImportError:
        raise ImportError(
            "onnx is not available in this environment; "
            "symbol_to_onnx_ir still produced the full graph IR — "
            "install onnx to emit the .onnx file, or use "
            "HybridBlock.export()/SymbolBlock.imports() deploy pairs")
    nodes = [helper.make_node(n["op_type"], n["inputs"], n["outputs"],
                              name=n["name"], **n["attrs"])
             for n in ir["nodes"]]
    inits = [numpy_helper.from_array(v, name=k)
             for k, v in ir["initializers"].items()]
    inputs = [helper.make_tensor_value_info(
        n, TensorProto.FLOAT, list(s)) for n, s in ir["inputs"]]
    outputs = [helper.make_tensor_value_info(
        n, TensorProto.FLOAT, None) for n in ir["outputs"]]
    graph = helper.make_graph(nodes, model_name, inputs, outputs,
                              initializer=inits)
    model = helper.make_model(graph)
    onnx.checker.check_model(model)
    return model


def export_model(sym, params, input_shapes, onnx_file_path,
                 verbose=False):
    """The reference's export_model surface
    (mx2onnx/export_onnx.py): symbol + params + input shapes ->
    serialized .onnx file. Accepts a dict name->shape or a list of
    shapes matching the symbol's data inputs in order."""
    if not isinstance(input_shapes, dict):
        data_names = [n for n in sym.list_arguments()
                      if n not in params]
        input_shapes = dict(zip(data_names, input_shapes))
    np_params = {k: (v.asnumpy() if hasattr(v, "asnumpy")
                     else _np.asarray(v))
                 for k, v in params.items()}
    ir = symbol_to_onnx_ir(sym, np_params, input_shapes)
    model = ir_to_onnx(ir)
    # the shared durable-write discipline: never leave a truncated
    # .onnx on a preempted export
    atomic_write_bytes(onnx_file_path, model.SerializeToString())
    if verbose:
        print("exported", onnx_file_path)
    return onnx_file_path
