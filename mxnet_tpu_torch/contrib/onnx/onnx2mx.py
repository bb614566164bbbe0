"""ONNX -> Symbol import (parity:
python/mxnet/contrib/onnx/onnx2mx/import_onnx.py;
counterpart of ``mxnet_tpu/contrib/onnx/onnx2mx.py``).

``ir_to_symbol`` consumes the same plain-dict graph IR that
``mx2onnx.symbol_to_onnx_ir`` emits — so export->import round-trips
are testable without the onnx package. ``import_model`` reads a real
.onnx file (gated on ``import onnx``) by first lowering the proto to
the IR dict, then reusing the same reconstruction.
"""
from __future__ import annotations

import numpy as _np

from ...base import MXNetError

__all__ = ["ir_to_symbol", "import_model", "onnx_to_ir"]


def _p(attrs, key, default=None):
    return attrs.get(key, default)


def ir_to_symbol(ir):
    """Rebuild (sym, arg_params, aux_params) from the ONNX graph IR."""
    from ... import symbol as sym_mod
    from ...ndarray import array as nd_array

    values = {}                       # onnx tensor name -> Symbol
    inits = ir["initializers"]
    for name, _shape in ir["inputs"]:
        values[name] = sym_mod.var(name)
    param_syms = {}

    def sym_of(name):
        if name in values:
            return values[name]
        if name in inits:
            if name not in param_syms:
                param_syms[name] = sym_mod.var(name)
            return param_syms[name]
        raise MXNetError("ONNX import: undefined tensor %r" % name)

    arg_params = {}
    aux_params = {}
    for node in ir["nodes"]:
        op = node["op_type"]
        a = node["attrs"]
        ins = node["inputs"]
        out = node["outputs"][0]
        name = node["name"]
        if op == "Conv":
            ph, pw = a["pads"][0], a["pads"][1]
            res = sym_mod.create("Convolution",
                                 [sym_of(x) for x in ins],
                                 {"kernel": tuple(a["kernel_shape"]),
                                  "stride": tuple(a["strides"]),
                                  "dilate": tuple(a.get(
                                      "dilations", (1, 1))),
                                  "pad": (ph, pw),
                                  "num_group": int(a.get("group", 1)),
                                  "num_filter": int(
                                      inits[ins[1]].shape[0]),
                                  "no_bias": len(ins) < 3},
                                 name=name)
        elif op == "BatchNormalization":
            res = sym_mod.create("BatchNorm",
                                 [sym_of(x) for x in ins],
                                 {"eps": float(a.get("epsilon", 1e-5)),
                                  "momentum": float(a.get(
                                      "momentum", 0.9)),
                                  "fix_gamma": False},
                                 name=name)
            for aux_name in ins[3:5]:     # mean, var are aux state
                if aux_name in inits:
                    aux_params[aux_name] = nd_array(inits[aux_name])
        elif op in ("Relu", "Sigmoid", "Tanh", "Softplus", "Softsign"):
            act = {"Relu": "relu", "Sigmoid": "sigmoid",
                   "Tanh": "tanh", "Softplus": "softrelu",
                   "Softsign": "softsign"}[op]
            res = sym_mod.create("Activation", [sym_of(ins[0])],
                                 {"act_type": act}, name=name)
        elif op in ("MaxPool", "AveragePool"):
            ph, pw = a["pads"][0], a["pads"][1]
            res = sym_mod.create(
                "Pooling", [sym_of(ins[0])],
                {"kernel": tuple(a["kernel_shape"]),
                 "stride": tuple(a.get("strides", (1, 1))),
                 "pad": (ph, pw),
                 "pool_type": "max" if op == "MaxPool" else "avg"},
                name=name)
        elif op in ("GlobalMaxPool", "GlobalAveragePool"):
            res = sym_mod.create(
                "Pooling", [sym_of(ins[0])],
                {"kernel": (1, 1), "global_pool": True,
                 "pool_type": "max" if op == "GlobalMaxPool"
                 else "avg"}, name=name)
        elif op == "Flatten":
            res = sym_mod.create("Flatten", [sym_of(ins[0])], {},
                                 name=name)
        elif op == "Gemm":
            assert int(a.get("transB", 0)) == 1, \
                "ONNX import: only transB=1 Gemm supported"
            res = sym_mod.create(
                "FullyConnected", [sym_of(x) for x in ins],
                {"num_hidden": int(inits[ins[1]].shape[0]),
                 "no_bias": len(ins) < 3, "flatten": False},
                name=name)
        elif op == "Concat":
            res = sym_mod.create("Concat", [sym_of(x) for x in ins],
                                 {"dim": int(a.get("axis", 1)),
                                  "num_args": len(ins)}, name=name)
        elif op == "Dropout":
            res = sym_mod.create("Dropout", [sym_of(ins[0])],
                                 {"p": float(a.get("ratio", 0.5))},
                                 name=name)
        elif op == "Clip":
            res = sym_mod.create("clip", [sym_of(ins[0])],
                                 {"a_min": float(a.get("min", 0.0)),
                                  "a_max": float(a.get("max", 1.0))},
                                 name=name)
        elif op == "Softmax":
            res = sym_mod.create("softmax", [sym_of(ins[0])],
                                 {"axis": int(a.get("axis", -1))},
                                 name=name)
        elif op in ("Add", "Sub", "Mul", "Div"):
            mxop = {"Add": "broadcast_add", "Sub": "broadcast_sub",
                    "Mul": "broadcast_mul",
                    "Div": "broadcast_div"}[op]
            res = sym_mod.create(mxop, [sym_of(x) for x in ins], {},
                                 name=name)
        elif op == "Reshape":
            shape = tuple(int(s) for s in inits[ins[1]])
            res = sym_mod.create("Reshape", [sym_of(ins[0])],
                                 {"shape": shape}, name=name)
        elif op == "Transpose":
            res = sym_mod.create("transpose", [sym_of(ins[0])],
                                 {"axes": tuple(a.get("perm", ()))},
                                 name=name)
        elif op == "ReduceMean":
            res = sym_mod.create(
                "mean", [sym_of(ins[0])],
                {"axis": tuple(a.get("axes", ())) or None,
                 "keepdims": bool(a.get("keepdims", 0))}, name=name)
        elif op == "Pad":
            res = sym_mod.create(
                "Pad", [sym_of(ins[0])],
                {"mode": str(a.get("mode", "constant")),
                 "pad_width": tuple(
                     x for pair in zip(
                         a["pads"][:len(a["pads"]) // 2],
                         a["pads"][len(a["pads"]) // 2:])
                     for x in pair),
                 "constant_value": float(a.get("value", 0.0))},
                name=name)
        else:
            raise MXNetError(
                "ONNX import: unsupported op_type %r" % op)
        values[out] = res

    heads = [values[o] for o in ir["outputs"]]
    out_sym = heads[0] if len(heads) == 1 \
        else sym_mod.Group(heads)
    aux_names = set(out_sym.list_auxiliary_states())
    for pname, psym in param_syms.items():
        del psym
        if pname in aux_params:
            continue
        target = aux_params if pname in aux_names else arg_params
        target[pname] = nd_array(inits[pname])
    return out_sym, arg_params, aux_params


def onnx_to_ir(model):
    """Lower an onnx.ModelProto to the plain-dict graph IR."""
    from onnx import numpy_helper
    g = model.graph
    inits = {t.name: numpy_helper.to_array(t) for t in g.initializer}
    nodes = []
    for n in g.node:
        attrs = {}
        for att in n.attribute:
            import onnx as _onnx
            attrs[att.name] = _onnx.helper.get_attribute_value(att)
            if isinstance(attrs[att.name], bytes):
                attrs[att.name] = attrs[att.name].decode()
        nodes.append({"op_type": n.op_type, "inputs": list(n.input),
                      "outputs": list(n.output), "name": n.name,
                      "attrs": attrs})
    inputs = []
    for vi in g.input:
        if vi.name in inits:
            continue
        shape = tuple(d.dim_value
                      for d in vi.type.tensor_type.shape.dim)
        inputs.append((vi.name, shape))
    return {"nodes": nodes, "initializers": inits, "inputs": inputs,
            "outputs": [o.name for o in g.output]}


def import_model(model_file):
    """Read a .onnx file -> (sym, arg_params, aux_params). Requires the
    onnx package (the IR reconstruction itself does not)."""
    try:
        import onnx
    except ImportError:
        raise ImportError(
            "onnx is not available in this environment; use "
            "SymbolBlock.imports on a HybridBlock.export deploy pair "
            "instead")
    model = onnx.load(model_file)
    return ir_to_symbol(onnx_to_ir(model))
