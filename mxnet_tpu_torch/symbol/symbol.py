"""Symbol — the symbolic graph IR (counterpart of
``mxnet_tpu/symbol/symbol.py``).

A Symbol is a list of output entries ``(node, index)`` into a DAG of op
nodes and variables. ``cached_op.build_graph_callable`` turns one into a
plan replayed over torch tensors (Gluon's ``hybridize``). Shape
inference walks the graph once: each op body runs on ``meta`` tensors
(shapes and dtypes, no data, no device) where the JAX package runs
``jax.eval_shape``; an op whose body cannot run there (it reaches a
kernel) registers an ``output_shapes`` rule; unknown learnable
parameters are resolved backward from the data by the hooks of
:mod:`.infer`. The JSON follows the nnvm graph format, so a graph
written by either package loads in the other.

``bind`` / ``simple_bind`` / ``eval`` bind the graph to arrays through
:class:`~mxnet_tpu_torch.executor.Executor`.
"""
from __future__ import annotations

import ast
import json
import os

import numpy as np
import torch

from ..base import MXNetError, numeric_types
from ..name import NameManager
from ..attribute import AttrScope
from .. import ops as _ops
from .infer import PARAM_SHAPE_HOOKS

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "zeros", "ones", "full", "arange", "pow", "maximum", "minimum",
           "hypot", "create"]


def _dtype_name(dtype):
    """A numpy dtype, its name or a torch dtype, as a dtype name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return dtype if isinstance(dtype, str) else np.dtype(dtype).name


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "_extra_attrs")

    def __init__(self, op, name, attrs, inputs):
        self.op = op                 # OpDef, or None for a variable
        self.name = name
        self.attrs = attrs or {}     # op attributes as given
        self.inputs = inputs or []   # [(node, output index)]
        self._extra_attrs = {}       # user attrs (__shape__, ctx_group, ...)

    def num_outputs(self):
        if self.op is None:
            return 1
        return self.op.resolve_num_outputs(
            _ops.normalize_attrs(self.op, self.attrs))

    def is_variable(self):
        return self.op is None


def _topo(entries):
    """Nodes reachable from the output entries, inputs first."""
    order, visited = [], set()

    def dfs(node):
        if id(node) in visited:
            return
        visited.add(id(node))
        for (n, _) in node.inputs:
            dfs(n)
        order.append(node)

    for (n, _) in entries:
        dfs(n)
    return order


class Symbol:
    """Symbolic graph handle: a list of output entries into a node DAG."""

    __array_priority__ = 1000.0

    def __init__(self, outputs):
        self._outputs = list(outputs)

    # -- identity --------------------------------------------------------
    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __repr__(self):
        if self.name is None:
            return "<%s group [%s]>" % (type(self).__name__, ", ".join(
                n.name for (n, _) in self._outputs))
        return "<%s %s>" % (type(self).__name__, self.name)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __len__(self):
        return len(self._outputs)

    def __getitem__(self, index):
        outputs = self.list_outputs()
        if isinstance(index, str):
            hits = [i for i, nm in enumerate(outputs) if nm == index]
            if not hits:
                raise ValueError("cannot find output %s" % index)
            if len(hits) > 1:
                raise ValueError("duplicate output name %s" % index)
            index = hits[0]
        if isinstance(index, slice):
            return Group([self[i]
                          for i in range(*index.indices(len(outputs)))])
        if index >= len(outputs):
            raise IndexError("index out of range")
        return Symbol([self._outputs[index]])

    # -- graph inspection ------------------------------------------------
    def _topo_nodes(self):
        return _topo(self._outputs)

    def _aux_node_ids(self):
        """Variables fed to a mutable input of an op (auxiliary states)."""
        aux = []
        for n in self._topo_nodes():
            if n.op is None:
                continue
            for idx in n.op.mutable_inputs:
                if idx < len(n.inputs) and n.inputs[idx][0].is_variable():
                    aux.append(id(n.inputs[idx][0]))
        return aux

    def list_arguments(self):
        aux = set(self._aux_node_ids())
        return [n.name for n in self._topo_nodes()
                if n.is_variable() and id(n) not in aux]

    def list_auxiliary_states(self):
        aux = set(self._aux_node_ids())
        return [n.name for n in self._topo_nodes()
                if n.is_variable() and id(n) in aux]

    def list_inputs(self):
        return [n.name for n in self._topo_nodes() if n.is_variable()]

    def list_outputs(self):
        names = []
        for (n, i) in self._outputs:
            if n.is_variable():
                names.append(n.name)
            elif n.num_outputs() == 1:
                names.append(n.name + "_output")
            else:
                names.append("%s_output%d" % (n.name, i))
        return names

    def get_internals(self):
        return Symbol([(n, i) for n in self._topo_nodes()
                       for i in range(n.num_outputs())])

    def get_children(self):
        """The inputs of this Symbol's output nodes, or None for a
        variable."""
        children = [e for (n, _) in self._outputs for e in n.inputs]
        return Symbol(children) if children else None

    # -- attributes ------------------------------------------------------
    def attr(self, key):
        """The attribute ``key`` of a single-output Symbol's node (a set
        attribute, else an op attribute as a string), or None."""
        if len(self._outputs) != 1:
            return None
        node = self._outputs[0][0]
        value = node._extra_attrs.get(key)
        if value is None and node.op is not None and key in node.attrs:
            value = str(node.attrs[key])
        return value

    def list_attr(self, recursive=False):
        """The attributes of this Symbol's node as strings (of every node
        by name with ``recursive``)."""
        if recursive:
            return self.attr_dict()
        node = self._outputs[0][0]
        out = {k: str(v) for k, v in node.attrs.items()}
        out.update(node._extra_attrs)
        return out

    def attr_dict(self):
        ret = {}
        for n in self._topo_nodes():
            d = {k: str(v) for k, v in n.attrs.items()}
            d.update(n._extra_attrs)
            if d:
                ret[n.name] = d
        return ret

    def _set_attr(self, **kwargs):
        self._outputs[0][0]._extra_attrs.update(kwargs)

    # -- shape/type inference -------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(argument shapes, output shapes, auxiliary shapes) from the
        given argument shapes; raises if an argument stays unknown."""
        arg_shapes, out_shapes, aux_shapes, unknown = \
            self._infer_shape_impl(*args, **kwargs)
        if unknown:
            raise MXNetError(
                "infer_shape: cannot determine shapes for argument(s) %s; "
                "provide them explicitly" % (unknown,))
        return arg_shapes, out_shapes, aux_shapes

    def infer_shape_partial(self, *args, **kwargs):
        """As :meth:`infer_shape`, with None where a shape stays
        unknown."""
        return self._infer_shape_impl(*args, **kwargs)[:3]

    def _infer_shape_impl(self, *args, **kwargs):
        known = {name: tuple(shape) for name, shape
                 in zip(self.list_arguments(), args) if shape is not None}
        known.update({k: tuple(v) for k, v in kwargs.items()
                      if v is not None})
        shapes = {}        # (id(node), index) -> shape or None
        dtypes = {}        # (id(node), index) -> torch dtype
        var_shape = {}
        unknown = []
        nodes = self._topo_nodes()
        for n in nodes:
            if n.is_variable():
                shape = known.get(n.name)
                if shape is None and n._extra_attrs.get("__shape__"):
                    shape = tuple(ast.literal_eval(
                        n._extra_attrs["__shape__"]))
                # a dim of 0 means unknown (Gluon's deferred init)
                if shape is not None and any(s == 0 for s in shape):
                    shape = None
                var_shape[id(n)] = shape
                shapes[(id(n), 0)] = shape
                dtypes[(id(n), 0)] = _torch_dtype(
                    n._extra_attrs.get("__dtype__") or "float32")
                continue
            nattrs = _ops.normalize_attrs(n.op, n.attrs)
            in_shapes = [shapes.get((id(s), i)) for (s, i) in n.inputs]
            hook = PARAM_SHAPE_HOOKS.get(n.op.name)
            if hook and any(s is None for s in in_shapes):
                try:
                    resolved = hook(nattrs, in_shapes)
                except (KeyError, TypeError, ValueError):
                    resolved = {}    # an attribute the hook needs is absent
                for i, shp in resolved.items():
                    if i < len(n.inputs) and in_shapes[i] is None:
                        src, sidx = n.inputs[i]
                        in_shapes[i] = shapes[(id(src), sidx)] = tuple(shp)
                        dtypes.setdefault((id(src), sidx), torch.float32)
                        if src.is_variable():
                            var_shape[id(src)] = tuple(shp)
            if any(s is None for s in in_shapes):
                unknown += [src.name for (src, _), s
                            in zip(n.inputs, in_shapes)
                            if s is None and src.is_variable()]
                for i in range(n.num_outputs()):
                    shapes[(id(n), i)] = None
                continue
            metas = [torch.empty(s, dtype=dtypes[(id(src), i)],
                                 device="meta")
                     for s, (src, i) in zip(in_shapes, n.inputs)]
            for i, (shape, dtype) in enumerate(_run_on_meta(n, nattrs,
                                                            metas)):
                shapes[(id(n), i)] = shape
                dtypes[(id(n), i)] = dtype
        aux = set(self._aux_node_ids())
        arg_shapes = [var_shape.get(id(n)) for n in nodes
                      if n.is_variable() and id(n) not in aux]
        aux_shapes = [var_shape.get(id(n)) for n in nodes
                      if n.is_variable() and id(n) in aux]
        out_shapes = [shapes.get((id(n), i)) for (n, i) in self._outputs]
        return arg_shapes, out_shapes, aux_shapes, sorted(set(unknown))

    def infer_type(self, *args, **kwargs):
        """(argument, output, auxiliary) dtypes: the given ones, else
        float32, as in the JAX package."""
        known = {name: np.dtype(dt) for name, dt
                 in zip(self.list_arguments(), args) if dt is not None}
        known.update({k: np.dtype(v) for k, v in kwargs.items()
                      if v is not None})
        f32 = np.dtype("float32")
        return ([known.get(n, f32) for n in self.list_arguments()],
                [f32] * len(self._outputs),
                [f32] * len(self.list_auxiliary_states()))

    # -- evaluation ------------------------------------------------------
    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """An :class:`~mxnet_tpu_torch.executor.Executor` over the given
        arrays (a list in ``list_arguments`` order or a name dict)."""
        from ..executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        group2ctx=group2ctx)

    def simple_bind(self, ctx, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        """Bind to zero arrays of the shapes inferred from ``kwargs``
        (argument shapes), with a gradient array for each argument whose
        ``grad_req`` is not ``null``."""
        from ..executor import Executor, _bind_context
        from ..ndarray import zeros
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        arg_names = self.list_arguments()
        type_dict = type_dict or {}
        dev = _bind_context(ctx)[0]
        args = [zeros(s, ctx=dev, dtype=type_dict.get(n, "float32"))
                for n, s in zip(arg_names, arg_shapes)]
        if isinstance(grad_req, str):
            reqs = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            reqs = dict(zip(arg_names, grad_req))
        else:
            reqs = {n: grad_req.get(n, "null") for n in arg_names}
        args_grad = {n: zeros(s, ctx=dev, dtype=type_dict.get(n, "float32"))
                     for n, s in zip(arg_names, arg_shapes)
                     if reqs.get(n, "null") != "null"}
        aux = [zeros(s, ctx=dev) for s in aux_shapes]
        return Executor(self, ctx, args, args_grad, reqs, aux,
                        group2ctx=group2ctx)

    def eval(self, ctx=None, **kwargs):
        """The outputs of one predict-mode forward over ``kwargs``."""
        from ..context import current_context
        ex = self.bind(ctx or current_context(), kwargs)
        return ex.forward()

    # -- serialization ---------------------------------------------------
    def tojson(self):
        nodes = self._topo_nodes()
        nid = {id(n): i for i, n in enumerate(nodes)}
        jnodes, arg_nodes = [], []
        for i, n in enumerate(nodes):
            if n.is_variable():
                arg_nodes.append(i)
            jn = {"op": "null" if n.is_variable() else n.op.name,
                  "name": n.name,
                  "inputs": [[nid[id(s)], idx, 0] for (s, idx) in n.inputs]}
            # a control-flow subgraph writes itself as "__subgraph__:"
            # + its JSON, the JAX package's form
            attrs = {k: (v.to_json_attr() if hasattr(v, "to_json_attr")
                         else str(v)) for k, v in n.attrs.items()}
            attrs.update(n._extra_attrs)
            if attrs:
                jn["attrs"] = attrs
            jnodes.append(jn)
        return json.dumps({
            "nodes": jnodes,
            "arg_nodes": arg_nodes,
            "node_row_ptr": list(range(len(jnodes) + 1)),
            "heads": [[nid[id(n)], i, 0] for (n, i) in self._outputs],
            "attrs": {"mxnet_version": ["int", 10500],
                      "framework": ["str", "mxnet_tpu_torch"]},
        }, indent=2)

    def save(self, fname):
        tmp = "%s.tmp%d" % (fname, os.getpid())
        with open(tmp, "w") as f:
            f.write(self.tojson())
        os.replace(tmp, fname)

    # -- composition -----------------------------------------------------
    def _binary(self, other, op, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            return create(op, [other, self] if reverse else [self, other],
                          {})
        if isinstance(other, numeric_types):
            name = _RSCALAR.get(scalar_op, scalar_op) if reverse \
                else scalar_op
            return create(name, [self], {"scalar": other})
        raise TypeError("type %s not supported" % str(type(other)))

    def __add__(self, other):
        return self._binary(other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binary(other, "broadcast_sub", "_minus_scalar", True)

    def __mul__(self, other):
        return self._binary(other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binary(other, "broadcast_div", "_div_scalar", True)

    def __pow__(self, other):
        return self._binary(other, "broadcast_power", "_power_scalar")

    def __mod__(self, other):
        return self._binary(other, "broadcast_mod", "_mod_scalar")

    def __neg__(self):
        return create("negative", [self], {})

    def __abs__(self):
        return create("abs", [self], {})

    def __eq__(self, other):
        return self._binary(other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        return self._binary(other, "broadcast_not_equal",
                            "_not_equal_scalar")

    def __gt__(self, other):
        return self._binary(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binary(other, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binary(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binary(other, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if not shape:
            shape = kwargs.get("shape")
        return create("Reshape", [self],
                      {"shape": tuple(shape),
                       "reverse": kwargs.get("reverse", False)})

    def sum(self, axis=None, keepdims=False):
        return create("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return create("mean", [self], {"axis": axis, "keepdims": keepdims})

    def astype(self, dtype):
        return create("Cast", [self], {"dtype": _dtype_name(dtype)})

    def swapaxes(self, dim1, dim2):
        return create("SwapAxis", [self], {"dim1": dim1, "dim2": dim2})

    def softmax(self, axis=-1):
        return create("softmax", [self], {"axis": axis})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return create("transpose", [self], {"axes": axes or None})

    def flatten(self):
        return create("Flatten", [self], {})

    def slice_axis(self, axis, begin, end):
        return create("slice_axis", [self],
                      {"axis": axis, "begin": begin, "end": end})

    def expand_dims(self, axis):
        return create("expand_dims", [self], {"axis": axis})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return create("dot", [self, other], {"transpose_a": transpose_a,
                                             "transpose_b": transpose_b})


_RSCALAR = {"_minus_scalar": "_rminus_scalar", "_div_scalar": "_rdiv_scalar",
            "_mod_scalar": "_rmod_scalar", "_power_scalar": "_rpower_scalar"}


def _torch_dtype(name):
    from ..ndarray.ndarray import torch_dtype
    return torch_dtype(name)


def _run_on_meta(node, nattrs, metas):
    """[(shape, dtype)] of ``node``'s outputs from its body on ``meta``
    tensors, or its ``output_shapes`` rule."""
    op = node.op
    try:
        if op.output_shapes is not None:
            return [(tuple(s), d) for s, d in op.output_shapes(nattrs, *metas)]
        with torch.no_grad():
            if op.needs_rng:
                out = op.forward(nattrs, *metas, rng=None)
            else:
                out = op.forward(nattrs, *metas)
    except Exception as e:
        raise MXNetError("infer_shape failed at op %s(%s): %s"
                         % (op.name, node.name, e))
    if not isinstance(out, (tuple, list)):
        out = (out,)
    return [(tuple(o.shape), o.dtype)
            for o in out[:node.num_outputs()]]


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def create(op_name, input_syms, attrs, name=None):
    """A Symbol applying ``op_name`` to ``input_syms`` (the role of
    MXSymbolCreateAtomicSymbol + composition). Missing learnable inputs
    become variables named ``<name>_<input>``, as nnvm's Compose does."""
    op = _ops.get_op(op_name) if isinstance(op_name, str) else op_name
    attrs = {k: v for k, v in attrs.items() if v is not None}
    name = NameManager.current().get(name, op.name.lower().strip("_"))
    entries = []
    for s in input_syms:
        if not isinstance(s, Symbol):
            raise TypeError("inputs must be Symbols, got %s" % type(s))
        entries.extend(s._outputs)   # a multi-output Symbol fills slots
    if op.key_var_num_args:
        # a variadic op takes what it is given: num_args counts it
        attrs.setdefault(op.key_var_num_args, len(entries))
    else:
        full_names = op.resolve_arg_names(attrs)
        while len(entries) < len(full_names):
            vnode = _Node(None, "%s_%s" % (name, full_names[len(entries)]),
                          {}, [])
            vnode._extra_attrs = dict(AttrScope.current().get(None))
            entries.append((vnode, 0))
    node = _Node(op, name, attrs, entries)
    node._extra_attrs = dict(AttrScope.current().get(None))
    return Symbol([(node, i) for i in range(node.num_outputs())])


def var(name, attr=None, shape=None, lr_mult=None, wd_mult=None, dtype=None,
        init=None, stype=None, **kwargs):
    """A variable symbol (reference: symbol.py var/Variable)."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    node = _Node(None, name, {}, [])
    extra = dict(AttrScope.current().get(attr))
    if shape is not None:
        extra["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        extra["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        extra["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        extra["__dtype__"] = _dtype_name(dtype)
    if init is not None:
        extra["__init__"] = init if isinstance(init, str) else init.dumps()
    for k, v in kwargs.items():
        if k.startswith("__") and k.endswith("__"):
            extra[k] = str(v)
    node._extra_attrs = extra
    return Symbol([(node, 0)])


Variable = var


def Group(symbols):
    """One Symbol whose outputs are those of ``symbols``, in order."""
    return Symbol([e for s in symbols for e in s._outputs])


def load(fname):
    with open(fname, "r") as f:
        return load_json(f.read())


def load_json(json_str):
    """A Symbol from nnvm-format JSON (either package's ``tojson``)."""
    data = json.loads(json_str)
    nodes = []
    for jn in data["nodes"]:
        attrs = dict(jn.get("attrs", jn.get("param", {})))
        if jn["op"] == "null":
            node = _Node(None, jn["name"], {}, [])
            node._extra_attrs = attrs
        else:
            op = _ops.get_op(jn["op"])
            op_attrs = {k: v for k, v in attrs.items()
                        if not k.startswith("__") and k != "ctx_group"}
            parsed = _ops.normalize_attrs(op, op_attrs)
            node = _Node(op, jn["name"], {k: parsed[k] for k in op_attrs},
                         [(nodes[e[0]], e[1]) for e in jn["inputs"]])
            node._extra_attrs = {k: v for k, v in attrs.items()
                                 if k not in op_attrs}
        nodes.append(node)
    return Symbol([(nodes[h[0]], h[1]) for h in data["heads"]])


def _symbol_from_tape(x):
    """The Symbol of the ops recorded into ``x`` (``autograd.get_symbol``;
    the JAX package walks its tape, the port the notes ``invoke_nd``
    leaves on outputs made under ``record()``). An array with no note is
    a variable, named after its Gluon parameter where it is one's data
    (so the Symbol binds with the block's parameters), else ``var<i>``
    in the order the walk meets it."""
    memo = {}
    counter = [0]

    def leaf(arr):
        key = ("leaf", id(arr))
        if key not in memo:
            name = getattr(arr, "_param_name", None)
            if name is None:
                name = "var%d" % counter[0]
                counter[0] += 1
            memo[key] = _Node(None, name, {}, [])
        return memo[key]

    def conv(entry):
        note, index = entry
        if not isinstance(note, _TapeNote):
            return (leaf(note), 0)
        if id(note) not in memo:
            inputs = [conv(e) for e in note.inputs]
            memo[id(note)] = _Node(
                note.op, "%s%d" % (note.op.name.lower().strip("_"),
                                   counter[0]),
                dict(note.attrs), inputs)
            counter[0] += 1
        return (memo[id(note)], index)

    entry = getattr(x, "_tape", None)
    return Symbol([conv(entry if entry is not None else (x, 0))])


class _TapeNote:
    """One recorded op invocation: the op, its attributes and, per
    input, ``(note, output index)`` of the op that made it or ``(input
    array, 0)`` for an array no recorded op made. Its outputs hold it as
    ``NDArray._tape``; it holds no tensor of its own."""

    __slots__ = ("op", "attrs", "inputs")

    def __init__(self, op, attrs, inputs):
        self.op = op
        self.attrs = attrs
        self.inputs = [getattr(i, "_tape", None) or (i, 0) for i in inputs]


def zeros(shape, dtype="float32", name=None, **kwargs):
    """A Symbol of zeros (the ``_zeros`` op)."""
    return create("_zeros", [], {"shape": tuple(shape), "dtype": dtype},
                  name=name)


def ones(shape, dtype="float32", name=None, **kwargs):
    return create("_ones", [], {"shape": tuple(shape), "dtype": dtype},
                  name=name)


def full(shape, val, dtype="float32", name=None, **kwargs):
    return create("_full", [], {"shape": tuple(shape), "value": val,
                                "dtype": dtype}, name=name)


def arange(start, stop=None, step=1.0, repeat=1, dtype="float32",
           name=None, **kwargs):
    return create("_arange", [], {"start": start, "stop": stop,
                                  "step": step, "repeat": repeat,
                                  "dtype": dtype}, name=name)


def pow(base, exp):
    if isinstance(base, Symbol):
        return base.__pow__(exp)
    raise TypeError("pow: unsupported types")


def _sym_or_scalar(lhs, rhs, op, scalar_op):
    if isinstance(lhs, Symbol) and isinstance(rhs, Symbol):
        return create(op, [lhs, rhs], {})
    if isinstance(lhs, Symbol):
        return create(scalar_op, [lhs], {"scalar": rhs})
    return create(scalar_op, [rhs], {"scalar": lhs})


def maximum(lhs, rhs):
    return _sym_or_scalar(lhs, rhs, "broadcast_maximum", "_maximum_scalar")


def minimum(lhs, rhs):
    return _sym_or_scalar(lhs, rhs, "broadcast_minimum", "_minimum_scalar")


def hypot(lhs, rhs):
    return create("broadcast_hypot", [lhs, rhs], {})
