"""Operator registry (counterpart of ``mxnet_tpu/ops/registry.py``).

An op's body is ONE torch function ``forward(attrs, *inputs)`` over
tensors; torch autograd differentiates it, so there is no per-op
gradient registration. What is registered per op: the body, the input
names, the number of outputs, the RNG need, the mutable inputs (an op
returns its outputs followed by the new values of its mutable inputs:
BatchNorm's moving statistics), and the attribute defaults, docs and
ranges (the dmlc ``Parameter`` struct role). Output shapes come from
running the body on ``meta`` tensors (``symbol.Symbol.infer_shape``); an
op whose body cannot run there registers ``output_shapes``.
:func:`invoke` merges the defaults, parses string-typed values,
range-checks and calls the body eagerly: the JAX package's
per-signature ``jax.jit`` cache has no counterpart here.

**Over the in-process mesh** (``parallel.mesh.DeviceMesh``, a context
list on distinct devices): :func:`call` runs an op whose inputs hold a
split ``MeshTensor`` by the op's mesh rule, so that the result is what
one device computes on the whole batch:

- *local* (elementwise, convolution, pooling, FC, activations, softmax
  over a non-batch axis, per-sample losses, ``_contrib_flash_attention``
  ...): the body runs once a shard, on that shard's device, over the
  shard and a differentiable copy of every other input (a parameter's
  copy: autograd adds the shards' gradients into the master's);
- *special* (``OpDef.mesh_impl``: training BatchNorm's global moments,
  Dropout's draw of the whole mask): the op's own mesh form;
- *native* (``mesh="native"``: a CachedOp's plan) runs its nodes itself,
  each through :func:`call`, in lockstep over the shards;
- anything else GATHERS: the inputs joined on the mesh's first device,
  the body run whole, an output that keeps the batch axis split again.
  Right for every op; each gather counts under its op's name in
  :func:`mesh_stats`.
"""
from __future__ import annotations

import ast

from ..base import MXNetError, Registry

__all__ = ["OpDef", "register", "get_op", "find_op", "list_ops", "invoke",
           "normalize_attrs", "attr_key", "call", "mesh_stats",
           "reset_mesh_stats", "install_mesh_rules"]

_OP_REGISTRY = Registry("operator")


class OpDef:
    """A registered operator.

    - ``forward(attrs, *inputs, rng=None) -> tensor | tuple`` over torch
      tensors; with ``mutable_inputs`` the tuple carries the
      ``num_outputs`` outputs, then one new value per mutable input;
    - ``arg_names``: tensor input names (``arg_names_fn(attrs)`` when
      they depend on the attributes, e.g. ``no_bias``);
    - ``defaults``: attribute name → default value;
    - ``num_outputs``: int, or ``attrs -> int``;
    - ``key_var_num_args``: the attribute that holds a variadic op's
      input count (Concat's ``num_args``); its inputs are then named
      ``<arg_names[0]><i>`` (``arg0``, ``arg1``, ...), as nnvm's
      ``key_var_num_args`` names them;
    - ``needs_rng``: the body takes ``rng=``, a ``torch.Generator``;
    - ``draws``: ``(attrs, is_train) -> bool``, whether an op that
      ``needs_rng`` draws for these attributes in that mode (Dropout
      draws only in training or with ``mode="always"``); an op without
      it draws whenever it runs;
    - ``host_code``: ``attrs -> bool`` (or a bool), whether a run calls
      user Python that may read device values on the host (``Custom``,
      or a control-flow op whose subgraph holds one): a program holder
      runs a plan holding such an op op by op, never as a CUDA graph;
    - ``mutable_inputs``: indices of the inputs the op updates
      (FMutateInputs; a Symbol lists their variables as auxiliary
      states);
    - ``output_shapes``: ``(attrs, *inputs) -> [(shape, dtype), ...]``
      for an op whose body cannot run on ``meta`` tensors (it reaches a
      kernel), used by shape inference in place of the body;
    - ``attr_docs`` / ``attr_ranges``: per-attribute documentation and
      ``(lo, hi)`` bounds, checked at invoke;
    - ``mesh``: the op's mesh rule (module docstring), ``"native"`` for
      a program that runs its own nodes through :func:`call`, or a
      function ``(op, attrs, vals) -> axes``: the split axis of each
      output (None for one the shards share: the first shard's is
      taken), optionally as ``(axes, shard_attrs)`` with
      ``shard_attrs(k, inputs)`` a shard's attributes, or None where the
      op must gather; without one the op takes its name's entry of
      :func:`install_mesh_rules`' table;
    - ``mesh_impl``: ``(attrs, vals, rng, mesh) -> outputs``, the op's
      own form over split inputs, NotImplemented to fall back on the
      rule."""

    def __init__(self, name, forward, arg_names=("data",), defaults=None,
                 num_outputs=1, arg_names_fn=None, description="",
                 attr_docs=None, attr_ranges=None, needs_rng=False,
                 mutable_inputs=(), output_shapes=None, key_var_num_args=None,
                 draws=None, host_code=False, mesh=None, mesh_impl=None):
        self.name = name
        self.forward = forward
        self.arg_names = list(arg_names)
        self.defaults = dict(defaults or {})
        self.num_outputs = num_outputs
        self.arg_names_fn = arg_names_fn
        self.key_var_num_args = key_var_num_args
        self.needs_rng = bool(needs_rng)
        self._draws = draws
        self._host_code = host_code
        self.mutable_inputs = tuple(mutable_inputs)
        self.output_shapes = output_shapes
        self.description = description or (forward.__doc__ or "")
        self.attr_docs = dict(attr_docs or {})
        self.attr_ranges = dict(attr_ranges or {})
        self.mesh = mesh
        self.mesh_impl = mesh_impl

    def doc_signature(self):
        """Signature + parameter table for the generated stubs."""
        lines = ["%s(%s, **attrs)" % (self.name, ", ".join(self.arg_names)),
                 ""]
        if self.description:
            lines += [self.description.strip(), ""]
        if self.defaults:
            lines += ["Parameters", "----------"]
            for key, default in self.defaults.items():
                if key.startswith("__"):
                    continue
                entry = "%s : default %r" % (key, default)
                if key in self.attr_ranges:
                    entry += ", range %s" % (self.attr_ranges[key],)
                lines.append(entry)
                if key in self.attr_docs:
                    lines.append("    " + self.attr_docs[key])
        return "\n".join(lines)

    def validate_attrs(self, nattrs):
        """Range checks (dmlc set_range role)."""
        for key, (lo, hi) in self.attr_ranges.items():
            val = nattrs.get(key)
            if val is None or not isinstance(val, (int, float)):
                continue
            if (lo is not None and val < lo) or \
                    (hi is not None and val > hi):
                raise MXNetError(
                    "%s: attribute %s=%r outside valid range [%s, %s]"
                    % (self.name, key, val, lo, hi))

    def resolve_num_outputs(self, attrs):
        if callable(self.num_outputs):
            return self.num_outputs(attrs)
        return self.num_outputs

    def draws_in(self, attrs, is_train):
        """Whether a run with these (normalized) attributes in this
        train mode draws random numbers."""
        if not self.needs_rng:
            return False
        return True if self._draws is None else \
            bool(self._draws(attrs, is_train))

    def runs_host_code(self, attrs):
        """Whether a run with these (normalized) attributes calls user
        Python (see ``host_code``)."""
        hc = self._host_code
        return bool(hc(attrs)) if callable(hc) else bool(hc)

    def resolve_arg_names(self, attrs, num_inputs=None):
        if self.key_var_num_args:
            n = int(attrs.get(self.key_var_num_args,
                              num_inputs if num_inputs is not None else 1))
            base = self.arg_names[0] if self.arg_names else "arg"
            return ["%s%d" % (base, i) for i in range(n)]
        if self.arg_names_fn is not None:
            return list(self.arg_names_fn(normalize_attrs(self, attrs)))
        return list(self.arg_names)

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register(name, forward=None, *, aliases=(), **kwargs):
    """Register an operator; usable as a function or a decorator."""
    def _do(fwd):
        op = OpDef(name, fwd, **kwargs)
        _OP_REGISTRY.register(name)(op)
        for alias in aliases:
            _OP_REGISTRY.register(alias)(op)
        return op
    if forward is not None:
        return _do(forward)
    return _do


def get_op(name):
    try:
        return _OP_REGISTRY.get(name)
    except KeyError:
        raise MXNetError("Operator '%s' is not registered" % name)


def find_op(name):
    return _OP_REGISTRY.find(name)


def list_ops():
    return sorted(_OP_REGISTRY.keys())


_BOOL_STR = {"true": True, "True": True, "1": True,
             "false": False, "False": False, "0": False}


def _parse_attr_value(v):
    if not isinstance(v, str):
        return v
    if v in _BOOL_STR:
        return _BOOL_STR[v]
    if v == "None":
        return None
    if v.startswith("__subgraph__:"):
        from .control_flow import Subgraph
        return Subgraph.from_json_attr(v)
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def normalize_attrs(op, attrs):
    """Merge with the defaults, parse string-typed values and
    range-check (dmlc ``Parameter::Init`` + ``set_range``)."""
    out = dict(op.defaults)
    for key, value in attrs.items():
        if value is None and key in out:
            continue
        out[key] = _parse_attr_value(value)
    if op.attr_ranges:
        op.validate_attrs(out)
    return out


def _hashable(v):
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    return v


def attr_key(attrs):
    """A hashable, order-free key of an attribute dict."""
    return tuple(sorted((k, _hashable(v)) for k, v in attrs.items()))


def invoke(op, inputs, attrs, rng=None):
    """Run ``op`` eagerly on torch tensors (or ``MeshTensor`` s: see
    :func:`call`); returns ``(outputs, aux_updates)``: the tuple of its
    outputs and a list of ``(input index, new value)`` for its mutable
    inputs."""
    nattrs = normalize_attrs(op, attrs)
    result = call(op, nattrs, inputs, rng)
    if not isinstance(result, (tuple, list)):
        result = (result,)
    n_out = op.resolve_num_outputs(nattrs)
    return (tuple(result[:n_out]),
            list(zip(op.mutable_inputs, result[n_out:])))


# ---------------------------------------------------------------------------
# the in-process mesh
# ---------------------------------------------------------------------------

_MESH_TYPE = []
_MESH_GATHERS = {}
_MESH_LOCKSTEP = {}
_MESH_RULES = {}


def _mesh_tensor():
    if not _MESH_TYPE:
        from ..parallel.mesh import MeshTensor
        _MESH_TYPE.append(MeshTensor)
    return _MESH_TYPE[0]


def _forward(op, attrs, vals, rng):
    if op.needs_rng:
        return op.forward(attrs, *vals, rng=rng)
    return op.forward(attrs, *vals)


def call(op, attrs, vals, rng=None):
    """``op``'s body over normalized ``attrs`` and ``vals``: torch
    tensors, or ``MeshTensor`` s, which go by the op's mesh rule (module
    docstring). Returns what the body returns."""
    mt = _mesh_tensor()
    if not any(type(v) is mt for v in vals):
        return _forward(op, attrs, vals, rng)
    # a replicated value is one tensor, on the mesh's first device
    vals = [v.shards[0] if type(v) is mt and v.axis is None else v
            for v in vals]
    split = [v for v in vals if type(v) is mt]
    if not split:
        return _forward(op, attrs, vals, rng)
    if op.mesh == "native":
        note_lockstep(op.name)
        return _forward(op, attrs, vals, rng)
    mesh = split[0].mesh
    if any(v.mesh is not mesh for v in split):
        return _gathered(op, attrs, vals, rng, mesh)
    if op.mesh_impl is not None:
        out = op.mesh_impl(attrs, vals, rng, mesh)
        if out is not NotImplemented:
            return out
    is_train = bool(attrs.get("__train__", False))
    axes = None
    if not op.draws_in(attrs, is_train) and not op.runs_host_code(attrs):
        rule = op.mesh if op.mesh is not None else _MESH_RULES.get(op.name)
        if rule is not None:
            axes = rule(op, attrs, vals)
    if axes is None:
        return _gathered(op, attrs, vals, rng, mesh)
    shard_attrs = None
    if isinstance(axes, tuple):
        axes, shard_attrs = axes
    return _local(op, attrs, vals, rng, mesh, axes, shard_attrs)


def _local(op, attrs, vals, rng, mesh, axes, shard_attrs):
    """The body once a shard, each on its own device."""
    mt = _mesh_tensor()
    per, single = [], False
    for k, dev in enumerate(mesh.devices):
        ins = [v.shards[k] if type(v) is mt else v.to(dev) for v in vals]
        a = attrs if shard_attrs is None else shard_attrs(k, ins)
        out = _forward(op, a, ins, rng)
        single = not isinstance(out, (tuple, list))
        per.append((out,) if single else out)
    n_out = op.resolve_num_outputs(attrs)
    outs = [per[0][i] if axes[i] is None
            else mt([p[i] for p in per], mesh, axes[i])
            for i in range(n_out)]
    # a mutable input's new value: the same on every shard (a local
    # op's update does not read the batch)
    outs += list(per[0][n_out:])
    return outs[0] if single else tuple(outs)


def _gathered(op, attrs, vals, rng, mesh):
    """The body over the whole inputs on the first device; an output
    that keeps the batch axis is split again. Counted."""
    mt = _mesh_tensor()
    _MESH_GATHERS[op.name] = _MESH_GATHERS.get(op.name, 0) + 1
    ref = next(v for v in vals if type(v) is mt)
    axis, size = ref.axis, ref.shape[ref.axis]
    out = _forward(op, attrs, [v.full() if type(v) is mt else v
                               for v in vals], rng)
    single = not isinstance(out, (tuple, list))
    outs = [out] if single else list(out)
    n_out = op.resolve_num_outputs(attrs)
    for i in range(n_out):
        o = outs[i]
        if o.dim() > axis and o.shape[axis] == size \
                and size % mesh.size == 0:
            outs[i] = mesh.split(o, axis)
    return outs[0] if single else tuple(outs)


def mesh_stats():
    """``{"gathers": {op name: count}, "lockstep": {program: count}}``:
    the ops that ran whole on the mesh's first device because they have
    no mesh rule (or their attributes fall outside it), and the programs
    (a CachedOp's plan, an executor's) run node by node over the shards."""
    return {"gathers": dict(_MESH_GATHERS),
            "lockstep": dict(_MESH_LOCKSTEP)}


def reset_mesh_stats():
    _MESH_GATHERS.clear()
    _MESH_LOCKSTEP.clear()


def note_lockstep(name):
    """Count one run of the program ``name`` over the mesh's shards."""
    _MESH_LOCKSTEP[name] = _MESH_LOCKSTEP.get(name, 0) + 1


def _split_of(vals):
    """``(axis, global size)`` of the split inputs when they agree, else
    None."""
    mt = _mesh_tensor()
    axis = size = None
    for v in vals:
        if type(v) is mt:
            if axis is None:
                axis, size = v.axis, v.shape[v.axis]
            elif (v.axis, v.shape[v.axis]) != (axis, size):
                return None
    return axis, size


def _elementwise(op, attrs, vals):
    """Broadcasting elementwise ops: local when every split input's axis
    lands on one output axis and no other input has more than 1 there."""
    mt = _mesh_tensor()
    out_nd = max(v.dim() for v in vals)
    oa = None
    for v in vals:
        if type(v) is mt:
            a = v.axis + out_nd - v.dim()
            if oa is not None and a != oa:
                return None
            oa = a
    if _split_of(vals) is None:
        return None
    for v in vals:
        if type(v) is not mt:
            i = oa - (out_nd - v.dim())
            if i >= 0 and v.shape[i] != 1:
                return None
    return [oa] * op.resolve_num_outputs(attrs)


def _batch_local(axes_ok=(0,)):
    """Ops whose every output row comes from the same input rows: local
    when the split inputs share an axis in ``axes_ok`` (a callable of
    ``(attrs, ndim)`` for attribute-dependent ones)."""
    def rule(op, attrs, vals):
        got = _split_of(vals)
        if got is None:
            return None
        ndim = next(v.dim() for v in vals if type(v) is _mesh_tensor())
        ok = axes_ok(attrs, ndim) if callable(axes_ok) else axes_ok
        if got[0] not in ok:
            return None
        return [got[0]] * op.resolve_num_outputs(attrs)
    return rule


def _not_axis(key, default):
    """Local when the attribute ``key`` (an axis) is not the split
    axis."""
    def rule(op, attrs, vals):
        got = _split_of(vals)
        if got is None:
            return None
        ndim = next(v.dim() for v in vals if type(v) is _mesh_tensor())
        ax = attrs.get(key, default)
        if ax is None:
            return None
        axes = ax if isinstance(ax, (tuple, list)) else (ax,)
        if got[0] in [int(x) % ndim for x in axes]:
            return None
        return [got[0]] * op.resolve_num_outputs(attrs)
    return rule


def _reduce(op, attrs, vals):
    got = _split_of(vals)
    if got is None:
        return None
    a, nd = got[0], vals[0].dim()
    axis = attrs.get("axis", None)
    if axis is None or axis == ():
        axes = tuple(range(nd))
    elif isinstance(axis, int):
        axes = (axis % nd,)
    else:
        axes = tuple(int(x) % nd for x in axis)
    if attrs.get("exclude", False):
        axes = tuple(i for i in range(nd) if i not in axes)
    if a in axes or not axes:
        return None if a in axes else [a]
    if attrs.get("keepdims", False):
        return [a]
    return [a - sum(1 for x in axes if x < a)]


def _argminmax(op, attrs, vals):
    a = vals[0].axis
    axis = attrs.get("axis", None)
    if axis is None or int(axis) % vals[0].dim() == a:
        return None
    axis = int(axis) % vals[0].dim()
    return [a if attrs.get("keepdims", False) or axis > a else a - 1]


def _transpose(op, attrs, vals):
    a, nd = vals[0].axis, vals[0].dim()
    axes = tuple(attrs.get("axes", ()) or ()) or tuple(reversed(range(nd)))
    return [[int(x) % nd for x in axes].index(a)]


def _swapaxis(op, attrs, vals):
    a, nd = vals[0].axis, vals[0].dim()
    d1, d2 = int(attrs.get("dim1", 0)) % nd, int(attrs.get("dim2", 0)) % nd
    return [d2 if a == d1 else d1 if a == d2 else a]


def _reshape(op, attrs, vals):
    """Local when the dims up to the split axis keep their sizes: each
    shard is reshaped to its part of the output."""
    from .matrix import infer_reshape
    x = vals[0]
    a = x.axis
    shape = attrs.get("shape", None)
    if shape is None or shape == ():
        return None
    if isinstance(shape, int):
        shape = (shape,)
    out = tuple(infer_reshape(x.shape, tuple(shape),
                              bool(attrs.get("reverse", False))))
    if len(out) <= a or out[:a + 1] != tuple(x.shape[:a + 1]):
        return None

    def shard_attrs(k, ins):
        local = list(out)
        local[a] = ins[0].shape[a]
        return dict(attrs, shape=tuple(local), reverse=False)
    return [a], shard_attrs


def _expand_dims(op, attrs, vals):
    a, nd = vals[0].axis, vals[0].dim()
    axis = int(attrs.get("axis", 0)) % (nd + 1)
    return [a + 1 if axis <= a else a]


def _split_channel(op, attrs, vals):
    a, nd = vals[0].axis, vals[0].dim()
    axis = int(attrs.get("axis", 1)) % nd
    if axis == a:
        return None
    oa = a - 1 if attrs.get("squeeze_axis", False) and axis < a else a
    return [oa] * op.resolve_num_outputs(attrs)


def _concat(op, attrs, vals):
    got = _split_of(vals)
    if got is None or any(type(v) is not _mesh_tensor() for v in vals):
        return None
    dim = int(attrs.get("dim", 1)) % vals[0].dim()
    return None if dim == got[0] else [got[0]]


def _pick(op, attrs, vals):
    mt = _mesh_tensor()
    data, index = vals[0], vals[1]
    if type(data) is not mt or type(index) is not mt:
        return None
    a, nd = data.axis, data.dim()
    axis = attrs.get("axis", -1)
    if axis is None:
        return None
    axis = int(axis) % nd
    keep = bool(attrs.get("keepdims", False))
    ia = a if (keep and index.dim() == nd) or a < axis else a - 1
    if axis == a or index.axis != ia:
        return None
    return [a if keep or a < axis else a - 1]


def _embedding(op, attrs, vals):
    mt = _mesh_tensor()
    if type(vals[0]) is not mt or any(type(v) is mt for v in vals[1:]):
        return None
    return [vals[0].axis]


def _fc(op, attrs, vals):
    mt = _mesh_tensor()
    x = vals[0]
    if type(x) is not mt or any(type(v) is mt for v in vals[1:]):
        return None
    if attrs.get("flatten", True):
        return [0] if x.axis == 0 else None
    return [x.axis] if x.axis < x.dim() - 1 else None


def _params_only(axes_ok):
    """Batch-local ops whose first input is the batch and whose other
    inputs are parameters (never split)."""
    inner = _batch_local(axes_ok)

    def rule(op, attrs, vals):
        mt = _mesh_tensor()
        if type(vals[0]) is not mt or any(type(v) is mt for v in vals[1:]):
            return None
        return inner(op, attrs, vals)
    return rule


def _softmax_output(op, attrs, vals):
    # normalization "batch"/"valid" divides by a count over the whole
    # batch: those gather
    if attrs.get("normalization", "null") != "null":
        return None
    return _batch_local((0,))(op, attrs, vals)


def _dot(op, attrs, vals):
    mt = _mesh_tensor()
    lhs, rhs = vals
    if type(lhs) is not mt or type(rhs) is mt or lhs.axis != 0 \
            or attrs.get("transpose_a", False):
        return None
    return [0]


def install_mesh_rules():
    """The rules by op name (an op's own ``mesh`` wins); ``ops``
    installs them once every op module is imported."""
    from . import elemwise
    elementwise = list(elemwise._UNARY) + list(elemwise._BINARY) \
        + list(elemwise._SCALAR) + [
            "Cast", "clip", "where", "smooth_l1", "BlockGrad",
            "_scatter_elemwise_div", "Activation", "_contrib_div_sqrt_dim",
            "add_n"]
    table = {name: _elementwise for name in elementwise}
    table.update({name: _params_only((0,)) for name in (
        "Convolution", "Deconvolution", "Pooling", "InstanceNorm",
        "L2Normalization", "LRN", "UpSampling", "SoftmaxActivation")})
    table.update({name: _batch_local((0,)) for name in (
        "Flatten", "_contrib_flash_attention", "batch_dot", "one_hot")})
    table["FullyConnected"] = _fc
    table["SoftmaxOutput"] = _softmax_output
    table["LeakyReLU"] = _params_only(lambda attrs, nd: range(nd))
    table["Dropout"] = _batch_local(lambda attrs, nd: range(nd))
    table["BatchNorm"] = _params_only(
        lambda attrs, nd: [i for i in range(nd)
                           if i != int(attrs.get("axis", 1)) % nd])
    for name, key, default in (
            ("softmax", "axis", -1), ("log_softmax", "axis", -1),
            ("softmin", "axis", -1), ("LayerNorm", "axis", -1),
            ("slice_axis", "axis", 0), ("reverse", "axis", 0),
            ("squeeze", "axis", None)):
        table[name] = _not_axis(key, default)
    for name in ("sum", "mean", "max", "min", "prod", "nansum", "nanprod",
                 "norm"):
        table[name] = _reduce
    table.update(argmax=_argminmax, argmin=_argminmax,
                 transpose=_transpose, SwapAxis=_swapaxis,
                 Reshape=_reshape, expand_dims=_expand_dims,
                 SliceChannel=_split_channel, Concat=_concat, pick=_pick,
                 Embedding=_embedding, dot=_dot)
    _MESH_RULES.update(table)
