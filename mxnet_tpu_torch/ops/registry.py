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
"""
from __future__ import annotations

import ast

from ..base import MXNetError, Registry

__all__ = ["OpDef", "register", "get_op", "find_op", "list_ops", "invoke",
           "normalize_attrs", "attr_key"]

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
      ``(lo, hi)`` bounds, checked at invoke."""

    def __init__(self, name, forward, arg_names=("data",), defaults=None,
                 num_outputs=1, arg_names_fn=None, description="",
                 attr_docs=None, attr_ranges=None, needs_rng=False,
                 mutable_inputs=(), output_shapes=None, key_var_num_args=None,
                 draws=None, host_code=False):
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
    """Run ``op`` eagerly on torch tensors; returns ``(outputs,
    aux_updates)``: the tuple of its outputs and a list of ``(input
    index, new value)`` for its mutable inputs."""
    nattrs = normalize_attrs(op, attrs)
    if op.needs_rng:
        result = op.forward(nattrs, *inputs, rng=rng)
    else:
        result = op.forward(nattrs, *inputs)
    if not isinstance(result, (tuple, list)):
        result = (result,)
    n_out = op.resolve_num_outputs(nattrs)
    return (tuple(result[:n_out]),
            list(zip(op.mutable_inputs, result[n_out:])))
