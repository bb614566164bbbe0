"""Gluon Block / HybridBlock (counterpart of ``mxnet_tpu/gluon/block.py``).

Naming follows the JAX package: a block's prefix comes from the
innermost ``name_scope`` (``dense0_``, ``meshmultiheadattention0_``) and
its parameters are named ``<prefix><name>``;
:meth:`Block._collect_params_with_prefix` gives the structural names
(``0.weight``) that do not depend on the global counters.

``HybridBlock.forward`` takes an NDArray or a Symbol. With an NDArray it
calls ``hybrid_forward(F=nd, x, ..., **params)`` eagerly, or, once
``hybridize()``d, runs the block's traced graph through one
:class:`~mxnet_tpu_torch.cached_op.CachedOp` (on the card: one CUDA
graph per input signature). With a Symbol it traces
``hybrid_forward(F=sym, ...)`` into the graph. Deferred parameter shapes
are fixed from the first input by shape inference over that graph, as
in the JAX package.

Files: ``save_parameters``/``load_parameters`` keyed by structural name
(a file keyed by full names loads too, as in the JAX package),
``export`` (``<path>-symbol.json`` and ``<path>-%04d.params`` with
``arg:``/``aux:`` keys) and :class:`SymbolBlock` (``imports``) all go
through ``nd.save``/``nd.load`` and the nnvm JSON, whose formats the two
packages share, so a file written by either loads in the other.
"""
from __future__ import annotations

import copy
import re
import threading
from collections import OrderedDict

from ..base import MXNetError
from .. import ndarray as nd
from ..ndarray import NDArray
from .. import symbol as sym_mod
from ..symbol import Symbol
from ..cached_op import CachedOp
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


# ---------------------------------------------------------------------------
# pytree codec for nested Symbol/NDArray structures
# ---------------------------------------------------------------------------

class _Leaf:
    """Spec of one leaf; ``width`` > 0 marks a multi-output Symbol that
    regroups as a slice of that many outputs."""

    __slots__ = ("width",)

    def __init__(self, width=0):
        self.width = width

    def __eq__(self, other):
        return isinstance(other, _Leaf) and self.width == other.width


def _tree_flatten(tree, role):
    """→ (leaves, spec); spec is a _Leaf or a list of nested specs."""
    if isinstance(tree, NDArray):
        return [tree], _Leaf()
    if isinstance(tree, Symbol):
        n = len(tree.list_outputs())
        return [tree], _Leaf(n if n > 1 else 0)
    if not isinstance(tree, (list, tuple)):
        raise AssertionError(
            "HybridBlock %s must be (nested) list of Symbol or NDArray, "
            "but got %s of type %s" % (role, str(tree), str(type(tree))))
    leaves, specs = [], []
    for item in tree:
        sub_leaves, sub_spec = _tree_flatten(item, role)
        leaves.extend(sub_leaves)
        specs.append(sub_spec)
    return leaves, specs


def _tree_unflatten(leaves, spec):
    """Inverse of _tree_flatten; consumes ``leaves`` (a list used as a
    queue) and returns the structured value."""
    if isinstance(spec, _Leaf):
        if spec.width == 0:
            return leaves.pop(0)
        picked = leaves[:spec.width]
        del leaves[:spec.width]
        return picked
    return [_tree_unflatten(leaves, s) for s in spec]


def _name_list_preview(names, limit=7):
    names = list(names)
    if len(names) > limit:
        return (_name_list_preview(names[:limit // 2], limit) + ", ..., "
                + _name_list_preview(names[-limit // 2:], limit))
    return ", ".join("'%s'" % n for n in names)


class _Naming:
    """Per-block naming scope: allocates child prefixes and pushes the
    block's prefix onto the NameManager inside ``with`` (the role of the
    reference's _BlockScope, block.py:34)."""

    _active = threading.local()

    def __init__(self, owner):
        self._owner = owner
        self._child_counts = {}
        self._outer = None
        self._prefix_guard = None

    @classmethod
    def innermost(cls):
        return getattr(cls._active, "top", None)

    @classmethod
    def derive(cls, prefix, params, hint):
        """Resolve (prefix, params) for a new Block under the innermost
        active scope."""
        scope = cls.innermost()
        if scope is None:
            if prefix is None:
                from ..name import NameManager
                prefix = NameManager.current().get(None, hint) + "_"
            params = ParameterDict(prefix) if params is None else \
                ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            n = scope._child_counts.get(hint, 0)
            scope._child_counts[hint] = n + 1
            prefix = "%s%d_" % (hint, n)
        if params is None:
            parent = scope._owner.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return scope._owner.prefix + prefix, params

    def __enter__(self):
        if self._owner._empty_prefix:
            return self
        self._outer = _Naming.innermost()
        _Naming._active.top = self
        from ..name import Prefix
        self._prefix_guard = Prefix(self._owner.prefix)
        self._prefix_guard.__enter__()
        return self

    def __exit__(self, *exc):
        if self._owner._empty_prefix:
            return
        self._prefix_guard.__exit__(*exc)
        self._prefix_guard = None
        _Naming._active.top = self._outer


class Block:
    """Base of all layers and models (reference: block.py:127)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _Naming.derive(prefix, params,
                                                    self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _Naming(self)
        self._children = OrderedDict()
        self._reg_params = {}

    def _alias(self):
        return type(self).__name__.lower()

    def __repr__(self):
        rows = ["  ({}): {}".format(key, repr(child).replace("\n", "\n  "))
                for key, child in self._children.items()]
        return "{}(\n{}\n)".format(type(self).__name__, "\n".join(rows))

    def __setattr__(self, name, value):
        if hasattr(self, name):
            old = getattr(self, name)
            if isinstance(old, (Parameter, Block)) and \
                    not isinstance(value, type(old)):
                raise TypeError(
                    "Changing attribute type for {name} from {type1} to "
                    "{type2} is not allowed.".format(
                        name=name, type1=type(old), type2=type(value)))
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            if name in self._reg_params:
                raise AssertionError(
                    "Overriding Parameter attribute %s is not allowed. "
                    "If you want to share parameters between blocks, "
                    "please set an attribute before initializing children "
                    "blocks." % name)
            self._reg_params[name] = value
        super().__setattr__(name, value)

    prefix = property(lambda self: self._prefix)
    name = property(lambda self: self._name)
    params = property(lambda self: self._params)

    def name_scope(self):
        return self._scope

    def collect_params(self, select=None):
        """All Parameters of this Block and its children, optionally
        regex-filtered (reference: block.py:278)."""
        bag = ParameterDict(self._params.prefix)
        if select is None:
            bag.update(self.params)
        else:
            matcher = re.compile(select)
            bag.update({n: p for n, p in self.params.items()
                        if matcher.match(n)})
        for child in self._children.values():
            bag.update(child.collect_params(select=select))
        return bag

    def _collect_params_with_prefix(self, prefix=""):
        """``{structural name: Parameter}``, e.g. ``0.weight``."""
        dot = prefix + "." if prefix else ""
        found = {dot + n: p for n, p in self._reg_params.items()}
        for name, child in self._children.items():
            found.update(child._collect_params_with_prefix(dot + name))
        return found

    def register_child(self, block, name=None):
        self._children[name if name is not None
                       else str(len(self._children))] = block

    # -- files (structural names) -----------------------------------------
    def save_parameters(self, filename, deduplicate=False):
        """Write every parameter keyed by its structural name
        (reference: block.py:315)."""
        table = self._collect_params_with_prefix()
        nd.save(filename, {key: p.data() for key, p in table.items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Set the parameters from a :meth:`save_parameters` file; a file
        keyed by full parameter names (no ``.`` in any key) goes through
        ``collect_params().load`` (reference: block.py:404)."""
        loaded = nd.load(filename)
        table = self._collect_params_with_prefix()
        if not loaded and not table:
            return
        if loaded and not any("." in k for k in loaded):
            self.collect_params().load(filename, ctx, allow_missing,
                                       ignore_extra, self.prefix)
            return
        if not allow_missing:
            for key in table:
                if key not in loaded:
                    raise AssertionError(
                        "Parameter '%s' is missing in file '%s', which "
                        "contains parameters: %s." % (
                            key, filename, _name_list_preview(loaded)))
        for key, value in loaded.items():
            if key not in table:
                if ignore_extra:
                    continue
                raise ValueError(
                    "Parameter '%s' loaded from file '%s' is not present "
                    "in ParameterDict, which contains parameters %s." % (
                        key, filename, _name_list_preview(table)))
            table[key]._load_init(value, ctx)

    def apply(self, fn):
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            from .. import initializer
            init = initializer.Uniform()
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast every parameter (and the children's) to ``dtype``."""
        for child in self._children.values():
            child.cast(dtype)
        for param in self.params.values():
            param.cast(dtype)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError()


class HybridBlock(Block):
    """A block written once against ``F`` that can run as one traced
    graph (reference: block.py:671)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._cached_graph = ()
        self._cached_op = None
        self._cache_sources = None      # [("data", idx) | ("param", p)]
        self._in_spec = None
        self._out_spec = None
        self._active = False
        self._flags = []

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, HybridBlock):
            self._clear_cached_op()

    # -- tracing ----------------------------------------------------------
    def _get_graph(self, *args):
        if not self._cached_graph:
            leaves, self._in_spec = _tree_flatten(list(args), "input")
            # the placeholders carry the inputs' dtypes for inference
            placeholders = [
                sym_mod.var("data%d" % i, dtype=getattr(leaf, "dtype", None))
                for i, leaf in enumerate(leaves)]
            structured = _tree_unflatten(list(placeholders), self._in_spec)
            param_vars = {n: p.var() for n, p in self._reg_params.items()}
            with self.name_scope():
                out = self.hybrid_forward(sym_mod, *structured,
                                          **param_vars)
            flat_out, self._out_spec = _tree_flatten(out, "output")
            graph = sym_mod.Group(flat_out) if len(flat_out) > 1 \
                else flat_out[0]
            self._cached_graph = (placeholders, graph)
        return self._cached_graph

    def _build_cache(self, *args):
        placeholders, graph = self._get_graph(*args)
        slot_of = {p.name: i for i, p in enumerate(placeholders)}
        by_name = {p.name: p for p in self.collect_params().values()}
        self._cache_sources = []
        for name in graph.list_arguments() + graph.list_auxiliary_states():
            if name in slot_of:
                self._cache_sources.append(("data", slot_of[name]))
            elif name in by_name:
                self._cache_sources.append(("param", by_name[name]))
            else:
                raise MXNetError("Unknown input to HybridBlock: %s" % name)
        self._cached_op = CachedOp(
            graph, self._flags,
            data_indices=[i for i, (kind, _) in
                          enumerate(self._cache_sources) if kind == "data"])

    def _call_cached_op(self, *args):
        if self._cached_op is None:
            self._build_cache(*args)
        leaves, spec = _tree_flatten(list(args), "input")
        if spec != self._in_spec:
            raise AssertionError("Invalid input format")
        feed = [leaves[ref] if kind == "data" else ref.data()
                for kind, ref in self._cache_sources]
        out = self._cached_op(*feed)
        flat = [out] if isinstance(out, NDArray) else list(out)
        return _tree_unflatten(flat, self._out_spec)

    def _clear_cached_op(self):
        self._cached_graph = ()
        self._cached_op = None

    # -- composition overrides --------------------------------------------
    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but "
                "%s has type %s. If you are using Sequential, please try "
                "HybridSequential instead." % (str(block),
                                               str(type(block))))
        super().register_child(block, name)
        self._clear_cached_op()

    def hybridize(self, active=True, **kwargs):
        """Run this block (and its children) as one traced graph from
        the next call; ``active=False`` goes back to eager calls."""
        self._active = active
        self._flags = list(kwargs.items())
        self._clear_cached_op()
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    # -- shape/type inference ---------------------------------------------
    def _infer_attrs(self, infer_fn, attr, *args):
        _, graph = self._get_graph(*args)
        leaves, _ = _tree_flatten(list(args), "input")
        feed = {"data%d" % i: (leaf.shape if attr == "shape" else leaf.dtype)
                for i, leaf in enumerate(leaves)}
        arg_attrs, _, aux_attrs = getattr(graph, infer_fn)(**feed)
        known = dict(zip(graph.list_arguments(), arg_attrs))
        known.update(zip(graph.list_auxiliary_states(), aux_attrs))
        field = "_shape" if attr == "shape" else "_dtype"
        for name, param in self.collect_params().items():
            if name in known:
                setattr(param, field, known[name])

    def infer_shape(self, *args):
        """Fix the parameters' shapes from the inputs' (reference:
        block.py:839) and finish their deferred initialization."""
        self._infer_attrs("infer_shape", "shape", *args)
        for param in self.collect_params().values():
            param._finish_deferred_init()

    def infer_type(self, *args):
        self._infer_attrs("infer_type", "dtype", *args)

    def _deferred_infer_shape(self, *args):
        try:
            self.infer_shape(*args)
        except Exception as e:
            raise ValueError(
                "Deferred initialization failed because shape cannot be "
                "inferred. {}".format(e)) from e

    # -- deployment -------------------------------------------------------
    def export(self, path, epoch=0, remove_amp_cast=True):
        """Write the traced graph to ``<path>-symbol.json`` and its
        parameters to ``<path>-<epoch:04d>.params`` (keys ``arg:<name>``
        and ``aux:<name>``), the deploy pair that
        :meth:`SymbolBlock.imports` and ``Module.load`` read (reference:
        block.py:868). Needs one hybridized call first."""
        if not self._cached_graph:
            raise RuntimeError(
                "Please first call block.hybridize() and then run forward "
                "with this block at least once before calling export.")
        graph = self._cached_graph[1]
        sym_file = "%s-symbol.json" % path
        graph.save(sym_file)
        arg_names = set(graph.list_arguments())
        aux_names = set(graph.list_auxiliary_states())
        payload = {}
        for name, param in self.collect_params().items():
            if name in arg_names:
                payload["arg:%s" % name] = param.data()
            elif name in aux_names:
                payload["aux:%s" % name] = param.data()
        params_file = "%s-%04d.params" % (path, epoch)
        nd.save(params_file, payload)
        return sym_file, params_file

    # -- execution --------------------------------------------------------
    def forward(self, x, *args):
        """Hybridized (one CachedOp) or eager with an NDArray; a traced
        graph with a Symbol (reference: block.py:795)."""
        if isinstance(x, NDArray):
            if self._active:
                try:
                    return self._call_cached_op(x, *args)
                except DeferredInitializationError:
                    self._deferred_infer_shape(x, *args)
                    return self._call_cached_op(x, *args)
            try:
                params = {n: p.data() for n, p in self._reg_params.items()}
            except DeferredInitializationError:
                self._deferred_infer_shape(x, *args)
                params = {n: p.data() for n, p in self._reg_params.items()}
            return self.hybrid_forward(nd, x, *args, **params)
        if not isinstance(x, Symbol):
            raise AssertionError(
                "HybridBlock requires the first argument to forward be "
                "either Symbol or NDArray, but got %s" % type(x))
        param_vars = {n: p.var() for n, p in self._reg_params.items()}
        with self.name_scope():
            return self.hybrid_forward(sym_mod, x, *args, **param_vars)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError()


class SymbolBlock(HybridBlock):
    """A Symbol graph as a Block (reference: block.py:952): ``outputs``
    over the variables ``inputs``; every other argument and auxiliary
    state of the graph becomes a parameter named as its variable. It
    always runs as one CachedOp (a CUDA graph per signature on the
    card)."""

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock over ``symbol_file``'s graph with ``input_names``
        as its inputs (``data0`` for a block that ``export`` wrote), its
        parameters from ``param_file`` (``arg:``/``aux:`` keys, or plain
        names)."""
        graph = sym_mod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        net = SymbolBlock(graph, [sym_mod.var(n) for n in input_names])
        if param_file is not None:
            saved = {}
            for name, value in nd.load(param_file).items():
                saved[name[4:] if name[:4] in ("arg:", "aux:")
                      else name] = value
            for name, param in net.collect_params().items():
                if name in saved:
                    param._load_init(saved[name], ctx)
        return net

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        self._prefix = ""
        self._params = ParameterDict("", params)
        if isinstance(inputs, Symbol) and len(inputs.list_outputs()) == 1:
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)):
            outputs = outputs[0] if len(outputs) == 1 \
                else sym_mod.Group(outputs)
        in_leaves, self._in_spec = _tree_flatten(inputs, "input")
        out_leaves, self._out_spec = _tree_flatten(outputs, "output")
        graph = sym_mod.Group(out_leaves) if len(out_leaves) > 1 \
            else out_leaves[0]
        bound = set()
        for leaf in in_leaves:
            if len(leaf.list_outputs()) != 1:
                raise AssertionError(
                    "Input symbols must be variable, but %s is an output "
                    "of operators" % str(leaf))
            bound.add(leaf.name)
        for name in graph.list_arguments():
            if name not in bound:
                self.params.get(name, allow_deferred_init=True)
        for name in graph.list_auxiliary_states():
            if name not in bound:
                self.params.get(name, grad_req="null",
                                allow_deferred_init=True)
        self._cached_graph = (in_leaves, graph)
        strip = _common_prefix(list(self._params.keys()))
        self._reg_params = {k[len(strip):]: v
                            for k, v in self._params.items()}

    def _resolve_deferred_shapes(self, x, *args):
        inputs, graph = self._cached_graph
        leaves, _ = _tree_flatten([x] + list(args), "input")
        feed = {i.name: a.shape for i, a in zip(inputs, leaves)}
        arg_shapes, _, aux_shapes = graph.infer_shape(**feed)
        known = dict(zip(graph.list_arguments(), arg_shapes))
        known.update(zip(graph.list_auxiliary_states(), aux_shapes))
        for name, param in self.params.items():
            if not param._shape_known():
                param._shape = known[name]
            param._finish_deferred_init()

    def forward(self, x, *args):
        if isinstance(x, NDArray):
            try:
                return self._call_cached_op(x, *args)
            except DeferredInitializationError:
                self._resolve_deferred_shapes(x, *args)
                return self._call_cached_op(x, *args)
        if not isinstance(x, Symbol):
            raise AssertionError(
                "HybridBlock requires the first argument to forward be "
                "either Symbol or NDArray, but got %s" % type(x))
        _, spec = _tree_flatten([x] + list(args), "input")
        if spec != self._in_spec:
            raise AssertionError("Invalid input format")
        return copy.copy(self._cached_graph[1])

    def _clear_cached_op(self):
        keep = self._cached_graph
        super()._clear_cached_op()
        self._cached_graph = keep

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError()


def _common_prefix(names):
    """Longest common prefix of all names."""
    if not names:
        return ""
    lo, hi = min(names), max(names)
    n = 0
    while n < len(lo) and lo[n] == hi[n]:
        n += 1
    return lo[:n]
