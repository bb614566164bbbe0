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
"""
from __future__ import annotations

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

__all__ = ["Block", "HybridBlock"]


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
