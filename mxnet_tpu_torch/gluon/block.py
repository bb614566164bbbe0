"""Gluon Block / HybridBlock (counterpart of ``mxnet_tpu/gluon/block.py``).

Naming follows the JAX package: a block's prefix comes from the
innermost ``name_scope`` (``dense0_``, ``meshmultiheadattention0_``) and
its parameters are named ``<prefix><name>``;
:meth:`Block._collect_params_with_prefix` gives the structural names
(``0.weight``) that do not depend on the global counters.

``HybridBlock.forward`` calls ``hybrid_forward(F=nd, x, ..., **params)``
eagerly. Deferred shapes are fixed from the first input by each layer's
:meth:`HybridBlock._infer_param_shapes` (the way ``torch.nn.LazyLinear``
does it), where the JAX package infers them through its Symbol graph;
the resulting shapes are the same. ``hybridize()`` raises
NotImplementedError until the Symbol/``cached_op`` layer is ported
(ROADMAP queue A item 8).
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict

from .. import ndarray as nd
from ..ndarray import NDArray
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock"]


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

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError()


class HybridBlock(Block):
    """A block written once against ``F`` (reference: block.py:671); here
    it always runs imperatively with ``F`` = :mod:`~mxnet_tpu_torch.nd`."""

    def register_child(self, block, name=None):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but "
                "%s has type %s. If you are using Sequential, please try "
                "HybridSequential instead." % (str(block),
                                               str(type(block))))
        super().register_child(block, name)

    def hybridize(self, active=True, **kwargs):
        if active:
            raise NotImplementedError(
                "HybridBlock.hybridize: compiling a block into one program "
                "needs the Symbol/cached_op layer, not ported yet (ROADMAP "
                "queue A item 8); the block runs imperatively")
        super().hybridize(active, **kwargs)

    def _infer_param_shapes(self, *args):
        """Fix the unknown (0) dims of this block's own parameters from
        its inputs. Layers with deferred parameters override it."""
        raise ValueError(
            "Deferred initialization failed because shape cannot be "
            "inferred: %s has no shape rule for its parameters %s"
            % (type(self).__name__, sorted(self._reg_params)))

    def forward(self, x, *args):
        if not isinstance(x, NDArray):
            raise AssertionError(
                "HybridBlock requires the first argument to forward be an "
                "NDArray, but got %s" % type(x))
        try:
            params = {n: p.data() for n, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._infer_param_shapes(x, *args)
            for p in self._reg_params.values():
                p._finish_deferred_init()
            params = {n: p.data() for n, p in self._reg_params.items()}
        return self.hybrid_forward(nd, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError()
