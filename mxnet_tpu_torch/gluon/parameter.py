"""Gluon Parameter / ParameterDict (counterpart of
``mxnet_tpu/gluon/parameter.py``).

A Parameter is a three-state machine: UNBOUND (no array, no pending
init), DEFERRED (a recipe waiting for the first forward to fix its
shape), LIVE (an NDArray bound, with its gradient buffer when
``grad_req`` is not ``'null'``). A shape of 0 in a dimension means
unknown. A Parameter owns ONE NDArray, its master, on the first device
of its context list (``list_data``/``list_grad`` return one element,
``list_ctx`` the list). Over a list whose contexts resolve to distinct
torch devices it is replicated over their in-process ``dp`` mesh
(:attr:`Parameter.mesh`), as the JAX package replicates it: an op over a
batch split on that mesh reads a differentiable copy of the master on
each shard's device, so the backward adds every shard's gradient into
the master's (``ops.registry.call``).
"""
from __future__ import annotations

from collections import OrderedDict, namedtuple

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, current_context
from .. import autograd
from .. import initializer
from .. import ndarray as nd

__all__ = ["DeferredInitializationError", "Parameter", "Constant",
           "ParameterDict", "tensor_types"]

# the reference's name; as in the JAX package nothing sets it
tensor_types = None


class DeferredInitializationError(MXNetError):
    """Raised when touching a parameter whose init waits for its shape
    (reference: parameter.py:36)."""


_PendingInit = namedtuple("_PendingInit", "init ctx_list default data")

_GRAD_REQS = ("write", "add", "null")


def _merge_shapes(declared, observed, owner=""):
    """Reconcile two shapes where 0 means 'unknown'; returns the merged
    tuple or raises on conflict."""
    if declared is None:
        return tuple(observed)
    ok = len(declared) == len(observed) and all(
        d == 0 or o == 0 or d == o for d, o in zip(declared, observed))
    if not ok:
        raise AssertionError(
            "Expected shape %s is incompatible with given shape %s.%s"
            % (str(tuple(observed)), str(tuple(declared)),
               (" (Parameter %s)" % owner) if owner else ""))
    return tuple(d if d != 0 else o for d, o in zip(declared, observed))


def _as_ctx_list(ctx):
    if ctx is None:
        return [current_context()]
    if isinstance(ctx, Context):
        return [ctx]
    return list(ctx)


class Parameter:
    """One learnable tensor of a Block (reference: parameter.py:43)."""

    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self.init = init
        self.lr_mult, self.wd_mult = lr_mult, wd_mult
        self._shape = (shape,) if isinstance(shape, int) else \
            (tuple(shape) if shape is not None else None)
        self._dtype = dtype
        self._stype, self._grad_stype = stype, grad_stype
        self._differentiable = differentiable
        self._allow_deferred_init = allow_deferred_init
        self._data = None               # LIVE when set
        self._grad = None
        self._pending = None            # DEFERRED when set
        self._ctx_list = []
        self._var = None                # the Symbol variable, built once
        self._grad_req = None
        self.grad_req = grad_req

    def __repr__(self):
        return "Parameter {} (shape={}, dtype={})".format(
            self.name, self.shape, self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in _GRAD_REQS:
            raise AssertionError(
                "grad_req must be one of 'write', 'add', or 'null', "
                "but got %s" % req)
        if not self._differentiable:
            req = "null"
        if req == self._grad_req:
            return
        self._grad_req = req
        if self._data is not None:
            self._attach_grad_buffer()

    @property
    def dtype(self):
        return self._dtype

    @property
    def shape(self):
        return self._shape

    @property
    def stype(self):
        return self._stype

    @shape.setter
    def shape(self, new_shape):
        self._shape = _merge_shapes(self._shape, new_shape, self.name)

    # -- state transitions ------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Schedule (or run) initialization. Unknown dims defer to the
        first forward when allow_deferred_init is set."""
        if default_init is None:
            default_init = initializer.Uniform()
        if self._data is not None and not force_reinit:
            return
        chosen = init if init is not None else \
            (self.init if self.init is not None else default_init)
        recipe = _PendingInit(chosen, _as_ctx_list(ctx), default_init, None)
        if self._shape_known():
            self._pending = recipe
            self._finish_deferred_init()
        elif self._allow_deferred_init:
            self._pending = recipe
        else:
            raise ValueError(
                "Cannot initialize Parameter '%s' because it has invalid "
                "shape: %s." % (self.name, str(self.shape)))

    def _shape_known(self):
        return bool(self.shape) and int(np.prod(self.shape)) > 0

    def _finish_deferred_init(self):
        if self._pending is None:
            return
        recipe, self._pending = self._pending, None
        if not self._shape_known():
            raise AssertionError(
                "Cannot initialize Parameter '%s' because it has invalid "
                "shape: %s. Please specify in_units, in_channels, etc "
                "for `Block`s." % (self.name, str(self.shape)))
        with autograd.pause():
            data = recipe.data
            if data is None:
                data = nd.zeros(self.shape, dtype=self.dtype,
                                ctx=recipe.ctx_list[0])
                fill = recipe.init or recipe.default
                if isinstance(fill, str):
                    fill = initializer.create(fill)
                fill(initializer.InitDesc(self.name, {}), data)
            else:
                data = data.as_in_context(recipe.ctx_list[0]) \
                    .astype(self.dtype)
            self._bind(data, recipe.ctx_list)

    def _bind(self, data, ctx_list):
        """UNBOUND/DEFERRED → LIVE."""
        self._ctx_list = list(ctx_list)
        self._data = data
        self._attach_grad_buffer()

    def _attach_grad_buffer(self):
        # autograd.get_symbol names the array's variable after this
        self._data._param_name = self.name
        if self._grad_req == "null":
            self._grad = None
            autograd.mark_variables([self._data], [None], "null")
            return
        self._grad = nd.zeros(self._data.shape, dtype=self._data.dtype,
                              ctx=self._data.context)
        autograd.mark_variables([self._data], [self._grad],
                                [self._grad_req])

    def _load_init(self, data, ctx):
        """Adopt given values: binds an uninitialized or deferred
        parameter, sets a live one (reference: parameter.py:274)."""
        self.shape = data.shape
        if self._data is not None:
            self.set_data(data)
            return
        ctxes = self._pending.ctx_list if self._pending is not None \
            else _as_ctx_list(ctx)
        self._pending = None
        self._bind(data.as_in_context(ctxes[0]).astype(self.dtype), ctxes)

    # -- access ----------------------------------------------------------
    def _require_live(self):
        if self._data is not None:
            return
        if self._pending is not None:
            raise DeferredInitializationError(
                "Parameter '%s' has not been initialized yet because "
                "initialization was deferred. Actual initialization "
                "happens during the first forward pass. Please pass one "
                "batch of data through the network before accessing "
                "Parameters." % self.name)
        raise RuntimeError(
            "Parameter '%s' has not been initialized. Note that you "
            "should initialize parameters and create Trainer with "
            "Block.collect_params() instead of Block.params because the "
            "later does not include Parameters of nested child Blocks"
            % self.name)

    def data(self, ctx=None):
        self._require_live()
        return self._data

    def list_data(self):
        return [self.data()]

    def row_sparse_data(self, row_id):
        """The rows ``row_id`` names, as a dense NDArray (the JAX
        package's ``take``)."""
        return self.data().take(row_id)

    def grad(self, ctx=None):
        if self._data is not None and self._grad is None:
            raise RuntimeError(
                "Cannot get gradient array for Parameter '%s' because "
                "grad_req='null'" % self.name)
        self._require_live()
        return self._grad

    def list_grad(self):
        return [self.grad()]

    @property
    def mesh(self):
        """The in-process ``dp`` mesh the parameter is replicated over
        (``parallel.mesh.DeviceMesh``); None when its contexts resolve to
        one torch device."""
        from ..parallel.mesh import context_mesh
        return context_mesh(self._ctx_list)

    def list_ctx(self):
        if self._data is not None:
            return self._ctx_list or [self._data.context]
        if self._pending is not None:
            return self._pending.ctx_list
        raise RuntimeError("Parameter '%s' has not been initialized"
                           % self.name)

    def set_data(self, data):
        """Copy ``data`` (NDArray or array-like) into the parameter; on a
        deferred parameter it becomes the initial value."""
        self.shape = data.shape
        if self._data is None:
            if self._pending is None:
                raise AssertionError(
                    "Parameter '%s' has not been initialized" % self.name)
            if not isinstance(data, nd.NDArray):
                data = nd.array(data, ctx=self._pending.ctx_list[0])
            self._pending = self._pending._replace(data=data)
            return
        value = data._data if isinstance(data, nd.NDArray) \
            else torch.as_tensor(np.asarray(data))
        with torch.no_grad():
            self._data._data.copy_(value)

    def zero_grad(self):
        if self._grad is not None:
            self._grad[:] = 0

    def cast(self, dtype):
        """New arrays of ``dtype`` for the value and its gradient (a
        hybridized block's graph then recaptures over them)."""
        self._dtype = dtype
        self._var = None        # the variable carries the old dtype
        if self._data is None:
            return
        with autograd.pause():
            self._data = self._data.astype(dtype)
            self._data._param_name = self.name
            if self._grad is not None:
                self._grad = self._grad.astype(dtype)
            autograd.mark_variables([self._data], [self._grad],
                                    [self._grad_req])

    def var(self):
        """The Symbol variable of this parameter (name, shape, dtype,
        multipliers, initializer), as Gluon's tracing feeds it to
        ``hybrid_forward``."""
        if self._var is None:
            from .. import symbol
            self._var = symbol.var(
                self.name, shape=self.shape, dtype=self.dtype,
                lr_mult=self.lr_mult, wd_mult=self.wd_mult, init=self.init)
        return self._var


class Constant(Parameter):
    """A parameter that holds a fixed value: no gradient, and Trainer
    skips it (reference: parameter.py:612). The value is captured in a
    one-off registered initializer, so ``initialize()`` reproduces it on
    any context."""

    def __init__(self, name, value):
        if not isinstance(value, nd.NDArray):
            value = nd.array(value)
        self.value = value

        class _Repeat(initializer.Initializer):
            def _fill(self, _, data, gen):
                data.copy_(value._data)

            _init_default = initializer.Initializer._init_weight

        alias = "Constant_{}_{}".format(name, id(self))
        initializer._REG.register(alias, allow_override=True)(_Repeat)
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=alias,
                         differentiable=False)


class ParameterDict:
    """Prefix-scoped mapping of Parameters with sharing
    (reference: parameter.py:632)."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __repr__(self):
        head = self._prefix + " " if self._prefix else ""
        body = "\n".join(" " + repr(v) for v in self.values())
        return "{}(\n{}\n)".format(head, body)

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _lookup(self, full_name):
        """This dict, then the shared dict (adopting on hit)."""
        hit = self._params.get(full_name)
        if hit is None and self._shared is not None:
            hit = self._shared._params.get(full_name)
            if hit is not None:
                self._params[full_name] = hit
        return hit

    @staticmethod
    def _reconcile(param, key, value):
        existing = getattr(param, key, None)
        if existing is None:
            setattr(param, key, value)
            return
        if key == "shape" and len(value) == len(existing):
            param._shape = _merge_shapes(existing, value, param.name)
            return
        if key == "dtype" and np.dtype(value) == np.dtype(existing):
            return
        if value is not None and value != existing:
            raise AssertionError(
                "Cannot retrieve Parameter '%s' because desired "
                "attribute does not match with stored for attribute "
                "'%s': desired '%s' vs stored '%s'." % (
                    param.name, key, str(value), str(existing)))

    def get(self, name, **kwargs):
        full = self._prefix + name
        param = self._lookup(full)
        if param is None:
            param = Parameter(full, **kwargs)
            self._params[full] = param
        else:
            for key, value in kwargs.items():
                self._reconcile(param, key, value)
        return param

    def get_constant(self, name, value=None):
        """The Constant ``prefix + name``, created from ``value`` if it
        does not exist (reference: parameter.py:730)."""
        full = self._prefix + name
        param = self._lookup(full)
        if param is None:
            if value is None:
                raise KeyError(
                    "No constant named '{}'. Please specify value if you "
                    "want to create a new constant.".format(full))
            param = Constant(full, value)
            self._params[full] = param
        elif value is not None and not isinstance(param, Constant):
            raise AssertionError(
                "Parameter '{}' already exists but it is not a constant."
                .format(full))
        return param

    def update(self, other):
        for name, param in other.items():
            mine = self._params.get(name)
            if mine is not None and mine is not param:
                raise AssertionError(
                    "Cannot update self with other because they have "
                    "different Parameters with the same name '%s'" % name)
            self._params[name] = param

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = initializer.Uniform()
        for param in self.values():
            param.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for param in self.values():
            param.zero_grad()

    def setattr(self, name, value):
        for param in self.values():
            setattr(param, name, value)

    def save(self, filename, strip_prefix=""):
        """Write every parameter to ``filename`` (``nd.save``'s format)
        keyed by its full name less ``strip_prefix``."""
        payload = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    "Prefix '%s' is to be striped before saving, but "
                    "Parameter's name '%s' does not start with '%s'" % (
                        strip_prefix, param.name, strip_prefix))
            payload[param.name[len(strip_prefix):]] = param.data()
        nd.save(filename, payload)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Set the parameters from a file that :meth:`save` wrote, each
        name prefixed with ``restore_prefix``."""
        if restore_prefix:
            for name in self.keys():
                if not name.startswith(restore_prefix):
                    raise AssertionError(
                        "restore_prefix is '%s' but Parameter name '%s' "
                        "does not start with it" % (restore_prefix, name))
        strip = len(restore_prefix)
        loaded = {restore_prefix + k: v
                  for k, v in nd.load(filename).items()}
        if not allow_missing:
            missing = [n for n in self.keys() if n not in loaded]
            if missing:
                raise AssertionError(
                    "Parameter '%s' is missing in file '%s'"
                    % (missing[0][strip:], filename))
        for name, value in loaded.items():
            target = self._params.get(name)
            if target is None:
                if not ignore_extra:
                    raise AssertionError(
                        "Parameter '%s' loaded from file '%s' is not "
                        "present in ParameterDict"
                        % (name[strip:], filename))
                continue
            target._load_init(value, ctx)
