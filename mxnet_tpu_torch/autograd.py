"""Imperative autograd (counterpart of ``mxnet_tpu/autograd.py``) on
torch autograd.

Inside :func:`record`, ops run with torch's gradient recording on, so
their outputs carry a torch graph back to the marked variables (torch
leaves that require grad, made by ``attach_grad`` or
:func:`mark_variables`). Outside it they run under ``no_grad`` and build
nothing. :func:`backward` walks the heads' graph to its leaves,
differentiates with ``torch.autograd.grad`` and applies MXNet's
``grad_req``: ``'write'`` replaces a variable's gradient, ``'add'`` adds
to it (torch itself would accumulate). A head that is not a scalar gets
a head gradient of ones, as in MXNet.

The JAX package replays its tape as one compiled program; torch keeps
the graph it recorded, so ``train_mode`` of :func:`backward` only
exists for API parity: the forward already ran in the recorded mode.
:func:`get_symbol` reads the notes that ``invoke_nd`` leaves on the
outputs of the ops it runs under ``record()`` (the JAX package walks its
tape). :class:`Function` is a user's differentiable function over
NDArrays, bridged to a ``torch.autograd.Function``.

A variable split over the in-process mesh (a ``MeshNDArray``) is one
leaf a shard; its gradient is the shards' joined on the mesh's first
device, in its one (whole) gradient buffer.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "get_symbol", "Function"]

_state = threading.local()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    prev = _st().recording
    _st().recording = bool(is_record)
    return prev


def set_training(train_mode_):
    prev = _st().training
    _st().training = bool(train_mode_)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train_mode_):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode_
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)
        return self

    def __exit__(self, ptype, value, trace):
        if self._enter_is_record is not None:
            set_recording(self._prev_is_record)
        if self._enter_train_mode is not None:
            set_training(self._prev_train_mode)


def record(train_mode=True):
    """Scope that records ops for autograd (reference: autograd.py:122)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each NDArray a variable: its tensor becomes a torch leaf
    that requires grad, with ``gradients[i]`` as its gradient buffer
    (reference: autograd.py:197)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        if _leaf_parts(var) is not None:
            var._mt = var._mt.map(
                lambda t: t.detach().requires_grad_(req != "null"))
        else:
            var._data = var._data.detach().requires_grad_(req != "null")
        for leaf in _leaves(var):
            leaf._mx_owner = weakref.ref(var)
        var.grad = g if req != "null" else None
        var._grad_req = req
        var._fresh_grad = False


def _leaf_parts(var):
    """A split mesh variable's shards, else None."""
    from .parallel.mesh import is_split
    mt = getattr(var, "_mt", None)
    return mt.shards if is_split(mt) else None


def _leaves(var):
    """The torch leaves of a variable: its tensor, or a split mesh
    variable's shards."""
    parts = _leaf_parts(var)
    return [var._data] if parts is None else parts


def _joined(variables, grads):
    """One gradient a variable from :func:`_leaves`' order: a split
    variable's shards' gradients joined (None when a shard's is)."""
    from .parallel.collectives import device_gather
    grads, out = list(grads), []
    for var in variables:
        n = len(_leaves(var))
        part, grads = grads[:n], grads[n:]
        if _leaf_parts(var) is None:
            out.append(part[0])
        elif any(g is None for g in part):
            out.append(None)
        else:
            out.append(device_gather(part, var._mt.device, var._mt.axis))
    return out


def _variables(roots):
    """The marked variables (NDArrays) that ``roots``' graph reaches."""
    found, seen = [], set()
    stack = []
    for r in roots:
        if r.grad_fn is not None:
            stack.append(r.grad_fn)
        elif r.requires_grad:
            found.append(r)
    nodes = []          # keeps visited nodes alive while ids are compared
    while stack:
        fn = stack.pop()
        if id(fn) in seen:
            continue
        seen.add(id(fn))
        nodes.append(fn)
        leaf = getattr(fn, "variable", None)
        if leaf is not None:
            found.append(leaf)
        stack.extend(nxt for nxt, _ in fn.next_functions if nxt is not None)
    out = []
    for leaf in found:
        ref = getattr(leaf, "_mx_owner", None)
        owner = ref() if ref is not None else None
        if owner is not None and owner.grad is not None \
                and any(leaf is t for t in _leaves(owner)) \
                and all(owner is not o for o in out):
            out.append(owner)
    return out


def _head_grads(heads, head_grads):
    """One head gradient a root of :func:`_roots`: ones by default; a
    given one is split as its mesh head is."""
    from .ndarray.ndarray import raw_value
    from .parallel.mesh import is_split
    if head_grads is None:
        head_grads = [None] * len(heads)
    out = []
    for h, g in zip(heads, head_grads):
        v = raw_value(h)
        if not is_split(v):
            out.append(torch.ones_like(h._data) if g is None else g._data)
        elif g is None:
            out.extend(torch.ones_like(s) for s in v.shards)
        else:
            out.extend(v.mesh.split(g._data, v.axis).shards)
    return out


def _roots(heads):
    """The heads' tensors: a mesh head's shards, each its own root (the
    backward of every shard runs on its device)."""
    from .ndarray.ndarray import raw_value
    from .parallel.mesh import is_split
    roots = []
    for h in heads:
        v = raw_value(h)
        roots.extend(v.shards if is_split(v) else [h._data])
    if not any(r.requires_grad for r in roots):
        raise MXNetError("cannot call backward: no ops were recorded "
                         "(use autograd.record())")
    return roots


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Differentiate ``heads`` and write (or add) the gradients into
    every variable they reach (reference: autograd.py:243)."""
    heads = list(heads)
    roots = _roots(heads)
    variables = _variables(roots)
    if not variables:
        return
    grads = torch.autograd.grad(roots, [t for v in variables
                                        for t in _leaves(v)],
                                _head_grads(heads, head_grads),
                                retain_graph=retain_graph, allow_unused=True)
    for var, g in zip(variables, _joined(variables, grads)):
        if g is None:
            continue
        _store_grad(var, g)
        var._fresh_grad = True


def _store_grad(var, g):
    """Write (``'write'``) or add (``'add'``) ``g`` into the variable's
    gradient buffer IN PLACE, so a gradient keeps its storage from step
    to step (the fused update's CUDA graph reads it there). A buffer of
    another shape, dtype or device is replaced."""
    buf = var.grad._data
    if buf.shape != g.shape or buf.dtype != g.dtype \
            or buf.device != g.device or buf.requires_grad:
        var.grad._data = buf + g if var._grad_req == "add" else g
        return
    with torch.no_grad():
        if var._grad_req == "add":
            buf.add_(g)
        else:
            buf.copy_(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of ``heads`` with respect to ``variables``, as new
    NDArrays (reference: autograd.py:270). With ``create_graph=True``
    they are differentiable again inside ``record()``."""
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    if isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    heads = list(heads)
    with torch.set_grad_enabled(create_graph and is_recording()):
        grads = _joined(variables, torch.autograd.grad(
            _roots(heads), [t for v in variables for t in _leaves(v)],
            _head_grads(heads, head_grads), retain_graph=retain_graph,
            create_graph=create_graph, allow_unused=True))
    if any(g is None for g in grads):
        raise MXNetError("one of the variables does not participate in "
                         "the computation of heads")
    out = [NDArray(g) for g in grads]
    return out[0] if single else out


def get_symbol(x):
    """The Symbol of the ops recorded into ``x`` (reference:
    autograd.py:304). Its variables are the arrays no recorded op made:
    a Gluon parameter's data by the parameter's name, any other array as
    ``var<i>``."""
    from .symbol.symbol import _symbol_from_tape
    return _symbol_from_tape(x)


class Function:
    """A differentiable function written by the user (reference:
    autograd.py:365): ``forward(*inputs)`` and ``backward(*output_grads)``
    over NDArrays, ``backward`` returning one gradient per input. The
    JAX package's surface: ``forward`` runs when called, outside the
    recording; under ``record()`` its outputs carry a gradient that calls
    ``backward``."""

    def __init__(self):
        self._used = False

    def forward(self, *inputs):
        raise NotImplementedError()

    def backward(self, *output_grads):
        raise NotImplementedError()

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        with pause(train_mode=is_training()):
            outs = self.forward(*inputs)
        single = not isinstance(outs, (list, tuple))
        out_list = [outs] if single else list(outs)
        if is_recording() and any(i._data.requires_grad for i in inputs):
            tensors = _FunctionBridge.apply(
                self, len(inputs), *[i._data for i in inputs],
                *[o._data.detach() for o in out_list])
            out_list = [NDArray(t) for t in tensors]
        return out_list[0] if single else out_list


class _FunctionBridge(torch.autograd.Function):
    """The outputs ``forward`` computed, as the outputs of a torch
    function whose backward is the user's."""

    @staticmethod
    def forward(ctx, func, n_in, *tensors):
        ctx.func = func
        ctx.float_in = [t.is_floating_point() for t in tensors[:n_in]]
        return tuple(t.clone() for t in tensors[n_in:])

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray.ndarray import NDArray
        with pause():
            igrads = ctx.func.backward(*[NDArray(g) for g in grads])
        if not isinstance(igrads, (list, tuple)):
            igrads = [igrads]
        if len(igrads) != len(ctx.float_in):
            raise MXNetError("Function.backward returned %d gradients for "
                             "%d inputs" % (len(igrads), len(ctx.float_in)))
        return (None, None) + tuple(
            g._data if f else None
            for g, f in zip(igrads, ctx.float_in)) + (None,) * len(grads)
