"""Custom operators in Python (counterpart of ``mxnet_tpu/operator.py``;
reference: python/mxnet/operator.py, src/operator/custom/custom-inl.h:50).

A user writes ``CustomOp.forward``/``backward`` over NDArrays and
registers a ``CustomOpProp`` with :func:`register`; ``nd.Custom`` and
``sym.Custom`` (``op_type=``) run it. Every callback runs on ONE worker
thread, as the reference's ``CustomOperator`` runs them on its own
threads and the JAX package on its one callback thread: the user sees
ordered, serialized calls. The worker runs the user's code on the
caller's CUDA stream, under ``no_grad``, with the op's device as the
current context; the gradient comes from a ``torch.autograd.Function``
whose backward calls the user's ``backward`` there. ``backward`` gets
``req="write"`` for every input; a prop with auxiliary states raises.

Difference from the JAX package (whose XLA program cannot call Python on
the TPU, so it hands the user host NDArrays): the user's ``in_data``,
``out_data`` and gradients are NDArrays on the op's own device, as in
MXNet 1.5. User code may read a value on the host (``asnumpy()``), which
a CUDA graph cannot hold, so a plan holding ``Custom`` is never captured
(``OpDef.runs_host_code``): a CachedOp or an executor's predict run goes
op by op, counted in ``stats()["eager_host"]``, and the Module's fused
step falls back to the eager step, counted in
``profiler.counters()['fused_step_fallbacks']``. An error in the user's
code propagates to the caller.
"""
from __future__ import annotations

import concurrent.futures
import threading

import numpy as _np
import torch

from .base import MXNetError

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered"]

_PROP_REGISTRY = {}

# the one callback thread
_worker = None
_worker_lock = threading.Lock()
_on_worker_thread = threading.local()


def _on_worker(fn, *args):
    """``fn(*args)`` on the callback thread (directly when already there:
    a user op that calls another Custom op)."""
    global _worker
    if getattr(_on_worker_thread, "yes", False):
        return fn(*args)
    if _worker is None:
        with _worker_lock:
            if _worker is None:
                def mark():
                    _on_worker_thread.yes = True
                _worker = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="mxnet_custom_op",
                    initializer=mark)
    return _worker.submit(fn, *args).result()


class CustomOp:
    """Base class for user operators (reference: operator.py CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError()

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` honouring the write request."""
        if req in ("null", None):
            return
        if req == "add":
            dst[:] = dst + src
        else:               # write / inplace
            dst[:] = src


class CustomOpProp:
    """Describes a custom op's signature (reference: CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Decorator registering a CustomOpProp subclass under ``op_type``
    (reference: operator.py register)."""
    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError(
                "register('%s') expects a CustomOpProp subclass" % reg_name)
        _PROP_REGISTRY[reg_name] = prop_cls
        return prop_cls
    return do_register


def get_all_registered():
    return dict(_PROP_REGISTRY)


# ---------------------------------------------------------------------------
# The `Custom` operator
# ---------------------------------------------------------------------------

def _make_prop(attrs):
    op_type = attrs.get("op_type")
    if not op_type:
        raise MXNetError("Custom requires an op_type= keyword")
    cls = _PROP_REGISTRY.get(op_type)
    if cls is None:
        raise MXNetError(
            "Custom op_type '%s' is not registered (use "
            "@mx.operator.register)" % op_type)
    kwargs = {k: str(v) for k, v in attrs.items()
              if k not in ("op_type", "__train__") and
              not (k.startswith("__") and k.endswith("__"))}
    return cls(**kwargs)


def _custom_arg_names(attrs):
    return list(_make_prop(attrs).list_arguments())


def _custom_num_outputs(attrs):
    return len(_make_prop(attrs).list_outputs())


def _signature(prop, inputs):
    """``(in shapes, in dtypes, out shapes, out dtypes)``: numpy dtypes
    to the user's prop, torch dtypes back."""
    from .ndarray.ndarray import numpy_dtype, torch_dtype
    in_shapes = [list(x.shape) for x in inputs]
    in_types = [numpy_dtype(x.dtype) for x in inputs]
    out_shapes = [tuple(s) for s in prop.infer_shape(in_shapes)[1]]
    out_types = [torch_dtype(_np.dtype(t).name)
                 for t in prop.infer_type(in_types)[1]]
    return in_shapes, in_types, out_shapes, out_types


def _wrap(tensors):
    from .ndarray.ndarray import NDArray
    return [NDArray(t) for t in tensors]


def _on_device(device, stream, fn):
    """``fn()`` as the user's code runs: under ``no_grad``, on the
    caller's stream, with ``device`` as the current context."""
    from .context import context_of

    def run():
        with torch.no_grad(), context_of(device):
            if stream is None:
                return fn()
            with torch.cuda.stream(stream):
                return fn()
    return run


def _stream(device):
    return torch.cuda.current_stream(device) if device.type == "cuda" \
        else None


class _CustomFunction(torch.autograd.Function):
    """The user's forward, and its backward as the gradient."""

    @staticmethod
    def forward(ctx, op, is_train, out_specs, *xs):
        device = xs[0].device
        ins = [x.detach() for x in xs]

        def run():
            in_data = _wrap(ins)
            out_data = _wrap(torch.zeros(s, dtype=t, device=device)
                             for s, t in out_specs)
            op.forward(is_train, ["write"] * len(out_data), in_data,
                       out_data, [])
            return [o._data for o in out_data]
        outs = _on_worker(_on_device(device, _stream(device), run))
        ctx.op = op
        ctx.save_for_backward(*ins, *outs)
        ctx.n_in = len(ins)
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        ins, outs = saved[:ctx.n_in], saved[ctx.n_in:]
        device = ins[0].device
        op = ctx.op

        def run():
            in_grad = _wrap(torch.zeros_like(x) for x in ins)
            op.backward(["write"] * len(ins),
                        _wrap(g.contiguous() if g is not None
                              else torch.zeros_like(o)
                              for g, o in zip(grads, outs)),
                        _wrap(ins), _wrap(outs), in_grad, [])
            return [g._data for g in in_grad]
        igrads = _on_worker(_on_device(device, _stream(device), run))
        return (None, None, None) + tuple(
            g if x.is_floating_point() else None
            for g, x in zip(igrads, ins))


def _custom_impl(attrs, *inputs):
    prop = _make_prop(attrs)
    if prop.list_auxiliary_states():
        raise MXNetError(
            "Custom ops with auxiliary states are not supported; carry "
            "state through explicit outputs instead")
    in_shapes, in_types, out_shapes, out_types = _signature(prop, inputs)
    if inputs and inputs[0].device.type == "meta":
        # shape inference (Symbol.infer_shape, a loop body's): the
        # prop's signature alone
        return tuple(torch.empty(s, dtype=t, device="meta")
                     for s, t in zip(out_shapes, out_types))
    from .context import context_of
    op = prop.create_operator(context_of(inputs[0].device), in_shapes,
                              in_types)
    outs = _CustomFunction.apply(op, bool(attrs.get("__train__", False)),
                                 list(zip(out_shapes, out_types)), *inputs)
    return outs if len(outs) > 1 else outs[0]


def _register_custom_opdef():
    from .ops.registry import register as _register_op
    _register_op("Custom", _custom_impl,
                 arg_names=("data",),
                 defaults={"op_type": None, "__train__": False},
                 num_outputs=_custom_num_outputs,
                 arg_names_fn=_custom_arg_names, host_code=True)


_register_custom_opdef()
