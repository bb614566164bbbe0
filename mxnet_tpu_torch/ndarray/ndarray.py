"""NDArray — the user-visible array type (counterpart of
``mxnet_tpu/ndarray/ndarray.py``).

An :class:`NDArray` is a mutable handle over ONE ``torch.Tensor``
(``_data``); its context is the tensor's device. Every operator runs
through the op registry (:func:`invoke_nd`) with torch's gradient
recording switched on only inside ``autograd.record()``: outside it no
graph is built, even over parameters that require gradients (at GPT-2
width a graph kept alive by the parameters would cost gigabytes).

A :class:`MeshNDArray` is one array over the in-process ``dp`` mesh
(``gluon.utils.split_and_load`` and a bound executor's batch over a
context list on distinct devices): its value is a ``MeshTensor``, one
shard a device. It reads as the whole array: ``shape`` is the global
one, ``asnumpy()`` joins the shards on the host, ``as_in_context`` to
one context gathers, and an op over it runs by the op's mesh rule
(``ops.registry.call``). Code that reads its ``_data`` gets the whole
value, gathered on the mesh's first device.

``attach_grad`` turns the handle's tensor into a torch leaf that
requires grad; ``autograd.backward`` then writes (``grad_req='write'``)
or adds (``'add'``) the leaf's gradient into the handle's ``grad``
NDArray. In-place writes (``x[:] = v``) copy into the tensor without
recording.

:func:`save` / :func:`load` keep the JAX package's file format (an npz
payload, a list under indexed keys, written to a temporary file and
renamed), so a file written by either package loads in the other.
"""
from __future__ import annotations

import os
import weakref

import numpy as np
import torch

from ..base import MXNetError, integer_types, numeric_types
from ..context import Context, as_context, context_of, current_context
from .. import ops as _ops

__all__ = ["NDArray", "MeshNDArray", "invoke_nd", "array", "zeros", "ones", "full",
           "empty", "arange", "linspace", "eye", "moveaxis", "concatenate",
           "save", "load", "waitall", "imperative_mixed_precision", "add", "subtract", "multiply",
           "divide", "modulo", "power", "maximum", "minimum", "hypot",
           "equal", "not_equal", "greater", "greater_equal", "lesser",
           "lesser_equal", "logical_and", "logical_or", "logical_xor",
           "true_divide", "torch_dtype", "numpy_dtype"]

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}
_NUMPY_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def torch_dtype(dtype):
    """A numpy dtype, its name or a torch dtype, as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise MXNetError("unsupported dtype %r" % (dtype,))


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype (bfloat16 has none: its name)."""
    name = _NUMPY_NAMES[dtype]
    return name if name == "bfloat16" else np.dtype(name)


def _canonical(dtype):
    """MXNet's array() defaults: float64 → float32, int64 → int32."""
    dtype = np.dtype(dtype)
    return {np.dtype(np.float64): np.dtype(np.float32),
            np.dtype(np.int64): np.dtype(np.int32)}.get(dtype, dtype)


class NDArray:
    """Multi-dimensional array on a device."""

    __array_priority__ = 1000.0
    # (note, output index) of the recorded op that made this array
    # (``invoke_nd`` under ``autograd.record()``; ``autograd.get_symbol``)
    _tape = None

    def __init__(self, data):
        self._data = data          # torch.Tensor
        self.grad = None           # NDArray or None
        self._grad_req = "null"
        self._fresh_grad = False

    # -- basic properties ------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def context(self):
        return context_of(self._data.device)

    ctx = context

    @property
    def T(self):
        return self.transpose()

    @property
    def stype(self):
        """The storage type: ``"default"`` (dense); the sparse arrays of
        ``ndarray/sparse.py`` say ``"csr"`` or ``"row_sparse"``."""
        return "default"

    @property
    def handle(self):
        """The array's tensor (the reference exposes its C handle here)."""
        return self._data

    # -- host transfer ---------------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def asnumpy(self):
        """A copy on the host (never a view of a CPU tensor)."""
        return self._data.detach().to("cpu", copy=True).numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self._data.detach().reshape(()).item()

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            str(self.asnumpy()), "x".join(str(s) for s in self.shape),
            self.context)

    # -- conversion ------------------------------------------------------
    def astype(self, dtype, copy=True):
        if not copy and self._data.dtype == torch_dtype(dtype):
            return self
        return invoke_nd("Cast", [self], {"dtype": np.dtype(dtype).name
                                          if not isinstance(dtype, str)
                                          else dtype})

    def copy(self):
        return invoke_nd("_copy", [self], {})

    def copyto(self, other):
        if isinstance(other, NDArray):
            if other is not self:
                with torch.no_grad():
                    other._data.copy_(self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device(),
                                                  copy=True))
        raise TypeError("copyto does not support type " + str(type(other)))

    def as_in_context(self, context):
        if self.context == context:
            return self
        return self.copyto(context)

    as_in_ctx = as_in_context

    def as_nd_ndarray(self):
        return self

    def tostype(self, stype):
        """This array for ``"default"``, else its ``cast_storage`` to
        ``"csr"`` or ``"row_sparse"``."""
        if stype == "default":
            return self
        from . import sparse as _sp
        return _sp.cast_storage(self, stype)

    def to_dlpack_for_read(self):
        return torch.utils.dlpack.to_dlpack(self._data.detach())

    # -- mutation --------------------------------------------------------
    def _set_data(self, new_data):
        if self.grad is not None:       # a marked variable stays a leaf
            new_data = new_data.detach().requires_grad_(True)
            new_data._mx_owner = weakref.ref(self)
        self._data = new_data

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, numeric_types):
            value = torch.as_tensor(np.asarray(value),
                                    device=self._data.device)
        with torch.no_grad():
            self._data[_clean_index(key)] = value

    def __getitem__(self, key):
        from .. import autograd
        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(self._data[_clean_index(key)])

    # -- autograd --------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a variable: a torch leaf whose gradient
        ``autograd.backward`` writes (or adds) into :attr:`grad`."""
        from .. import autograd
        autograd.mark_variables([self], [zeros(self.shape, ctx=self.context,
                                               dtype=self.dtype)],
                                grad_req)

    def detach(self):
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # -- named methods (the subset the slice uses) -----------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if not shape:
            shape = kwargs.get("shape", None)
        return invoke_nd("Reshape", [self],
                         {"shape": tuple(shape),
                          "reverse": kwargs.get("reverse", False)})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        from .. import autograd
        with torch.set_grad_enabled(autograd.is_recording()):
            data = self._data.permute(*axes) if axes else self._data.permute(
                *reversed(range(self.ndim)))
        return NDArray(data)

    def swapaxes(self, dim1, dim2):
        return invoke_nd("SwapAxis", [self], {"dim1": dim1, "dim2": dim2})

    def slice_axis(self, axis, begin, end):
        return invoke_nd("slice_axis", [self],
                         {"axis": axis, "begin": begin, "end": end})

    def expand_dims(self, axis):
        return invoke_nd("expand_dims", [self], {"axis": axis})

    def flip(self, axis):
        return invoke_nd("reverse", [self], {"axis": axis})

    def clip(self, a_min, a_max):
        return invoke_nd("clip", [self], {"a_min": a_min, "a_max": a_max})

    def sum(self, axis=None, keepdims=False, exclude=False):
        return invoke_nd("sum", [self], {"axis": axis, "keepdims": keepdims,
                                         "exclude": exclude})

    def mean(self, axis=None, keepdims=False, exclude=False):
        return invoke_nd("mean", [self], {"axis": axis, "keepdims": keepdims,
                                          "exclude": exclude})

    def max(self, axis=None, keepdims=False):
        return invoke_nd("max", [self], {"axis": axis, "keepdims": keepdims})

    def min(self, axis=None, keepdims=False):
        return invoke_nd("min", [self], {"axis": axis, "keepdims": keepdims})

    def abs(self):
        return invoke_nd("abs", [self], {})

    def square(self):
        return invoke_nd("square", [self], {})

    def sqrt(self):
        return invoke_nd("sqrt", [self], {})

    def exp(self):
        return invoke_nd("exp", [self], {})

    def log(self):
        return invoke_nd("log", [self], {})

    def relu(self):
        return invoke_nd("relu", [self], {})

    def softmax(self, axis=-1):
        return invoke_nd("softmax", [self], {"axis": axis})

    def log_softmax(self, axis=-1):
        return invoke_nd("log_softmax", [self], {"axis": axis})

    def pick(self, index, axis=-1, keepdims=False):
        return invoke_nd("pick", [self, _as_nd(index, self.context)],
                         {"axis": axis, "keepdims": keepdims})

    def zeros_like(self):
        return invoke_nd("zeros_like", [self], {})

    def ones_like(self):
        return invoke_nd("ones_like", [self], {})

    def _op1(self, name, **attrs):
        return invoke_nd(name, [self], attrs)

    def reshape_like(self, other):
        return invoke_nd("reshape_like", [self, other], {})

    def flatten(self):
        return self._op1("Flatten")

    def squeeze(self, axis=None):
        return self._op1("squeeze", axis=axis)

    def broadcast_to(self, shape):
        return self._op1("broadcast_to", shape=tuple(shape))

    def broadcast_like(self, other):
        return invoke_nd("broadcast_like", [self, other], {})

    def tile(self, reps):
        return self._op1("tile", reps=tuple(reps))

    def repeat(self, repeats, axis=None):
        return self._op1("repeat", repeats=repeats, axis=axis)

    def pad(self, mode, pad_width, constant_value=0.0):
        return self._op1("Pad", mode=mode, pad_width=pad_width,
                         constant_value=constant_value)

    def slice(self, begin, end, step=None):
        return self._op1("slice", begin=begin, end=end, step=step)

    def take(self, indices, axis=0, mode="clip"):
        return invoke_nd("take", [self, _as_nd(indices, self.context)],
                         {"axis": axis, "mode": mode})

    def one_hot(self, depth, **kwargs):
        return invoke_nd("one_hot", [self], dict(kwargs, depth=depth))

    def sort(self, axis=-1, is_ascend=True):
        return self._op1("sort", axis=axis, is_ascend=is_ascend)

    def argsort(self, axis=-1, is_ascend=True):
        return self._op1("argsort", axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return self._op1("topk", axis=axis, k=k, ret_typ=ret_typ,
                         is_ascend=is_ascend)

    def dot(self, other, transpose_a=False, transpose_b=False):
        return invoke_nd("dot", [self, other],
                         {"transpose_a": transpose_a,
                          "transpose_b": transpose_b})

    def nansum(self, axis=None, keepdims=False, **kwargs):
        return self._op1("nansum", axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False, **kwargs):
        return self._op1("prod", axis=axis, keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return self._op1("norm", ord=ord, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._op1("argmax", axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._op1("argmin", axis=axis, keepdims=keepdims)

    def sign(self):
        return self._op1("sign")

    def sigmoid(self):
        return self._op1("sigmoid")

    def tanh(self):
        return self._op1("tanh")

    def round(self):
        return self._op1("round")

    def floor(self):
        return self._op1("floor")

    def ceil(self):
        return self._op1("ceil")

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return self._op1("SliceChannel", num_outputs=num_outputs, axis=axis,
                         squeeze_axis=squeeze_axis)

    # -- arithmetic and comparison operators -------------------------------
    def _binary(self, other, op, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            return invoke_nd(op, [other, self] if reverse else [self, other],
                             {})
        if isinstance(other, numeric_types):
            name = _RSCALAR.get(scalar_op, scalar_op) if reverse \
                else scalar_op
            return invoke_nd(name, [self], {"scalar": other})
        if isinstance(other, np.ndarray):
            return self._binary(array(other, ctx=self.context), op,
                                scalar_op, reverse)
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

    def __rpow__(self, other):
        return self._binary(other, "broadcast_power", "_power_scalar", True)

    def __mod__(self, other):
        return self._binary(other, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, other):
        return self._binary(other, "broadcast_mod", "_mod_scalar", True)

    def __matmul__(self, other):
        return self.dot(other)

    def __iadd__(self, other):
        self._set_data(self.__add__(other)._data)
        return self

    def __isub__(self, other):
        self._set_data(self.__sub__(other)._data)
        return self

    def __imul__(self, other):
        self._set_data(self.__mul__(other)._data)
        return self

    def __itruediv__(self, other):
        self._set_data(self.__truediv__(other)._data)
        return self

    def __neg__(self):
        return invoke_nd("negative", [self], {})

    def __abs__(self):
        return invoke_nd("abs", [self], {})

    def __eq__(self, other):
        if other is None:
            return False
        return self._binary(other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        if other is None:
            return True
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

    # -- pickling (the JAX NDArray's state, so pickles cross packages) ----
    def __getstate__(self):
        """``{"data": numpy, "ctx": str}``, the JAX NDArray's pickled
        state. numpy has no bfloat16: such an array is stored as float32
        with ``"dtype": "bfloat16"``, which the port restores exactly
        and the JAX package reads as its float32 value."""
        data = self._data.detach()
        state = {"ctx": str(self.context)}
        if data.dtype == torch.bfloat16:
            data = data.to(torch.float32)
            state["dtype"] = "bfloat16"
        state["data"] = data.to("cpu", copy=True).numpy()
        return state

    def __setstate__(self, state):
        data = torch.from_numpy(np.array(state["data"], copy=True))
        if state.get("dtype") == "bfloat16":
            data = data.to(torch.bfloat16)
        self._data = data.to(current_context().torch_device())
        self.grad = None
        self._grad_req = "null"
        self._fresh_grad = False


class MeshNDArray(NDArray):
    """One array over the in-process mesh (module docstring): its value
    is ``_mt``, a ``parallel.mesh.MeshTensor``; ``ctx`` is the first
    context of its list."""

    def __init__(self, value, ctx=None):
        self._mt = value
        self._ctx = ctx if ctx is not None \
            else context_of(value.mesh.devices[0])
        self.grad = None
        self._grad_req = "null"
        self._fresh_grad = False

    @property
    def _data(self):
        return self._mt.full()

    @_data.setter
    def _data(self, value):
        self._mt = _layout_like(value, self._mt)

    @property
    def shape(self):
        return self._mt.shape

    @property
    def size(self):
        return self._mt.numel()

    @property
    def ndim(self):
        return self._mt.dim()

    @property
    def dtype(self):
        return numpy_dtype(self._mt.dtype)

    @property
    def context(self):
        return self._ctx

    ctx = context

    def asnumpy(self):
        return self._mt.host().numpy()

    def as_in_context(self, context):
        """The whole array, gathered on ``context``'s device."""
        return NDArray(self._mt.full().detach().to(context.torch_device(),
                                                   copy=True))

    as_in_ctx = as_in_context

    def copyto(self, other):
        if isinstance(other, MeshNDArray):
            other.assign(self._mt.full())
            return other
        return super().copyto(other)

    def detach(self):
        return MeshNDArray(self._mt.detach(), self._ctx)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return invoke_nd("transpose", [self], {"axes": tuple(axes)})

    def assign(self, value):
        """Write the whole ``value`` (a tensor or NDArray of the global
        shape) into the shards in place; a value of another shape or
        dtype is laid out anew (it must split over the mesh)."""
        if isinstance(value, NDArray):
            value = raw_value(value)
            if type(value) is not torch.Tensor:
                value = value.full()
        mt = self._mt
        if tuple(value.shape) != mt.shape or value.dtype != mt.dtype \
                or mt.axis is None:
            self._mt = _layout_like(value.detach(), mt)
            return
        with torch.no_grad():
            for shard, piece in zip(mt.shards, torch.split(
                    value, mt.shards[0].shape[mt.axis], mt.axis)):
                shard.copy_(piece)

    def __setitem__(self, key, value):
        if isinstance(key, slice) and key == slice(None):
            if isinstance(value, numeric_types):
                with torch.no_grad():
                    for shard in self._mt.shards:
                        shard.fill_(value)
                return
            if not isinstance(value, NDArray):
                value = torch.as_tensor(np.asarray(value))
            self.assign(value)
            return
        whole = self._mt.full().detach().clone()
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, numeric_types):
            value = torch.as_tensor(np.asarray(value), device=whole.device)
        whole[_clean_index(key)] = value
        self._mt = _layout_like(whole, self._mt)


def _layout_like(value, mt):
    """``value`` (a whole tensor) laid out as ``mt``: split along its
    axis, or replicated."""
    from ..base import MXNetError
    if mt.axis is None:
        return mt.mesh.replicate(value)
    if value.dim() <= mt.axis or value.shape[mt.axis] % mt.mesh.size:
        raise MXNetError("shape %s does not split over the %d devices of "
                         "the mesh along axis %d" % (tuple(value.shape),
                                                     mt.mesh.size, mt.axis))
    return mt.mesh.split(value, mt.axis)


def raw_value(nd):
    """What an op reads of ``nd``: its tensor, or a mesh array's
    ``MeshTensor``."""
    return nd._mt if type(nd) is MeshNDArray else nd._data


def wrap_value(value, ctx=None):
    """An NDArray over a tensor, a MeshNDArray over a ``MeshTensor``."""
    if isinstance(value, torch.Tensor):
        return NDArray(value)
    return MeshNDArray(value, ctx)


_RSCALAR = {"_minus_scalar": "_rminus_scalar", "_div_scalar": "_rdiv_scalar",
            "_mod_scalar": "_rmod_scalar", "_power_scalar": "_rpower_scalar"}


def _clean_index(key):
    if isinstance(key, NDArray):
        return key._data.to(torch.long)
    if isinstance(key, tuple):
        return tuple(_clean_index(k) for k in key)
    return key


def _as_nd(x, ctx=None):
    return x if isinstance(x, NDArray) else array(x, ctx=ctx)


def invoke_nd(op_name, inputs, attrs, out=None, ctx=None):
    """Run a registered op on NDArrays (the ``Imperative::Invoke``
    role): gradients are recorded only inside ``autograd.record()``,
    where each output also gets a note of the op for
    ``autograd.get_symbol``; an
    op with a ``__train__`` attribute runs in the autograd train mode;
    the new values of its mutable inputs (BatchNorm's moving statistics)
    are written back into those NDArrays in place, with no grad. An op
    with no input makes its output on ``ctx`` (its ``ctx`` attribute),
    else on the current context, and draws from that device's
    generator."""
    from .. import autograd
    from .. import random as _random
    op = _ops.get_op(op_name) if isinstance(op_name, str) else op_name
    attrs = {k: v for k, v in attrs.items() if v is not None or k == "axis"}
    if "__train__" in op.defaults:
        attrs["__train__"] = autograd.is_training()
    if not inputs and ctx is not None and "ctx" in op.defaults:
        attrs["ctx"] = ctx
    rng = None
    values = [raw_value(i) for i in inputs]
    if op.needs_rng:
        if inputs:
            dev = values[0].device
        else:
            dev = as_context(ctx or attrs.get("ctx")
                             or current_context()).torch_device()
        rng = _random.generator(dev)
    with torch.set_grad_enabled(autograd.is_recording()):
        outputs, aux_updates = _ops.invoke(op, values, attrs, rng=rng)
    with torch.no_grad():
        for idx, val in aux_updates:
            if val is not values[idx]:
                inputs[idx]._data.copy_(val)
    mesh_ctx = next((i._ctx for i in inputs if type(i) is MeshNDArray),
                    None)
    out_nds = [wrap_value(o, mesh_ctx) for o in outputs]
    if autograd.is_recording():
        # what autograd.get_symbol reads: the op, its attributes and where
        # its inputs came from; it goes away with the outputs
        from ..symbol.symbol import _TapeNote
        note = _TapeNote(op, {k: v for k, v in attrs.items()
                              if k != "__train__"}, inputs)
        for i, nd in enumerate(out_nds):
            nd._tape = (note, i)
    if out is not None:
        for o, nd in zip(out if isinstance(out, (list, tuple)) else [out],
                         out_nds):
            o._set_data(nd._data)
        return out
    return out_nds[0] if len(out_nds) == 1 else out_nds


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------

def array(source_array, ctx=None, dtype=None):
    """An NDArray from a list, numpy array or NDArray. Python lists
    default to float32; float64 demotes to float32 and int64 to int32,
    as in the JAX package."""
    ctx = ctx or current_context()
    was_np = isinstance(source_array, (np.ndarray, np.generic, NDArray))
    src = source_array.asnumpy() if isinstance(source_array, NDArray) \
        else np.asarray(source_array)
    if dtype is None:
        dtype = _canonical(src.dtype) if was_np else np.float32
    data = torch.from_numpy(np.array(src, dtype=np.dtype(dtype), copy=True))
    return NDArray(data.to(ctx.torch_device()))


def _shape(shape):
    return (shape,) if isinstance(shape, integer_types) else tuple(shape)


def full(shape, val, ctx=None, dtype=None):
    ctx = ctx or current_context()
    return NDArray(torch.full(_shape(shape), val,
                              dtype=torch_dtype(dtype or "float32"),
                              device=ctx.torch_device()))


def zeros(shape, ctx=None, dtype=None):
    return full(shape, 0, ctx=ctx, dtype=dtype)


def ones(shape, ctx=None, dtype=None):
    return full(shape, 1, ctx=ctx, dtype=dtype)


def concatenate(arrays, axis=0, always_copy=True):
    """The arrays joined along ``axis`` (one new array)."""
    return NDArray(torch.cat([a._data.detach() for a in arrays], dim=axis))


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def _dtype_name(dtype):
    return dtype if isinstance(dtype, str) else np.dtype(dtype).name


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    return invoke_nd("_arange", [], {"start": start, "stop": stop,
                                     "step": step, "repeat": repeat,
                                     "dtype": _dtype_name(dtype)},
                     ctx=ctx or current_context())


def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    return invoke_nd("_linspace", [], {"start": start, "stop": stop,
                                       "num": num, "endpoint": endpoint,
                                       "dtype": _dtype_name(dtype)},
                     ctx=ctx or current_context())


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    return invoke_nd("_eye", [], {"N": N, "M": M, "k": k,
                                  "dtype": _dtype_name(dtype)},
                     ctx=ctx or current_context())


def moveaxis(tensor, source, destination):
    """``tensor`` with the axes ``source`` moved to ``destination``."""
    axes = list(range(tensor.ndim))
    try:
        source = [source] if isinstance(source, int) else list(source)
        destination = [destination] if isinstance(destination, int) \
            else list(destination)
    except TypeError:
        raise MXNetError("bad source/destination")
    for src in source:
        axes.remove(src % tensor.ndim)
    for dst, src in sorted(zip(destination, source)):
        axes.insert(dst % tensor.ndim, src % tensor.ndim)
    return tensor.transpose(axes)


def waitall():
    """Wait for the work queued on every CUDA device."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def imperative_mixed_precision(enable=True):
    """A no-op kept for the reference's AMP hook; mixed precision is
    :mod:`mxnet_tpu_torch.amp`'s dtype policy."""


def _ufunc(lhs, rhs, op, scalar_op, rscalar_op=None):
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        return invoke_nd(op, [lhs, rhs], {})
    if isinstance(lhs, NDArray):
        return invoke_nd(scalar_op, [lhs], {"scalar": rhs})
    if isinstance(rhs, NDArray):
        return invoke_nd(rscalar_op or scalar_op, [rhs], {"scalar": lhs})
    raise TypeError("at least one argument must be an NDArray")


def add(lhs, rhs):
    return _ufunc(lhs, rhs, "broadcast_add", "_plus_scalar")


def subtract(lhs, rhs):
    return _ufunc(lhs, rhs, "broadcast_sub", "_minus_scalar",
                  "_rminus_scalar")


def multiply(lhs, rhs):
    return _ufunc(lhs, rhs, "broadcast_mul", "_mul_scalar")


def divide(lhs, rhs):
    return _ufunc(lhs, rhs, "broadcast_div", "_div_scalar", "_rdiv_scalar")


true_divide = divide


def modulo(lhs, rhs):
    return _ufunc(lhs, rhs, "broadcast_mod", "_mod_scalar", "_rmod_scalar")


def power(base, exp):
    return _ufunc(base, exp, "broadcast_power", "_power_scalar",
                  "_rpower_scalar")


def maximum(lhs, rhs):
    return _ufunc(lhs, rhs, "broadcast_maximum", "_maximum_scalar")


def minimum(lhs, rhs):
    return _ufunc(lhs, rhs, "broadcast_minimum", "_minimum_scalar")


def hypot(lhs, rhs):
    return _ufunc(lhs, rhs, "broadcast_hypot", "_hypot_scalar")


def equal(lhs, rhs):
    return _ufunc(lhs, rhs, "broadcast_equal", "_equal_scalar")


def not_equal(lhs, rhs):
    return _ufunc(lhs, rhs, "broadcast_not_equal", "_not_equal_scalar")


def greater(lhs, rhs):
    return _ufunc(lhs, rhs, "broadcast_greater", "_greater_scalar")


def greater_equal(lhs, rhs):
    return _ufunc(lhs, rhs, "broadcast_greater_equal",
                  "_greater_equal_scalar")


def lesser(lhs, rhs):
    return _ufunc(lhs, rhs, "broadcast_lesser", "_lesser_scalar")


def lesser_equal(lhs, rhs):
    return _ufunc(lhs, rhs, "broadcast_lesser_equal", "_lesser_equal_scalar")


def logical_and(lhs, rhs):
    return _ufunc(lhs, rhs, "broadcast_logical_and", "_logical_and_scalar")


def logical_or(lhs, rhs):
    return _ufunc(lhs, rhs, "broadcast_logical_or", "_logical_or_scalar")


def logical_xor(lhs, rhs):
    return _ufunc(lhs, rhs, "broadcast_logical_xor", "_logical_xor_scalar")


# ---------------------------------------------------------------------------
# save / load (the JAX package's npz format)
# ---------------------------------------------------------------------------

_SAVE_LIST_KEY = "__mxnet_tpu_list__"
# a sparse entry spills its components under reserved key prefixes
# inside the same npz payload (the JAX package's layout, after the
# reference's sparse-aware NDArray::Save, ndarray.cc:1576)
_SP_CSR_KEY = "__sparse_csr__::"
_SP_RSP_KEY = "__sparse_rsp__::"
_SPARSE_LAYOUT = {"csr": (_SP_CSR_KEY, ("data", "indices", "indptr")),
                  "row_sparse": (_SP_RSP_KEY, ("data", "indices"))}


def host_numpy(tensor):
    """A host numpy copy of ``tensor``; bfloat16, which numpy has no
    dtype for, as its raw 2-byte values (``|V2``, as npz keeps an
    extension dtype)."""
    t = tensor.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def tensor_from_numpy(arr):
    """A CPU tensor of a host array; raw 2-byte values (``|V2``) are
    reinterpreted as bfloat16."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _flatten_entry(key, val, arrays, convert=host_numpy):
    """``val``'s tensors, each through ``convert``, into ``arrays``: a
    dense array's under ``key``, a sparse one's components under
    ``<prefix><key>::<part>`` beside its shape (int64)."""
    layout = _SPARSE_LAYOUT.get(val.stype)
    if layout is None:
        arrays[key] = convert(val._data)
        return
    prefix, parts = layout
    for part in parts:
        arrays["%s%s::%s" % (prefix, key, part)] = \
            convert(getattr(val, part)._data)
    arrays["%s%s::shape" % (prefix, key)] = np.asarray(val.shape, np.int64)


def save(fname, data):
    """Write an NDArray, a list of them or a ``{name: NDArray}`` dict
    to ``fname`` (write-then-rename: a preempted save never leaves a
    truncated file there). Sparse arrays are saved in the JAX package's
    component layout."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        items = list(data.items())
    elif isinstance(data, (list, tuple)):
        items = [("%s%d" % (_SAVE_LIST_KEY, i), v)
                 for i, v in enumerate(data)]
    else:
        raise ValueError("data needs to either be a NDArray, dict of (str, "
                         "NDArray) pairs or a list of NDarrays.")
    arrays = {}
    for key, val in items:
        _flatten_entry(key, val, arrays)
    tmp = fname + ".tmp"
    with open(tmp, "wb") as sink:
        np.savez(sink, **arrays)
    os.replace(tmp, fname)


def _host_nd(arr, device):
    if isinstance(arr, torch.Tensor):
        return NDArray(arr.to(device))
    if arr.dtype.kind != "V":
        arr = arr.astype(_canonical(arr.dtype), copy=False)
    return NDArray(tensor_from_numpy(arr).to(device))


def unflatten_arrays(loaded, ctx=None):
    """``{key: NDArray}`` from a mapping of host arrays (numpy arrays or
    CPU tensors) in the :func:`save` layout, on ``ctx`` (the current
    context by default):
    the sparse components are put back together as CSRNDArray and
    RowSparseNDArray entries."""
    from .sparse import CSRNDArray, RowSparseNDArray
    ctx = ctx or current_context()
    device = ctx.torch_device()
    out, sparse_parts = {}, {}
    for k in loaded.keys():
        for stype, (prefix, _) in _SPARSE_LAYOUT.items():
            if k.startswith(prefix):
                name, part = k[len(prefix):].rsplit("::", 1)
                sparse_parts.setdefault((name, stype), {})[part] = loaded[k]
                break
        else:
            out[k] = _host_nd(loaded[k], device)
    for (name, stype), parts in sparse_parts.items():
        shape = tuple(int(s) for s in parts["shape"])
        comps = {p: _host_nd(a, device) for p, a in parts.items()
                 if p != "shape"}
        out[name] = CSRNDArray(comps["data"], comps["indices"],
                               comps["indptr"], shape, ctx=ctx) \
            if stype == "csr" else \
            RowSparseNDArray(comps["data"], comps["indices"], shape, ctx=ctx)
    return out


def load(fname):
    """What :func:`save` (of either package) wrote: a list when it saved
    one, else the ``{name: NDArray}`` dict."""
    with open(fname, "rb") as f:
        out = unflatten_arrays(np.load(f, allow_pickle=False))
    keys = list(out)
    if keys and all(k.startswith(_SAVE_LIST_KEY) for k in keys):
        return [out["%s%d" % (_SAVE_LIST_KEY, i)] for i in range(len(keys))]
    return out
