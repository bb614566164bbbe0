"""Generated NDArray op namespace (counterpart of
``mxnet_tpu/ndarray/register.py``): one stub per registered op, taking
tensors positionally or by input name, the remaining keyword arguments
as attributes, and ``out=``."""
from __future__ import annotations

from .. import ops as _ops
from .ndarray import NDArray, invoke_nd

__all__ = ["make_stub", "install_ops"]


def make_stub(op):
    def stub(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        tensors, pos_attrs = [], []
        for a in args:
            if a is None:
                continue
            if isinstance(a, NDArray):
                tensors.append(a)
            elif isinstance(a, (list, tuple)) and a \
                    and all(isinstance(x, NDArray) for x in a):
                tensors.extend(a)
            else:
                pos_attrs.append(a)
        if pos_attrs:
            # trailing positional parameters map onto the op's attrs in
            # declaration order (nd.softmax(x, 1): axis=1)
            free = [k for k in op.defaults if k not in kwargs]
            kwargs.update(zip(free, pos_attrs))
        named = {k: kwargs.pop(k) for k in list(kwargs)
                 if isinstance(kwargs[k], NDArray)}
        if named:
            arg_names = op.resolve_arg_names(kwargs)
            bound = dict(zip(arg_names, tensors))
            bound.update(named)
            tensors = [bound[n] for n in arg_names if n in bound]
        return invoke_nd(op, tensors, kwargs, out=out)

    stub.__name__ = op.name
    stub.__doc__ = op.doc_signature()
    return stub


def install_ops(namespace):
    """Install one stub per registered op into ``namespace`` (a dict)."""
    seen = {}
    for name in _ops.list_ops():
        op = _ops.get_op(name)
        if id(op) not in seen:
            seen[id(op)] = make_stub(op)
        namespace.setdefault(name, seen[id(op)])
    return namespace
