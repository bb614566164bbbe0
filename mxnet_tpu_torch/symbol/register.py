"""Generated Symbol op namespace (counterpart of
``mxnet_tpu/symbol/register.py``): one stub per registered op, taking
Symbols positionally or by input name, the remaining keyword arguments
as attributes, ``name=`` and ``attr=``."""
from __future__ import annotations

from .. import ops as _ops
from .symbol import Symbol, create

__all__ = ["make_stub", "install_ops"]


def make_stub(op):
    def stub(*args, **kwargs):
        name = kwargs.pop("name", None)
        kwargs.pop("out", None)
        attr = kwargs.pop("attr", None)
        symbols, pos_attrs = [], []
        for a in args:
            if a is None:
                continue
            if isinstance(a, Symbol):
                symbols.append(a)
            elif isinstance(a, (list, tuple)) and a \
                    and all(isinstance(x, Symbol) for x in a):
                symbols.extend(a)
            else:
                pos_attrs.append(a)
        if pos_attrs:
            # trailing positional parameters map onto the op's attrs in
            # declaration order, as in the NDArray stubs
            free = [k for k in op.defaults
                    if k not in kwargs and not k.startswith("__")]
            if len(pos_attrs) > len(free):
                raise TypeError(
                    "%s: %d trailing positional attribute(s) %r but only "
                    "%d free keyword parameter(s) %r remain"
                    % (op.name, len(pos_attrs), tuple(pos_attrs),
                       len(free), tuple(free)))
            kwargs.update(zip(free, pos_attrs))
        named = {k: kwargs.pop(k) for k in list(kwargs)
                 if isinstance(kwargs[k], Symbol)}
        if named:
            arg_names = op.resolve_arg_names(kwargs, num_inputs=len(named))
            bound = dict(zip(arg_names, symbols))
            bound.update(named)
            symbols = [bound[n] for n in arg_names if n in bound]
        out = create(op, symbols, kwargs, name=name)
        if attr:
            out._set_attr(**attr)
        return out

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
