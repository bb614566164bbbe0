"""Elementwise operators (counterpart of ``mxnet_tpu/ops/elemwise.py``):
the unary, broadcasting binary and scalar ops that NDArray arithmetic
and the losses reach, and ``where``. MXNet's dtype conventions are kept:
comparisons return 0/1 in the input dtype, and a scalar operand takes
the array's dtype (an integer array gets an integer scalar)."""
from __future__ import annotations

import torch

from .registry import register

_D = ("data",)
_LR = ("lhs", "rhs")

_UNARY = {
    "abs": torch.abs, "square": torch.square,
    "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
    "relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "negative": torch.neg,
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "_copy": lambda x: x.clone(),
    "zeros_like": torch.zeros_like,
    "ones_like": torch.ones_like,
}

for _name, _fn in _UNARY.items():
    register(_name, lambda attrs, x, _f=_fn: _f(x), arg_names=_D)


def _cast(attrs, x):
    # always a new array, as every MXNet op returns (torch's .to()
    # would hand back the input itself when the dtype already matches)
    from ..ndarray.ndarray import torch_dtype
    return x.to(torch_dtype(attrs["dtype"]), copy=True)


register("Cast", _cast, arg_names=_D, defaults={"dtype": "float32"},
         aliases=("cast",))
register("clip",
         lambda attrs, x: torch.clamp(x, float(attrs["a_min"]),
                                      float(attrs["a_max"])),
         arg_names=_D, defaults={"a_min": 0.0, "a_max": 1.0})


def _cmp(fn):
    def run(x, y):
        return fn(x, y).to(torch.result_type(x, y))
    return run


_BINARY = {
    "broadcast_add": torch.add,
    "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul,
    "broadcast_div": torch.div,
    "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum,
    "broadcast_equal": _cmp(torch.eq),
    "broadcast_not_equal": _cmp(torch.ne),
    "broadcast_greater": _cmp(torch.gt),
    "broadcast_greater_equal": _cmp(torch.ge),
    "broadcast_lesser": _cmp(torch.lt),
    "broadcast_lesser_equal": _cmp(torch.le),
}

_BINARY_ALIASES = {
    "broadcast_add": ("broadcast_plus", "elemwise_add", "_plus", "_add"),
    "broadcast_sub": ("broadcast_minus", "elemwise_sub", "_minus", "_sub"),
    "broadcast_mul": ("elemwise_mul", "_mul"),
    "broadcast_div": ("elemwise_div", "_div"),
    "broadcast_power": ("_power", "_pow"),
    "broadcast_maximum": ("_maximum",),
}

for _name, _fn in _BINARY.items():
    register(_name, lambda attrs, x, y, _f=_fn: _f(x, y), arg_names=_LR,
             aliases=_BINARY_ALIASES.get(_name, ()))


def _sc(x, attrs):
    """The scalar operand in the array's dtype family."""
    s = attrs.get("scalar", 0.0)
    if x.dtype.is_floating_point:
        return float(s)
    return int(s)


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_equal_scalar": lambda x, s: (x == s).to(x.dtype),
    "_not_equal_scalar": lambda x, s: (x != s).to(x.dtype),
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
    "_greater_equal_scalar": lambda x, s: (x >= s).to(x.dtype),
    "_lesser_scalar": lambda x, s: (x < s).to(x.dtype),
    "_lesser_equal_scalar": lambda x, s: (x <= s).to(x.dtype),
}

for _name, _fn in _SCALAR.items():
    register(_name, lambda attrs, x, _f=_fn: _f(x, _sc(x, attrs)),
             arg_names=_D, defaults={"scalar": 0.0})


register("where", lambda attrs, c, x, y: torch.where(c != 0, x, y),
         arg_names=("condition", "x", "y"))
