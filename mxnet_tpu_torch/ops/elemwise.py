"""Elementwise operators (counterpart of ``mxnet_tpu/ops/elemwise.py``):
unary math, broadcasting binary, scalar and logical ops, ``where``, and
the identity-forward heads ``BlockGrad`` and ``MakeLoss``. MXNet's dtype
conventions are kept: comparisons and logical ops return 0/1 in the
input dtype, and a scalar operand takes the array's dtype (an integer
array gets an integer scalar).

Where torch and JAX part: ``round`` rounds half to even (``jnp.round``;
torch's ``round`` does the same), ``fix`` truncates, and ``_mod`` takes
the divisor's sign (``jnp.mod``: ``torch.remainder``, not ``fmod``)."""
from __future__ import annotations

import math

import torch

from .registry import register

_D = ("data",)
_LR = ("lhs", "rhs")


def _cbrt(x):
    """The real cube root (torch has none): sign(x) |x|^(1/3)."""
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _gamma(x):
    """Gamma as ``jax.scipy.special.gamma`` computes it: its sign times
    exp(lgamma(x)), NaN at the poles (0 and the negative integers keep
    JAX's answers: the sign of 0, NaN below it)."""
    fl = torch.floor(x)
    sign = torch.where(x > 0, torch.ones_like(x),
                       1.0 - 2.0 * torch.remainder(fl, 2.0))
    sign = torch.where((x < 0) & (x == fl), torch.full_like(x, math.nan),
                       sign)
    return sign * torch.exp(torch.lgamma(x))


_UNARY = {
    "abs": torch.abs, "square": torch.square,
    "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
    "relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "negative": torch.neg,
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "_copy": lambda x: x.clone(),
    "identity": lambda x: x.clone(),
    "zeros_like": torch.zeros_like,
    "ones_like": torch.ones_like,
    "sign": torch.sign, "ceil": torch.ceil, "floor": torch.floor,
    "trunc": torch.trunc, "fix": torch.trunc,
    "round": torch.round, "rint": torch.round,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt, "rcbrt": lambda x: 1.0 / _cbrt(x),
    "log10": torch.log10, "log2": torch.log2,
    "log1p": torch.log1p, "expm1": torch.expm1,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "erf": torch.erf, "erfinv": torch.erfinv,
    "gamma": _gamma, "gammaln": torch.lgamma,
    "reciprocal": lambda x: 1.0 / x,
    "logical_not": lambda x: (x == 0).to(x.dtype),
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


def _hypot(x, y):
    """sqrt(x² + y²) as ``jnp.hypot`` computes it (the larger magnitude
    times sqrt(1 + ratio²)), so the gradient at x = y = 0 is finite
    (``torch.hypot``'s is NaN there)."""
    x, y = torch.abs(x), torch.abs(y)
    hi, lo = torch.maximum(x, y), torch.minimum(x, y)
    zero = hi == 0
    ratio = lo / torch.where(zero, torch.ones_like(hi), hi)
    return torch.where(zero, hi, hi * torch.sqrt(1 + torch.square(ratio)))


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
    "broadcast_minimum": torch.minimum,
    "broadcast_mod": torch.remainder,
    "broadcast_hypot": lambda x, y: _hypot(x, y),
    "broadcast_equal": _cmp(torch.eq),
    "broadcast_not_equal": _cmp(torch.ne),
    "broadcast_greater": _cmp(torch.gt),
    "broadcast_greater_equal": _cmp(torch.ge),
    "broadcast_lesser": _cmp(torch.lt),
    "broadcast_lesser_equal": _cmp(torch.le),
    "broadcast_logical_and": _cmp(lambda x, y: (x != 0) & (y != 0)),
    "broadcast_logical_or": _cmp(lambda x, y: (x != 0) | (y != 0)),
    "broadcast_logical_xor": _cmp(lambda x, y: (x != 0) ^ (y != 0)),
}

_BINARY_ALIASES = {
    "broadcast_add": ("broadcast_plus", "elemwise_add", "_plus", "_add"),
    "broadcast_sub": ("broadcast_minus", "elemwise_sub", "_minus", "_sub"),
    "broadcast_mul": ("elemwise_mul", "_mul"),
    "broadcast_div": ("elemwise_div", "_div"),
    "broadcast_power": ("_power", "_pow"),
    "broadcast_mod": ("_mod",),
    "broadcast_maximum": ("_maximum",),
    "broadcast_minimum": ("_minimum",),
    "broadcast_hypot": ("_hypot",),
    "broadcast_equal": ("_equal",),
    "broadcast_not_equal": ("_not_equal",),
    "broadcast_greater": ("_greater",),
    "broadcast_greater_equal": ("_greater_equal",),
    "broadcast_lesser": ("_lesser",),
    "broadcast_lesser_equal": ("_lesser_equal",),
    "broadcast_logical_and": ("_logical_and",),
    "broadcast_logical_or": ("_logical_or",),
    "broadcast_logical_xor": ("_logical_xor",),
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
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(_full0(x, s), x),
    "_maximum_scalar": lambda x, s: torch.maximum(x, _full0(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, _full0(x, s)),
    "_hypot_scalar": lambda x, s: _hypot(x, _full0(x, s)),
    "_equal_scalar": lambda x, s: (x == s).to(x.dtype),
    "_not_equal_scalar": lambda x, s: (x != s).to(x.dtype),
    "_greater_scalar": lambda x, s: (x > s).to(x.dtype),
    "_greater_equal_scalar": lambda x, s: (x >= s).to(x.dtype),
    "_lesser_scalar": lambda x, s: (x < s).to(x.dtype),
    "_lesser_equal_scalar": lambda x, s: (x <= s).to(x.dtype),
    "_logical_and_scalar": lambda x, s: ((x != 0) & (s != 0)).to(x.dtype),
    "_logical_or_scalar": lambda x, s: ((x != 0) | (s != 0)).to(x.dtype),
    "_logical_xor_scalar": lambda x, s: ((x != 0) ^ (s != 0)).to(x.dtype),
    # on sparse storage these touch only the stored values; the dense
    # body is the plain scalar op, as in the JAX package
    "_scatter_plus_scalar": lambda x, s: x + s,
    "_scatter_minus_scalar": lambda x, s: x - s,
}


def _full0(x, s):
    """The scalar as a 0-d tensor on ``x``'s device in its dtype (a fill
    kernel, no host copy: safe inside a CUDA graph capture)."""
    return torch.full((), s, dtype=x.dtype, device=x.device)

for _name, _fn in _SCALAR.items():
    register(_name, lambda attrs, x, _f=_fn: _f(x, _sc(x, attrs)),
             arg_names=_D, defaults={"scalar": 0.0})


register("_scatter_elemwise_div", lambda attrs, x, y: x / y, arg_names=_LR)

register("where", lambda attrs, c, x, y: torch.where(c != 0, x, y),
         arg_names=("condition", "x", "y"))


def _smooth_l1(attrs, x):
    s2 = float(attrs.get("scalar", 1.0)) ** 2
    return torch.where(torch.abs(x) < 1.0 / s2, 0.5 * s2 * torch.square(x),
                       torch.abs(x) - 0.5 / s2)


register("smooth_l1", _smooth_l1, arg_names=_D, defaults={"scalar": 1.0})
register("BlockGrad", lambda attrs, x: x.detach(), arg_names=_D,
         aliases=("stop_gradient",))


def _int_index(values, device):
    """A 1-D int32 tensor of static ``values`` built on ``device`` by
    fill kernels (no host copy)."""
    if not values:
        return torch.zeros((0,), dtype=torch.int32, device=device)
    return torch.stack([torch.full((), int(v), dtype=torch.int32,
                                   device=device) for v in values])


register("shape_array", lambda attrs, x: _int_index(x.shape, x.device),
         arg_names=_D)
register("size_array", lambda attrs, x: _int_index([x.numel()], x.device),
         arg_names=_D)


class _MakeLoss(torch.autograd.Function):
    """Identity forward; the backward is ``grad_scale`` everywhere,
    whatever the head gradient (the JAX package's custom VJP, which
    reads neither ``normalization`` nor ``valid_thresh``)."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, ctx.scale), None


register("make_loss",
         lambda attrs, x: _MakeLoss.apply(
             x, float(attrs.get("grad_scale", 1.0))),
         arg_names=_D, defaults={"grad_scale": 1.0, "valid_thresh": 0.0,
                                 "normalization": "null"},
         aliases=("MakeLoss",))
