"""Reductions and the L1/L2 ``norm`` (counterpart of
``mxnet_tpu/ops/reduce.py``): ``axis`` may
be None, an int or a tuple, ``exclude=True`` reduces over the complement
(``Loss._finish``'s mean over the non-batch axes), ``keepdims`` keeps the
reduced dims as 1."""
from __future__ import annotations

import torch

from .registry import register

_D = ("data",)


def _norm_axis(attrs, ndim):
    axis = attrs.get("axis", None)
    if axis is None or axis == () or axis == []:
        axes = tuple(range(ndim))
    elif isinstance(axis, int):
        axes = (axis % ndim,)
    else:
        axes = tuple(a % ndim for a in axis)
    if attrs.get("exclude", False):
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


def _reg_reduce(name, fn):
    def fwd(attrs, x):
        axes = _norm_axis(attrs, x.ndim)
        if not axes:            # nothing to reduce (torch reads dim=() as all)
            return x
        return fn(x, axes, bool(attrs.get("keepdims", False)))
    register(name, fwd, arg_names=_D,
             defaults={"axis": None, "keepdims": False, "exclude": False})


_reg_reduce("sum", lambda x, a, k: torch.sum(x, dim=a, keepdim=k))
_reg_reduce("mean", lambda x, a, k: torch.mean(x, dim=a, keepdim=k))
_reg_reduce("max", lambda x, a, k: torch.amax(x, dim=a, keepdim=k))
_reg_reduce("min", lambda x, a, k: torch.amin(x, dim=a, keepdim=k))


def _norm(attrs, x):
    """The L1 (``ord=1``) or L2 norm over ``axis`` (all axes by
    default)."""
    axes = _norm_axis(attrs, x.ndim)
    k = bool(attrs.get("keepdims", False))
    if int(attrs.get("ord", 2)) == 1:
        return torch.sum(torch.abs(x), dim=axes, keepdim=k)
    return torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=k))


register("norm", _norm, arg_names=_D,
         defaults={"axis": None, "keepdims": False, "exclude": False,
                   "ord": 2})
