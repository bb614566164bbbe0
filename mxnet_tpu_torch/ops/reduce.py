"""Reductions, the L1/L2 ``norm``, the index reductions and the
broadcast-shape ops (counterpart of ``mxnet_tpu/ops/reduce.py``):
``axis`` may be None, an int or a tuple, ``exclude=True`` reduces over
the complement (``Loss._finish``'s mean over the non-batch axes),
``keepdims`` keeps the reduced dims as 1. ``argmax``/``argmin`` return
float32 indices, the first index winning a tie (``jnp.argmax``; torch's
``argmax`` promises the first index on both devices)."""
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


def _reg_reduce(name, fn, aliases=()):
    def fwd(attrs, x):
        axes = _norm_axis(attrs, x.ndim)
        if not axes:            # nothing to reduce (torch reads dim=() as all)
            return x
        return fn(x, axes, bool(attrs.get("keepdims", False)))
    register(name, fwd, arg_names=_D,
             defaults={"axis": None, "keepdims": False, "exclude": False},
             aliases=aliases)


class _Prod(torch.autograd.Function):
    """The product along one dim, whose backward multiplies the head
    gradient by the exclusive products from either side (zeros handled
    exactly, as ``jax.grad`` of ``jnp.prod``): torch's own backward
    counts the zeros on the host, which a CUDA graph cannot hold."""

    @staticmethod
    def forward(ctx, x, dim, keepdim):
        ctx.save_for_backward(x)
        ctx.dim, ctx.keepdim = dim, keepdim
        return torch.prod(x, dim=dim, keepdim=keepdim)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        xs = x.movedim(ctx.dim, -1)
        one = torch.ones_like(xs[..., :1])
        left = torch.cumprod(torch.cat([one, xs[..., :-1]], -1), -1)
        right = torch.flip(torch.cumprod(torch.flip(
            torch.cat([xs[..., 1:], one], -1), (-1,)), -1), (-1,))
        g = g if ctx.keepdim else g.unsqueeze(ctx.dim)
        return (left * right).movedim(-1, ctx.dim) * g, None, None


def _prod(x, axes, keepdims):
    """The product over several axes (torch's ``prod`` takes one)."""
    for a in sorted(axes, reverse=True):
        x = _Prod.apply(x, a, keepdims)
    return x


_reg_reduce("sum", lambda x, a, k: torch.sum(x, dim=a, keepdim=k),
            aliases=("sum_axis",))
_reg_reduce("mean", lambda x, a, k: torch.mean(x, dim=a, keepdim=k))
_reg_reduce("prod", _prod)
_reg_reduce("nansum", lambda x, a, k: torch.nansum(x, dim=a, keepdim=k))
_reg_reduce("nanprod", lambda x, a, k: _prod(
    torch.where(torch.isnan(x), torch.ones_like(x), x), a, k))
_reg_reduce("max", lambda x, a, k: torch.amax(x, dim=a, keepdim=k),
            aliases=("max_axis",))
_reg_reduce("min", lambda x, a, k: torch.amin(x, dim=a, keepdim=k),
            aliases=("min_axis",))


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


def _reg_argminmax(name, fn):
    def fwd(attrs, x):
        axis = attrs.get("axis", None)
        if axis is None:
            return fn(x.reshape(-1), 0).to(torch.float32)
        r = fn(x, int(axis))
        if attrs.get("keepdims", False):
            r = r.unsqueeze(int(axis))
        return r.to(torch.float32)
    register(name, fwd, arg_names=_D,
             defaults={"axis": None, "keepdims": False})


_reg_argminmax("argmax", lambda x, a: torch.argmax(x, dim=a))
_reg_argminmax("argmin", lambda x, a: torch.argmin(x, dim=a))
register("argmax_channel",
         lambda attrs, x: torch.argmax(x, dim=1).to(torch.float32),
         arg_names=_D)


def _broadcast_to(attrs, x):
    # 0 in the target shape keeps the input's dim (MXNet convention)
    shape = tuple(x.shape[i] if s == 0 else s
                  for i, s in enumerate(tuple(attrs["shape"])))
    return x.expand(shape)


register("broadcast_to", _broadcast_to, arg_names=_D, defaults={"shape": ()})


def _broadcast_axis(attrs, x):
    axis, size = attrs.get("axis", ()), attrs.get("size", ())
    axis = (axis,) if isinstance(axis, int) else axis
    size = (size,) if isinstance(size, int) else size
    shape = list(x.shape)
    for a, s in zip(axis, size):
        shape[a] = s
    return x.expand(tuple(shape))


register("broadcast_axis", _broadcast_axis, arg_names=_D,
         defaults={"axis": (), "size": ()}, aliases=("broadcast_axes",))
register("broadcast_like", lambda attrs, x, y: x.expand(y.shape),
         arg_names=("lhs", "rhs"))
