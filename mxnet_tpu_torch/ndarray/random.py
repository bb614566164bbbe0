"""``mx.nd.random`` (counterpart of ``mxnet_tpu/ndarray/random.py``).

Scalar parameters route to the ``_random_*`` ops, NDArray parameters to
the ``_sample_*`` ops (one draw block of ``shape`` per parameter
element), as the reference's ``_random_helper`` dispatches
(python/mxnet/ndarray/random.py:36). A scalar draw lands on ``ctx``
(default: the current context, ``gpu(0)``) and is made there, from that
device's generator.
"""
from __future__ import annotations

from .ndarray import NDArray, invoke_nd
from ..context import current_context

__all__ = ["uniform", "normal", "randn", "poisson", "exponential", "gamma",
           "multinomial", "negative_binomial", "generalized_negative_binomial",
           "randint", "shuffle"]


def _random(op_scalar, op_tensor, params, scalar_kwargs, shape, dtype, ctx,
            out):
    if any(isinstance(p, NDArray) for p in params):
        return invoke_nd(op_tensor, list(params),
                         {"shape": shape, "dtype": dtype}, out=out)
    attrs = dict(scalar_kwargs)
    attrs.update({"shape": shape, "dtype": dtype})
    return invoke_nd(op_scalar, [], attrs, ctx=ctx or current_context(),
                     out=out)


def uniform(low=0, high=1, shape=(), dtype="float32", ctx=None, out=None,
            **kwargs):
    return _random("_random_uniform", "_sample_uniform", [low, high],
                   {"low": low, "high": high}, shape, dtype, ctx, out)


def normal(loc=0, scale=1, shape=(), dtype="float32", ctx=None, out=None,
           **kwargs):
    return _random("_random_normal", "_sample_normal", [loc, scale],
                   {"loc": loc, "scale": scale}, shape, dtype, ctx, out)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None, **kwargs):
    return normal(loc=loc, scale=scale, shape=shape, dtype=dtype, ctx=ctx)


def poisson(lam=1, shape=(), dtype="float32", ctx=None, out=None, **kwargs):
    return _random("_random_poisson", "_sample_poisson", [lam],
                   {"lam": lam}, shape, dtype, ctx, out)


def exponential(scale=1, shape=(), dtype="float32", ctx=None, out=None,
                **kwargs):
    """Exponential draws of mean ``scale``: the ops take the rate
    ``1/scale``, an NDArray scale too (the JAX package's wrapper hands
    an NDArray scale over as the rate)."""
    lam = 1.0 / scale
    return _random("_random_exponential", "_sample_exponential", [lam],
                   {"lam": lam}, shape, dtype, ctx, out)


def gamma(alpha=1, beta=1, shape=(), dtype="float32", ctx=None, out=None,
          **kwargs):
    return _random("_random_gamma", "_sample_gamma", [alpha, beta],
                   {"alpha": alpha, "beta": beta}, shape, dtype, ctx, out)


def negative_binomial(k=1, p=1, shape=(), dtype="float32", ctx=None,
                      out=None, **kwargs):
    return _random("_random_negative_binomial", "_sample_negative_binomial",
                   [k, p], {"k": k, "p": p}, shape, dtype, ctx, out)


def generalized_negative_binomial(mu=1, alpha=1, shape=(), dtype="float32",
                                  ctx=None, out=None, **kwargs):
    return _random("_random_generalized_negative_binomial",
                   "_sample_generalized_negative_binomial",
                   [mu, alpha], {"mu": mu, "alpha": alpha}, shape, dtype,
                   ctx, out)


def randint(low, high, shape=(), dtype="int32", ctx=None, out=None, **kwargs):
    return invoke_nd("_random_randint", [],
                     {"low": low, "high": high, "shape": shape,
                      "dtype": dtype}, ctx=ctx or current_context(), out=out)


def multinomial(data, shape=(), get_prob=False, out=None, dtype="int32",
                **kwargs):
    return invoke_nd("_sample_multinomial", [data],
                     {"shape": shape, "get_prob": get_prob, "dtype": dtype},
                     out=out)


def shuffle(data, **kwargs):
    return invoke_nd("_shuffle", [data], {})
