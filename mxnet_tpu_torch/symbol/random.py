"""``mx.sym.random`` (counterpart of ``mxnet_tpu/symbol/random.py``):
Symbol parameters route to the ``_sample_*`` ops, scalars to the
``_random_*`` ops."""
from __future__ import annotations

from .symbol import Symbol, create

__all__ = ["uniform", "normal", "gamma", "exponential", "poisson",
           "randint", "multinomial", "shuffle"]


def _random(op_scalar, op_tensor, params, scalar_attrs, shape, dtype):
    if any(isinstance(p, Symbol) for p in params):
        return create(op_tensor, list(params),
                      {"shape": shape, "dtype": dtype})
    attrs = dict(scalar_attrs)
    attrs.update({"shape": shape, "dtype": dtype})
    return create(op_scalar, [], attrs)


def uniform(low=0, high=1, shape=(), dtype="float32", **kwargs):
    return _random("_random_uniform", "_sample_uniform", [low, high],
                   {"low": low, "high": high}, shape, dtype)


def normal(loc=0, scale=1, shape=(), dtype="float32", **kwargs):
    return _random("_random_normal", "_sample_normal", [loc, scale],
                   {"loc": loc, "scale": scale}, shape, dtype)


def gamma(alpha=1, beta=1, shape=(), dtype="float32", **kwargs):
    return _random("_random_gamma", "_sample_gamma", [alpha, beta],
                   {"alpha": alpha, "beta": beta}, shape, dtype)


def exponential(scale=1, shape=(), dtype="float32", **kwargs):
    return create("_random_exponential", [],
                  {"lam": 1.0 / scale, "shape": shape, "dtype": dtype})


def poisson(lam=1, shape=(), dtype="float32", **kwargs):
    return create("_random_poisson", [],
                  {"lam": lam, "shape": shape, "dtype": dtype})


def randint(low, high, shape=(), dtype="int32", **kwargs):
    return create("_random_randint", [],
                  {"low": low, "high": high, "shape": shape, "dtype": dtype})


def multinomial(data, shape=(), get_prob=False, dtype="int32", **kwargs):
    return create("_sample_multinomial", [data],
                  {"shape": shape, "get_prob": get_prob, "dtype": dtype})


def shuffle(data, **kwargs):
    return create("_shuffle", [data], {})
