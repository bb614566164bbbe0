"""Random sampling operators (counterpart of
``mxnet_tpu/ops/random_ops.py``): the scalar-parameter ``_random_*``
ops, the tensor-parameter ``_sample_*`` ops (one draw block per
parameter element, of shape ``param.shape + shape``),
``_sample_multinomial`` and ``_shuffle``.

Every op ``needs_rng``: it draws from the ``torch.Generator`` of the
device its output lives on (:func:`mxnet_tpu_torch.random.generator`),
never from torch's global state, and draws on that device: nothing is
made on the host and copied over. An op with no tensor input lands on
its ``ctx`` attribute's device, else the current context's. The draws
are other numbers than ``jax.random``'s from the same seed; the
distributions, attributes, defaults, shapes and dtypes are the JAX
package's (poisson and the binomials count in float32).

Gamma draws go through ``torch._standard_gamma`` and Poisson draws
through ``torch.poisson``, both with the generator; a categorical draw
is an inverse-CDF lookup of uniform draws (``searchsorted`` on the
cumulative weights), and a shuffle sorts random 62-bit keys, so that
neither syncs with the host.
"""
from __future__ import annotations

import torch

from .registry import register

_KEY_HIGH = 1 << 62


def _shape(value):
    if value is None:
        return ()
    if isinstance(value, int):
        return (value,)
    return tuple(int(s) for s in value)


def _dtype(attrs, default="float32"):
    from ..ndarray.ndarray import torch_dtype
    return torch_dtype(attrs.get("dtype") or default)


def _ctx_device(attrs):
    """The device of a nullary op: its ``ctx`` attribute's (a Context or
    its string, ``gpu(0)``), else the current context's."""
    from ..context import as_context, current_context
    ctx = attrs.get("ctx")
    return (as_context(ctx) if ctx else current_context()).torch_device()


def _gen(device, rng):
    """``rng`` when it draws on ``device``, else that device's
    generator of :mod:`~mxnet_tpu_torch.random`."""
    if rng is not None and torch.device(rng.device) == torch.device(device):
        return rng
    from .. import random as _random
    return _random.generator(device)


def _gamma(alpha, gen):
    """Gamma(alpha, 1) draws of ``alpha``'s shape (fp32 inside)."""
    return torch._standard_gamma(alpha.to(torch.float32), generator=gen)


def _poisson(lam, gen):
    return torch.poisson(lam.to(torch.float32), generator=gen)


def _nullary_shapes(default_dtype="float32"):
    def rule(attrs):
        return [(_shape(attrs.get("shape", ())),
                 _dtype(attrs, default_dtype))]
    return rule


_RANDOM_DEFAULTS = {"shape": (), "dtype": "float32", "ctx": None}


def _register_random(name, body, params, dtype="float32"):
    """A ``_random_*`` op: ``body(attrs, shape, device, gen)`` draws
    the float32 (or int) values, cast here to ``dtype``."""
    def fwd(attrs, rng=None):
        shape = _shape(attrs.get("shape", ()))
        dev = _ctx_device(attrs)
        out = body(attrs, shape, dev, _gen(dev, rng))
        return out.to(_dtype(attrs, dtype))
    defaults = dict(params)
    defaults.update(_RANDOM_DEFAULTS, dtype=dtype)
    register(name, fwd, arg_names=(), needs_rng=True, defaults=defaults,
             output_shapes=_nullary_shapes(dtype))


def _uniform(attrs, shape, dev, gen):
    return torch.empty(shape, device=dev, dtype=_dtype(attrs)).uniform_(
        float(attrs.get("low", 0.0)), float(attrs.get("high", 1.0)),
        generator=gen)


def _normal(attrs, shape, dev, gen):
    return torch.empty(shape, device=dev, dtype=_dtype(attrs)).normal_(
        float(attrs.get("loc", 0.0)), float(attrs.get("scale", 1.0)),
        generator=gen)


def _full(shape, value, dev):
    return torch.full(shape, float(value), device=dev, dtype=torch.float32)


def _gamma_scalar(attrs, shape, dev, gen):
    return _gamma(_full(shape, attrs.get("alpha", 1.0), dev), gen) \
        * float(attrs.get("beta", 1.0))


def _exponential(attrs, shape, dev, gen):
    return torch.empty(shape, device=dev, dtype=torch.float32
                       ).exponential_(1.0, generator=gen) \
        / float(attrs.get("lam", 1.0))


def _poisson_scalar(attrs, shape, dev, gen):
    return _poisson(_full(shape, attrs.get("lam", 1.0), dev), gen)


def _randint(attrs, shape, dev, gen):
    return torch.randint(int(attrs.get("low", 0)), int(attrs.get("high", 1)),
                         shape, generator=gen, device=dev,
                         dtype=_dtype(attrs, "int32"))


def _neg_binomial_scalar(attrs, shape, dev, gen):
    """NB(k, p) = Poisson(Gamma(k, (1-p)/p))."""
    k = float(attrs.get("k", 1))
    p = float(attrs.get("p", 1.0))
    g = _gamma(_full(shape, k, dev), gen) * ((1.0 - p) / p)
    return _poisson(g, gen)


def _gen_neg_binomial_scalar(attrs, shape, dev, gen):
    mu = float(attrs.get("mu", 1.0))
    alpha = float(attrs.get("alpha", 1.0))
    if alpha == 0.0:
        return _poisson(_full(shape, mu, dev), gen)
    k = 1.0 / alpha
    p = k / (k + mu)
    g = _gamma(_full(shape, k, dev), gen) * ((1.0 - p) / p)
    return _poisson(g, gen)


_register_random("_random_uniform", _uniform, {"low": 0.0, "high": 1.0})
_register_random("_random_normal", _normal, {"loc": 0.0, "scale": 1.0})
_register_random("_random_gamma", _gamma_scalar, {"alpha": 1.0, "beta": 1.0})
_register_random("_random_exponential", _exponential, {"lam": 1.0})
_register_random("_random_poisson", _poisson_scalar, {"lam": 1.0})
_register_random("_random_randint", _randint, {"low": 0, "high": 1},
                 dtype="int32")
_register_random("_random_negative_binomial", _neg_binomial_scalar,
                 {"k": 1, "p": 1.0})
_register_random("_random_generalized_negative_binomial",
                 _gen_neg_binomial_scalar, {"mu": 1.0, "alpha": 1.0})


# ---- tensor-parameter samplers (_sample_*) --------------------------------

def _expand(param, ndim):
    """``param`` with trailing unit dims up to ``ndim`` (it broadcasts
    over the draw block of each of its elements)."""
    return param.reshape(tuple(param.shape) + (1,) * (ndim - param.dim()))


def _sample_shapes(attrs, first, *rest):
    return [(tuple(first.shape) + _shape(attrs.get("shape", ())),
             _dtype(attrs))]


def _register_sample(name, body, arg_names, default_dtype="float32"):
    """A ``_sample_*`` op: ``body(shape, device, gen, *params)`` over
    the parameters expanded to the output's rank; float32 unless
    ``dtype`` says otherwise."""
    def fwd(attrs, *params, rng=None):
        shape = tuple(params[0].shape) + _shape(attrs.get("shape", ()))
        dt = _dtype(attrs)
        dev = params[0].device
        if dev.type == "meta":
            return torch.empty(shape, dtype=dt, device="meta")
        expanded = [_expand(p, len(shape)) for p in params]
        return body(shape, dev, _gen(dev, rng), *expanded).to(dt)
    register(name, fwd, arg_names=arg_names, needs_rng=True,
             defaults={"shape": (), "dtype": default_dtype},
             output_shapes=_sample_shapes)


def _sample_uniform(shape, dev, gen, low, high):
    u = torch.rand(shape, generator=gen, device=dev, dtype=low.dtype)
    return low + u * (high - low)


def _sample_normal(shape, dev, gen, mu, sigma):
    z = torch.randn(shape, generator=gen, device=dev, dtype=mu.dtype)
    return mu + z * sigma


def _sample_gamma(shape, dev, gen, alpha, beta):
    return _gamma(alpha.expand(shape), gen) * beta


_register_sample("_sample_uniform", _sample_uniform, ("low", "high"))
_register_sample("_sample_normal", _sample_normal, ("mu", "sigma"))
_register_sample("_sample_gamma", _sample_gamma, ("alpha", "beta"))


# The per-element samplers the JAX package keeps in mxnet_tpu/ops/extra.py
# (until extra.py is ported): float32 unless ``dtype`` says otherwise.

def _sample_exponential(shape, dev, gen, lam):
    e = torch.empty(shape, device=dev, dtype=torch.float32).exponential_(
        1.0, generator=gen)
    return e / lam


def _sample_poisson(shape, dev, gen, lam):
    return _poisson(lam.expand(shape), gen)


def _sample_neg_binomial(shape, dev, gen, k, p):
    lam = _gamma(k.expand(shape), gen) * (1 - p) / p
    return _poisson(lam, gen)


def _sample_gen_neg_binomial(shape, dev, gen, mu, alpha):
    shape_k = 1.0 / torch.clamp_min(alpha, 1e-12)
    lam = _gamma(shape_k.expand(shape), gen) * mu * alpha
    return _poisson(lam, gen)


_register_sample("_sample_exponential", _sample_exponential, ("lam",),
                 default_dtype=None)
_register_sample("_sample_poisson", _sample_poisson, ("lam",),
                 default_dtype=None)
_register_sample("_sample_negative_binomial", _sample_neg_binomial,
                 ("k", "p"), default_dtype=None)
_register_sample("_sample_generalized_negative_binomial",
                 _sample_gen_neg_binomial, ("mu", "alpha"),
                 default_dtype=None)


# ---- categorical draws and permutations -----------------------------------

def _multinomial_layout(attrs, data):
    shape = _shape(attrs.get("shape", ()))
    n = 1
    for s in shape:
        n *= s
    n = max(n, 1)
    out_shape = shape if data.dim() == 1 else \
        (data.shape[0],) + shape
    return shape, n, out_shape


def _multinomial_shapes(attrs, data):
    _, _, out_shape = _multinomial_layout(attrs, data)
    outs = [(out_shape, _dtype(attrs, "int32"))]
    if attrs.get("get_prob", False):
        outs.append((out_shape, torch.float32))
    return outs


def _sample_multinomial(attrs, data, rng=None):
    """``shape`` draws per row of ``data`` (probabilities, 1-D or 2-D),
    each class taken with probability proportional to its entry
    (clipped at 1e-20, as the JAX package's log-space draw clips); with
    ``get_prob`` also each draw's log-probability."""
    shape, n, out_shape = _multinomial_layout(attrs, data)
    dt = _dtype(attrs, "int32")
    w = torch.clamp_min(data.to(torch.float32), 1e-20)
    rows = w.reshape(-1, w.shape[-1])
    cdf = torch.cumsum(rows, dim=-1)
    u = torch.rand((rows.shape[0], n), generator=_gen(data.device, rng),
                   device=data.device) * cdf[:, -1:]
    idx = torch.clamp_max(torch.searchsorted(cdf, u, right=True),
                          rows.shape[-1] - 1)
    out = idx.reshape(out_shape).to(dt)
    if not attrs.get("get_prob", False):
        return out
    logp = torch.log_softmax(torch.log(rows), dim=-1)
    lp = torch.gather(logp, 1, idx).reshape(out_shape)
    return out, lp.to(torch.float32)


register("_sample_multinomial", _sample_multinomial, arg_names=("data",),
         needs_rng=True,
         defaults={"shape": (), "get_prob": False, "dtype": "int32"},
         num_outputs=lambda attrs: 2 if attrs.get("get_prob", False) else 1,
         output_shapes=_multinomial_shapes, aliases=("multinomial",))


def _shuffle(attrs, data, rng=None):
    """``data``'s rows (axis 0) in a random order: the argsort of one
    random 62-bit key a row."""
    if data.dim() == 0:
        return data.clone()
    keys = torch.randint(0, _KEY_HIGH, (data.shape[0],),
                         generator=_gen(data.device, rng),
                         device=data.device, dtype=torch.int64)
    return data[torch.argsort(keys)]


register("_shuffle", _shuffle, arg_names=("data",), needs_rng=True,
         output_shapes=lambda attrs, data: [(tuple(data.shape), data.dtype)],
         aliases=("shuffle",))
