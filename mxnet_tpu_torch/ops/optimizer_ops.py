"""Optimizer update operators (counterpart of
``mxnet_tpu/ops/optimizer_ops.py`` and the multi-tensor, group-AdaGrad
and multi-precision AdamW ops of ``mxnet_tpu/ops/extra.py``).

Each op returns the new weight followed by the new value of every
optimizer state it updates (the registry's ``mutable_inputs``), with
the JAX package's arithmetic in the JAX package's order. The arithmetic
lives in the ``*_rule`` functions, which take their per-step scalars
(``lr``, ``wd``, ``rescale``) either as Python floats (the registered
ops, the eager optimizer) or as 0-d tensors read from a device buffer
(the fused step, ``fused_step.py``, which replays one CUDA graph while
the learning rate and the loss scale change). Both forms compute the
same bits: a Python float meets a low-precision array rounded to that
array's dtype first (:func:`scalar_for`), as JAX's weak-typed Python
scalars do, and the rules never divide an array by a scalar (on the
card torch turns ``x / python_float`` into a multiply by the
reciprocal, which a 0-d tensor divisor does not).
"""
from __future__ import annotations

import torch

from .registry import register

__all__ = ["scalar_for", "stable_sqrt", "sgd_rule", "sgd_mom_rule", "mp_sgd_rule",
           "mp_sgd_mom_rule", "adam_rule", "adagrad_rule", "rmsprop_rule",
           "rmspropalex_rule"]

_LOW = (torch.float16, torch.bfloat16)


def stable_sqrt(x):
    """sqrt whose downstream division stays exact IEEE. The JAX package
    puts an optimization barrier here against XLA's div-of-sqrt fusion;
    torch runs the sqrt and the divide as separate exact kernels."""
    return torch.sqrt(x)


def scalar_for(value, like):
    """A Python scalar as an array of ``like``'s dtype sees it in JAX:
    rounded to that dtype when it is a low-precision float (a weak-typed
    scalar takes the array's dtype), unchanged otherwise. A tensor
    scalar (the fused step's) passes through."""
    if isinstance(value, torch.Tensor) or like.dtype not in _LOW:
        return value
    return float(torch.tensor(float(value), dtype=like.dtype))


def _clip(g, clip):
    return torch.clamp(g, -clip, clip) if clip is not None and clip > 0 \
        else g


def _prep(grad, rescale, clip):
    """sgd-family gradient: rescale, then clip the rescaled gradient."""
    return _clip(grad * rescale, clip)


def _prep_wd(grad, weight, rescale, wd, clip):
    """adam/rmsprop/ftml-family gradient: fold wd in FIRST, then clip
    the sum."""
    return _clip(grad * rescale + wd * weight, clip)


def _clip_weights(w, cw):
    return torch.clamp(w, -cw, cw) if cw is not None and cw > 0 else w


# ---------------------------------------------------------------------------
# the update rules (shared by the ops and the fused step)
# ---------------------------------------------------------------------------

def sgd_rule(weight, grad, lr, wd, rescale, clip=None):
    g = _prep(grad, rescale, clip)
    return weight - lr * (g + wd * weight)


def sgd_mom_rule(weight, grad, mom, lr, wd, rescale, momentum, clip=None):
    g = _prep(grad, rescale, clip)
    new_mom = momentum * mom - lr * (g + wd * weight)
    return weight + new_mom, new_mom


def mp_sgd_rule(weight, grad, weight32, lr, wd, rescale, clip=None):
    g = _prep(grad.to(torch.float32), rescale, clip)
    new_w32 = weight32 - lr * (g + wd * weight32)
    return new_w32.to(weight.dtype), new_w32


def mp_sgd_mom_rule(weight, grad, mom, weight32, lr, wd, rescale, momentum,
                    clip=None):
    g = _prep(grad.to(torch.float32), rescale, clip)
    new_mom = momentum * mom - lr * (g + wd * weight32)
    new_w32 = weight32 + new_mom
    return new_w32.to(weight.dtype), new_mom, new_w32


def nag_mom_rule(weight, grad, mom, lr, wd, rescale, momentum, clip=None):
    g = _prep(grad, rescale, clip)
    g = g + wd * weight
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


def adam_rule(weight, grad, mean, var, lr, wd, rescale, beta1, beta2,
              epsilon, clip=None):
    g = _prep_wd(grad, weight, rescale, wd, clip)
    new_mean = beta1 * mean + (1 - beta1) * g
    new_var = beta2 * var + (1 - beta2) * torch.square(g)
    new_w = weight - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    return new_w, new_mean, new_var


def rmsprop_rule(weight, grad, n, lr, wd, rescale, gamma1, epsilon,
                 clip=None, clip_weights=None):
    g = _prep_wd(grad, weight, rescale, wd, clip)
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    new_w = weight - lr * g / torch.sqrt(new_n + epsilon)
    return _clip_weights(new_w, clip_weights), new_n


def rmspropalex_rule(weight, grad, n, g_acc, delta, lr, wd, rescale, gamma1,
                     gamma2, epsilon, clip=None, clip_weights=None):
    g = _prep_wd(grad, weight, rescale, wd, clip)
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    new_g = gamma1 * g_acc + (1 - gamma1) * g
    new_delta = gamma2 * delta - lr * g / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    return (_clip_weights(weight + new_delta, clip_weights), new_n, new_g,
            new_delta)


def adagrad_rule(weight, grad, history, lr, wd, rescale, epsilon,
                 clip=None):
    g = _prep(grad, rescale, clip)
    new_h = history + torch.square(g)
    return weight - lr * (g / torch.sqrt(new_h + epsilon)
                          + wd * weight), new_h


# ---------------------------------------------------------------------------
# registered ops
# ---------------------------------------------------------------------------

_COMMON = {"lr": 0.01, "wd": 0.0, "rescale_grad": 1.0, "clip_gradient": -1.0,
           "lazy_update": True}


def _step_scalars(attrs, like):
    """``(lr, wd, rescale_grad)``, the per-step scalars the fused step
    feeds as 0-d tensors of the gradient's dtype, as ``like`` sees
    them. The static hyperparameters (:func:`_floats`) stay Python
    floats on both paths."""
    return [scalar_for(float(attrs[n]), like)
            for n in ("lr", "wd", "rescale_grad")]


def _floats(attrs, *names):
    return [float(attrs[n]) for n in names]


def _clip_attr(attrs):
    c = attrs.get("clip_gradient", -1.0)
    return None if c is None else float(c)


def _sgd_update(attrs, weight, grad):
    lr, wd, rs = _step_scalars(attrs, grad)
    return sgd_rule(weight, grad, lr, wd, rs, _clip_attr(attrs))


register("sgd_update", _sgd_update, arg_names=("weight", "grad"),
         defaults=dict(_COMMON))


def _sgd_mom_update(attrs, weight, grad, mom):
    lr, wd, rs = _step_scalars(attrs, grad)
    return sgd_mom_rule(weight, grad, mom, lr, wd, rs,
                        float(attrs["momentum"]), _clip_attr(attrs))


register("sgd_mom_update", _sgd_mom_update,
         arg_names=("weight", "grad", "mom"),
         defaults=dict(_COMMON, momentum=0.0), mutable_inputs=(2,))


def _mp_sgd_update(attrs, weight, grad, weight32):
    return mp_sgd_rule(weight, grad, weight32, float(attrs["lr"]),
                       float(attrs["wd"]), float(attrs["rescale_grad"]),
                       _clip_attr(attrs))


register("mp_sgd_update", _mp_sgd_update,
         arg_names=("weight", "grad", "weight32"),
         defaults=dict(_COMMON), mutable_inputs=(2,))


def _mp_sgd_mom_update(attrs, weight, grad, mom, weight32):
    return mp_sgd_mom_rule(weight, grad, mom, weight32, float(attrs["lr"]),
                           float(attrs["wd"]), float(attrs["rescale_grad"]),
                           float(attrs["momentum"]), _clip_attr(attrs))


register("mp_sgd_mom_update", _mp_sgd_mom_update,
         arg_names=("weight", "grad", "mom", "weight32"),
         defaults=dict(_COMMON, momentum=0.0), mutable_inputs=(2, 3))


def _nag_mom_update(attrs, weight, grad, mom):
    lr, wd, rs = _step_scalars(attrs, grad)
    return nag_mom_rule(weight, grad, mom, lr, wd, rs,
                        float(attrs["momentum"]), _clip_attr(attrs))


register("nag_mom_update", _nag_mom_update,
         arg_names=("weight", "grad", "mom"),
         defaults=dict(_COMMON, momentum=0.0), mutable_inputs=(2,))


def _adam_update(attrs, weight, grad, mean, var):
    lr, wd, rs = _step_scalars(attrs, grad)
    return adam_rule(weight, grad, mean, var, lr, wd, rs,
                     *_floats(attrs, "beta1", "beta2", "epsilon"),
                     clip=_clip_attr(attrs))


register("adam_update", _adam_update,
         arg_names=("weight", "grad", "mean", "var"),
         defaults=dict(_COMMON, beta1=0.9, beta2=0.999, epsilon=1e-8),
         mutable_inputs=(2, 3))


def _rmsprop_update(attrs, weight, grad, n):
    lr, wd, rs = _step_scalars(attrs, grad)
    return rmsprop_rule(weight, grad, n, lr, wd, rs,
                        *_floats(attrs, "gamma1", "epsilon"),
                        clip=_clip_attr(attrs),
                        clip_weights=float(attrs["clip_weights"]))


register("rmsprop_update", _rmsprop_update,
         arg_names=("weight", "grad", "n"),
         defaults=dict(_COMMON, gamma1=0.95, epsilon=1e-8,
                       clip_weights=-1.0),
         mutable_inputs=(2,))


def _rmspropalex_update(attrs, weight, grad, n, g_acc, delta):
    lr, wd, rs = _step_scalars(attrs, grad)
    return rmspropalex_rule(weight, grad, n, g_acc, delta, lr, wd, rs,
                            *_floats(attrs, "gamma1", "gamma2", "epsilon"),
                            clip=_clip_attr(attrs),
                            clip_weights=float(attrs["clip_weights"]))


register("rmspropalex_update", _rmspropalex_update,
         arg_names=("weight", "grad", "n", "g", "delta"),
         defaults=dict(_COMMON, gamma1=0.95, gamma2=0.9, epsilon=1e-8,
                       clip_weights=-1.0),
         mutable_inputs=(2, 3, 4))


def _ftrl_update(attrs, weight, grad, z, n):
    lr, wd, rs = _step_scalars(attrs, grad)
    lamda1, beta = _floats(attrs, "lamda1", "beta")
    g = _prep(grad, rs, _clip_attr(attrs))
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    new_w = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd))
    return new_w, new_z, new_n


register("ftrl_update", _ftrl_update, arg_names=("weight", "grad", "z", "n"),
         defaults=dict(_COMMON, lamda1=0.01, beta=1.0),
         mutable_inputs=(2, 3))


def _adagrad_update(attrs, weight, grad, history):
    lr, wd, rs = _step_scalars(attrs, grad)
    return adagrad_rule(weight, grad, history, lr, wd, rs,
                        float(attrs["epsilon"]), _clip_attr(attrs))


register("_sparse_adagrad_update", _adagrad_update,
         arg_names=("weight", "grad", "history"),
         defaults=dict(_COMMON, epsilon=1e-7), mutable_inputs=(2,),
         aliases=("adagrad_update",))


def _signsgd_update(attrs, weight, grad):
    lr, wd, rs = _step_scalars(attrs, grad)
    g = _prep(grad, rs, _clip_attr(attrs))
    return weight - lr * (torch.sign(g) + wd * weight)


register("signsgd_update", _signsgd_update, arg_names=("weight", "grad"),
         defaults=dict(_COMMON))


def _signum_update(attrs, weight, grad, mom):
    lr, wd, rs = _step_scalars(attrs, grad)
    mu, wd_lh = _floats(attrs, "momentum", "wd_lh")
    g = _prep(grad, rs, _clip_attr(attrs))
    new_mom = mu * mom - (1 - mu) * (g + wd * weight)
    new_w = (1 - lr * wd_lh) * weight + lr * torch.sign(new_mom)
    return new_w, new_mom


register("signum_update", _signum_update, arg_names=("weight", "grad", "mom"),
         defaults=dict(_COMMON, momentum=0.0, wd_lh=0.0), mutable_inputs=(2,))


def _ftml_update(attrs, weight, grad, d, v, z):
    lr, wd, rs = _step_scalars(attrs, grad)
    b1, b2, eps = _floats(attrs, "beta1", "beta2", "epsilon")
    t = int(attrs.get("t", 1))
    g = _prep_wd(grad, weight, rs, wd, _clip_attr(attrs))
    new_v = b2 * v + (1 - b2) * torch.square(g)
    d_t = (1 - b1 ** t) / lr * (torch.sqrt(new_v / (1 - b2 ** t)) + eps)
    sigma = d_t - b1 * d
    new_z = b1 * z + (1 - b1) * g - sigma * weight
    new_w = -new_z / d_t
    return new_w, d_t, new_v, new_z


register("ftml_update", _ftml_update,
         arg_names=("weight", "grad", "d", "v", "z"),
         defaults=dict(_COMMON, beta1=0.6, beta2=0.999, epsilon=1e-8, t=1),
         mutable_inputs=(2, 3, 4))


def _adamw_update(attrs, weight, grad, mean, var):
    lr, wd, rs = _step_scalars(attrs, grad)
    eta, b1, b2, eps = _floats(attrs, "eta", "beta1", "beta2", "epsilon")
    g = _prep(grad, rs, _clip_attr(attrs))
    new_mean = b1 * mean + (1 - b1) * g
    new_var = b2 * var + (1 - b2) * torch.square(g)
    new_w = weight - eta * (lr * new_mean / (torch.sqrt(new_var) + eps)
                            + wd * weight)
    return new_w, new_mean, new_var


register("_contrib_adamw_update", _adamw_update,
         arg_names=("weight", "grad", "mean", "var"),
         defaults=dict(_COMMON, beta1=0.9, beta2=0.999, epsilon=1e-8, eta=1.0),
         mutable_inputs=(2, 3))


def _mp_adamw_update(attrs, weight, grad, mean, var, weight32, rescale):
    """Multi-precision AdamW: the tensor ``rescale`` (the loss-scale
    reciprocal) scales the fp32 gradient, the fp32 master takes the
    update and the low-precision weight is its cast."""
    g32 = grad.to(torch.float32) * rescale.to(torch.float32)
    inner = {k: v for k, v in attrs.items() if v is not None}
    inner.setdefault("clip_gradient", -1.0)
    w32, new_mean, new_var = _adamw_update(dict(inner, rescale_grad=1.0),
                                           weight32, g32, mean, var)
    return w32.to(weight.dtype), new_mean, new_var, w32


register("_contrib_mp_adamw_update", _mp_adamw_update,
         arg_names=("weight", "grad", "mean", "var", "weight32",
                    "rescale_grad"),
         defaults={"lr": 0.001, "beta1": 0.9, "beta2": 0.999,
                   "epsilon": 1e-8, "wd": 0.0, "eta": 1.0,
                   "clip_gradient": None},
         num_outputs=1, mutable_inputs=(2, 3, 4))


def _group_adagrad_update(attrs, weight, grad, history):
    """Row-grouped AdaGrad: one accumulator per row, ``(rows,)``."""
    lr = float(attrs["lr"])
    eps = float(attrs.get("epsilon", 1e-5))
    g = _clip(grad.to(torch.float32) * float(attrs.get("rescale_grad", 1.0)),
              _clip_attr(attrs))
    grp = torch.mean(g * g, dim=tuple(range(1, g.dim())))
    h32 = history.to(torch.float32)
    hist_new = h32 + grp.reshape(h32.shape)
    bcast = hist_new.reshape((-1,) + (1,) * (g.dim() - 1))
    w_new = weight.to(torch.float32) - lr * g / (torch.sqrt(bcast) + eps)
    return w_new.to(weight.dtype), hist_new.to(history.dtype)


register("_contrib_group_adagrad_update", _group_adagrad_update,
         arg_names=("weight", "grad", "history"),
         defaults={"lr": 0.01, "epsilon": 1e-5, "rescale_grad": 1.0,
                   "clip_gradient": None},
         num_outputs=1, mutable_inputs=(2,))


def _multi_sgd(attrs, *inputs, with_mom=False, with_master=False):
    """Aggregated SGD over ``num_weights`` weights in one call, inputs
    ``(weight, grad[, mom][, weight32])`` per weight; the fp32
    accumulation of the JAX op, with the mp variants updating the
    master and casting it back."""
    n = int(attrs["num_weights"])
    lrs = [float(x) for x in attrs["lrs"]]
    wds = [float(x) for x in attrs["wds"]]
    rescale = float(attrs.get("rescale_grad", 1.0))
    clip = attrs.get("clip_gradient", None)
    momentum = float(attrs.get("momentum", 0.0))
    per = 2 + int(with_mom) + int(with_master)
    outs = []
    for i in range(n):
        chunk = list(inputs[i * per:(i + 1) * per])
        w, g = chunk[0], chunk[1]
        mom = chunk[2] if with_mom else None
        master = chunk[-1] if with_master else None
        acc = (master if master is not None else w).to(torch.float32)
        g = _clip(g.to(torch.float32) * rescale,
                  None if clip is None else float(clip))
        g = g + wds[i] * acc
        row = []
        if mom is not None:
            mom_new = momentum * mom.to(torch.float32) - lrs[i] * g
            acc_new = acc + mom_new
            row.append(mom_new.to(mom.dtype))
        else:
            acc_new = acc - lrs[i] * g
        outs.append((acc_new.to(w.dtype), *row)
                    + ((acc_new,) if master is not None else ()))
    return tuple(x for pack in outs for x in pack)


_MULTI = {"num_weights": 1, "lrs": (), "wds": (), "rescale_grad": 1.0,
          "clip_gradient": None}
register("multi_sgd_update", lambda attrs, *ins: _multi_sgd(attrs, *ins),
         arg_names=("data",), defaults=dict(_MULTI),
         key_var_num_args="__num_args__",
         num_outputs=lambda a: int(a["num_weights"]))
register("multi_sgd_mom_update",
         lambda attrs, *ins: _multi_sgd(attrs, *ins, with_mom=True),
         arg_names=("data",), defaults=dict(_MULTI, momentum=0.0),
         key_var_num_args="__num_args__",
         num_outputs=lambda a: 2 * int(a["num_weights"]))
register("multi_mp_sgd_update",
         lambda attrs, *ins: _multi_sgd(attrs, *ins, with_master=True),
         arg_names=("data",), defaults=dict(_MULTI),
         key_var_num_args="__num_args__",
         num_outputs=lambda a: 2 * int(a["num_weights"]))
register("multi_mp_sgd_mom_update",
         lambda attrs, *ins: _multi_sgd(attrs, *ins, with_mom=True,
                                        with_master=True),
         arg_names=("data",), defaults=dict(_MULTI, momentum=0.0),
         key_var_num_args="__num_args__",
         num_outputs=lambda a: 3 * int(a["num_weights"]))
