"""Neural-network operators (counterpart of ``mxnet_tpu/ops/nn.py``):
``FullyConnected``, ``Convolution``, ``Deconvolution``, ``Activation``,
``BatchNorm``, ``LayerNorm``, ``Pooling``, ``Dropout``, ``softmax``,
``log_softmax`` and the loss layer ``SoftmaxOutput``. Matrix products
and (transposed) convolutions go to cuBLAS and cuDNN through torch, as
the JAX package leaves them to XLA (``jnp.dot``,
``lax.conv_general_dilated``); there is no hand kernel among them.

Train/eval behaviour (BatchNorm, Dropout) follows the ``__train__``
attribute, which ``invoke_nd`` and ``CachedOp`` set from the autograd
train mode.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register

_D = ("data",)


def _is_train(attrs):
    return bool(attrs.get("__train__", False))


def _tup(v, nd, default=1):
    """An int or a short tuple as ``nd`` ints, padded with ``default``."""
    if v is None or v == ():
        return (default,) * nd
    if isinstance(v, int):
        return (v,) * nd
    t = tuple(int(x) for x in v)
    return t if len(t) == nd else t + (default,) * (nd - len(t))


def _fully_connected(attrs, data, weight, bias=None):
    x = data.reshape(data.shape[0], -1) if attrs.get("flatten", True) \
        else data
    if attrs.get("no_bias", False):
        bias = None
    return F.linear(x, weight, bias)


def _bias_args(names):
    def fn(attrs):
        return names[:-1] if attrs.get("no_bias", False) else names
    return fn


register("FullyConnected", _fully_connected,
         arg_names=("data", "weight", "bias"),
         defaults={"num_hidden": 0, "no_bias": False, "flatten": True},
         arg_names_fn=_bias_args(["data", "weight", "bias"]),
         attr_docs={"num_hidden": "output feature count",
                    "no_bias": "skip the bias term",
                    "flatten": "collapse trailing input dims first"},
         attr_ranges={"num_hidden": (0, None)})

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _convolution(attrs, data, weight, bias=None):
    """Cross-correlation over 1-3 spatial dims (NCW/NCHW/NCDHW), weight
    ``(num_filter, C/num_group, *kernel)``, symmetric zero padding;
    cuDNN on the card."""
    nd = len(tuple(attrs["kernel"]))
    if attrs.get("no_bias", False):
        bias = None
    return _CONV[nd](data, weight, bias,
                     stride=_tup(attrs.get("stride"), nd, 1),
                     padding=_tup(attrs.get("pad"), nd, 0),
                     dilation=_tup(attrs.get("dilate"), nd, 1),
                     groups=int(attrs.get("num_group", 1)))


register("Convolution", _convolution, arg_names=("data", "weight", "bias"),
         defaults={"kernel": (), "stride": (), "dilate": (), "pad": (),
                   "num_filter": 0, "num_group": 1, "workspace": 1024,
                   "no_bias": False, "cudnn_tune": None, "cudnn_off": False,
                   "layout": None},
         arg_names_fn=_bias_args(["data", "weight", "bias"]),
         attr_docs={"kernel": "spatial window, e.g. (3, 3)",
                    "stride": "window step per spatial dim",
                    "dilate": "kernel dilation per spatial dim",
                    "pad": "zero padding per spatial dim",
                    "num_filter": "output channels",
                    "num_group": "grouped-convolution groups"},
         attr_ranges={"num_filter": (0, None), "num_group": (1, None)})

_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _deconvolution(attrs, data, weight, bias=None):
    """The transpose of ``Convolution`` (the gradient of a convolution
    with respect to its input), weight ``(C_in, num_filter/num_group,
    *kernel)``, which is torch's own layout; output size per spatial
    dim ``(n-1)*stride - 2*pad + dilate*(k-1) + adj + 1``, the JAX
    package's lhs-dilated formulation. ``adj`` becomes torch's
    ``output_padding``, which must stay below the stride or the
    dilation; ``target_shape`` is ignored, as in the JAX package."""
    nd = len(tuple(attrs["kernel"]))
    if attrs.get("no_bias", True):
        bias = None
    return _CONV_T[nd](data, weight, bias,
                       stride=_tup(attrs.get("stride"), nd, 1),
                       padding=_tup(attrs.get("pad"), nd, 0),
                       output_padding=_tup(attrs.get("adj"), nd, 0),
                       groups=int(attrs.get("num_group", 1)),
                       dilation=_tup(attrs.get("dilate"), nd, 1))


register("Deconvolution", _deconvolution,
         arg_names=("data", "weight", "bias"),
         defaults={"kernel": (), "stride": (), "dilate": (), "pad": (),
                   "adj": (), "target_shape": (), "num_filter": 0,
                   "num_group": 1, "workspace": 512, "no_bias": True,
                   "cudnn_tune": None, "cudnn_off": False, "layout": None},
         arg_names_fn=_bias_args(["data", "weight", "bias"]))

_ACT = {"relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
        "softrelu": F.softplus, "softsign": F.softsign}


def _activation(attrs, x):
    act = attrs.get("act_type", "relu")
    if act not in _ACT:
        raise ValueError("Activation: unknown act_type %r" % act)
    return _ACT[act](x)


register("Activation", _activation, arg_names=_D,
         defaults={"act_type": "relu"},
         attr_docs={"act_type": "one of relu/sigmoid/tanh/softrelu/"
                                "softsign"})


def _batch_norm_outputs(attrs):
    return 3 if attrs.get("output_mean_var", False) else 1


def _bn_affine(data, g, beta, mean, inv, bshape):
    """``out = data * a + b`` with the per-channel ``a = inv * g`` and
    ``b = beta - mean * inv * g`` formed in fp32, then cast to the
    data's dtype: the JAX package's per-channel FMA, one pass over the
    data (``addcmul``)."""
    g32 = g.to(torch.float32)
    a = (inv * g32).to(data.dtype)
    b = (beta.to(torch.float32) - mean * inv * g32).to(data.dtype)
    return torch.addcmul(b.reshape(bshape), data, a.reshape(bshape))


class _BNTrain(torch.autograd.Function):
    """Training-mode BatchNorm with the JAX package's hand-written VJP
    (``_bn_train_core``). Forward: one-pass moments in fp32, shifted by
    the moving mean ``c`` (no cancellation on large-mean channels), then
    the per-channel FMA. Backward: the fused gradient
    ``dx = (g*inv) * (dy - mean(dy) - xhat * mean(dy*xhat))``, saving
    only the input and the per-channel mean and inverse deviation. The
    batch mean and variance are outputs without gradient."""

    @staticmethod
    def forward(ctx, data, g, beta, c, red, bshape, eps):
        xc = data.to(torch.float32) - c
        mean_c = xc.mean(dim=red)
        meansq_c = xc.square().mean(dim=red)
        var = torch.clamp_min(meansq_c - mean_c.square(), 0.0)
        mean = mean_c + c.reshape(mean_c.shape)
        inv = torch.rsqrt(var + eps)
        out = _bn_affine(data, g, beta, mean, inv, bshape)
        ctx.save_for_backward(data, g, mean, inv)
        ctx.red, ctx.bshape = red, bshape
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        data, g, mean, inv = ctx.saved_tensors
        red, bshape = ctx.red, ctx.bshape
        m = math.prod(data.shape[i] for i in red)
        a = (inv * g.to(torch.float32)).to(data.dtype)
        nmean = (-mean * inv).to(data.dtype)
        xhat = data * inv.reshape(bshape).to(data.dtype) \
            + nmean.reshape(bshape)
        sum_dy = dy.sum(dim=red, dtype=torch.float32)
        sum_dy_xhat = (dy * xhat).sum(dim=red, dtype=torch.float32)
        c1 = (sum_dy / m).to(data.dtype).reshape(bshape)
        c2 = (sum_dy_xhat / m).to(data.dtype).reshape(bshape)
        dx = a.reshape(bshape) * (dy - c1 - xhat * c2)
        return (dx, sum_dy_xhat.to(g.dtype), sum_dy.to(g.dtype), None,
                None, None, None)


def _batch_norm(attrs, data, gamma, beta, moving_mean, moving_var):
    """Normalize over every axis but ``axis``: by the batch moments in
    training (unless ``use_global_stats``), by the moving statistics in
    eval. Returns the outputs, then the new moving mean and variance
    ``momentum * old + (1 - momentum) * batch`` (fp32; unchanged in
    eval), which the caller writes back. Not ``F.batch_norm``: torch
    updates with the unbiased variance and weighs the new batch by
    ``momentum``."""
    eps = float(attrs.get("eps", 1e-3))
    momentum = float(attrs.get("momentum", 0.9))
    axis = int(attrs.get("axis", 1)) % data.ndim
    train = _is_train(attrs) and not attrs.get("use_global_stats", False)
    red = tuple(i for i in range(data.ndim) if i != axis)
    bshape = tuple(data.shape[axis] if i == axis else 1
                   for i in range(data.ndim))
    g = torch.ones_like(gamma) if attrs.get("fix_gamma", True) else gamma
    if train:
        c = moving_mean.detach().to(torch.float32, copy=True).reshape(bshape)
        out, mean, var = _BNTrain.apply(data, g, beta, c, red, bshape, eps)
        new_mean = (momentum * moving_mean.detach().to(torch.float32)
                    + (1 - momentum) * mean).to(moving_mean.dtype)
        new_var = (momentum * moving_var.detach().to(torch.float32)
                   + (1 - momentum) * var).to(moving_var.dtype)
    else:
        mean = moving_mean.to(torch.float32)
        var = moving_var.to(torch.float32)
        new_mean, new_var = moving_mean, moving_var
        out = _bn_affine(data, g, beta, mean, torch.rsqrt(var + eps), bshape)
    mean = mean.detach().to(gamma.dtype)
    var = var.detach().to(gamma.dtype)
    outs = (out, mean, var) if attrs.get("output_mean_var", False) \
        else (out,)
    return outs + (new_mean, new_var)


register("BatchNorm", _batch_norm,
         arg_names=("data", "gamma", "beta", "moving_mean", "moving_var"),
         defaults={"eps": 1e-3, "momentum": 0.9, "fix_gamma": True,
                   "use_global_stats": False, "output_mean_var": False,
                   "axis": 1, "cudnn_off": False, "__train__": False},
         num_outputs=_batch_norm_outputs, mutable_inputs=(3, 4),
         attr_docs={"eps": "added to variance for numeric stability",
                    "momentum": "running-stat decay factor",
                    "fix_gamma": "freeze gamma at 1",
                    "use_global_stats": "normalize with running stats "
                                        "even in training",
                    "axis": "channel axis"},
         attr_ranges={"momentum": (0.0, 1.0), "eps": (0.0, None)})


def _layer_norm(attrs, data, gamma, beta):
    axis = int(attrs.get("axis", -1)) % data.ndim
    eps = float(attrs.get("eps", 1e-5))
    if not attrs.get("output_mean_var", False) and axis == data.ndim - 1:
        return F.layer_norm(data, (data.shape[-1],), gamma, beta, eps)
    mean = torch.mean(data, dim=axis, keepdim=True)
    var = torch.var(data, dim=axis, keepdim=True, unbiased=False)
    bshape = tuple(data.shape[axis] if i == axis else 1
                   for i in range(data.ndim))
    out = (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(bshape) \
        + beta.reshape(bshape)
    if attrs.get("output_mean_var", False):
        return out, mean.squeeze(axis), var.squeeze(axis)
    return out


register("LayerNorm", _layer_norm, arg_names=("data", "gamma", "beta"),
         defaults={"axis": -1, "eps": 1e-5, "output_mean_var": False},
         num_outputs=lambda a: 3 if a.get("output_mean_var", False) else 1)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


def _sum_pool(x, kernel, stride):
    """Window sums with no padding (``avg_pool`` with divisor 1; a 1-D
    pool runs as a 2-D one over a unit dim)."""
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(-2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(-2)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


def _pooling(attrs, data):
    """max / avg / sum / lp pooling over 1-3 spatial dims. The padding
    is explicit (-inf for max, 0 otherwise) and the pool runs with none,
    so MXNet's ``pooling_convention="full"`` (extra high-side padding up
    to a ceil'd output size) and ``count_include_pad=False`` (divide by
    the count of real elements in each window) hold exactly."""
    nd = data.ndim - 2
    kernel = tuple(attrs.get("kernel", ()))
    pool_type = attrs.get("pool_type", "max")
    global_pool = bool(attrs.get("global_pool", False))
    if global_pool or not kernel:
        kernel, stride, pad = tuple(data.shape[2:]), (1,) * nd, (0,) * nd
    else:
        kernel = _tup(kernel, nd, 1)
        stride = _tup(attrs.get("stride"), nd, 1)
        pad = _tup(attrs.get("pad"), nd, 0)
    full = attrs.get("pooling_convention", "valid") == "full" \
        and not global_pool
    flat = []                        # F.pad order: last dim first
    for i in reversed(range(nd)):
        hi = pad[i]
        if full:
            inp = data.shape[2 + i]
            out = -(-(inp + 2 * pad[i] - kernel[i]) // stride[i]) + 1
            hi += max((out - 1) * stride[i] + kernel[i]
                      - (inp + 2 * pad[i]), 0)
        flat += [pad[i], hi]
    padded = any(flat)

    if pool_type == "max":
        fill = -math.inf if data.is_floating_point() \
            else torch.iinfo(data.dtype).min
        x = F.pad(data, flat, value=fill) if padded else data
        return _MAX_POOL[nd](x, kernel, stride)
    if pool_type in ("avg", "sum"):
        s = _sum_pool(F.pad(data, flat) if padded else data, kernel, stride)
        if pool_type == "sum":
            return s
        if attrs.get("count_include_pad", True) or not padded:
            return s / float(math.prod(kernel))
        ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                          device=data.device)
        return s / _sum_pool(F.pad(ones, flat), kernel, stride)
    if pool_type == "lp":
        p = float(attrs.get("p_value", 2))
        x = torch.abs(data) ** p
        s = _sum_pool(F.pad(x, flat) if padded else x, kernel, stride)
        return s ** (1.0 / p)
    raise ValueError("Pooling: unknown pool_type %r" % pool_type)


register("Pooling", _pooling, arg_names=_D,
         defaults={"kernel": (), "pool_type": "max", "global_pool": False,
                   "stride": (), "pad": (), "pooling_convention": "valid",
                   "count_include_pad": True, "p_value": 2,
                   "cudnn_off": False})


def _dropout_draws(attrs, is_train):
    return float(attrs.get("p", 0.5)) != 0.0 and (
        is_train or attrs.get("mode", "training") == "always")


def _dropout(attrs, data, rng=None):
    """``data * mask / (1 - p)`` with a Bernoulli(1 - p) ``mask`` drawn
    from ``rng`` (the caller's ``torch.Generator``; the device's
    generator of :mod:`~mxnet_tpu_torch.random` when none is given), of
    the data's shape with each dim in ``axes`` set to 1 (one mask
    broadcast along them). It draws only in training or with
    ``mode="always"``; otherwise it returns ``data`` itself and draws
    nothing, so a predict-mode graph holding it stays replayable. On
    ``meta`` tensors (shape inference) the mask is shape only."""
    if not _dropout_draws(attrs, _is_train(attrs)):
        return data
    keep = 1.0 - float(attrs.get("p", 0.5))
    shape = list(data.shape)
    for a in tuple(attrs.get("axes", ()) or ()):
        shape[a] = 1
    if data.device.type == "meta":
        mask = torch.empty(shape, dtype=data.dtype, device="meta")
    else:
        if rng is None:
            from .. import random as _random
            rng = _random.generator(data.device)
        mask = (torch.rand(shape, generator=rng, device=data.device)
                < keep).to(data.dtype)
    return data * mask / keep


register("Dropout", _dropout, arg_names=_D, needs_rng=True,
         draws=_dropout_draws,
         defaults={"p": 0.5, "mode": "training", "axes": (),
                   "cudnn_off": False, "__train__": False},
         attr_docs={"p": "fraction of inputs zeroed during training",
                    "axes": "axes sharing one dropout mask "
                            "(broadcast dropout)",
                    "mode": "'training' (only when training) or "
                            "'always'"},
         attr_ranges={"p": (0.0, 1.0)})


def _tempered(attrs, x):
    temp = attrs.get("temperature", None)
    return x / float(temp) if temp else x


register("softmax",
         lambda attrs, x: torch.softmax(_tempered(attrs, x),
                                        int(attrs.get("axis", -1))),
         arg_names=_D, defaults={"axis": -1, "temperature": None,
                                 "dtype": None})
register("log_softmax",
         lambda attrs, x: torch.log_softmax(_tempered(attrs, x),
                                            int(attrs.get("axis", -1))),
         arg_names=_D, defaults={"axis": -1, "temperature": None,
                                 "dtype": None})


def _so_softmax(data, cfg):
    """SoftmaxOutput's forward: softmax over axis 1 (``multi_output``),
    the last axis (``preserve_shape``) or the flattened trailing axes."""
    if cfg["multi_output"]:
        return torch.softmax(data, 1)
    if cfg["preserve_shape"]:
        return torch.softmax(data, -1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         -1).reshape(data.shape)


class _SoftmaxOutput(torch.autograd.Function):
    """A loss layer: the forward is the softmax, the backward the JAX
    package's custom VJP (``p - onehot``, softmax_output-inl.h), which
    ignores the head gradient unless ``out_grad`` and gives the label a
    zero gradient."""

    @staticmethod
    def forward(ctx, data, label, cfg):
        p = _so_softmax(data, cfg)
        ctx.save_for_backward(p, label)
        ctx.cfg = cfg
        return p

    @staticmethod
    def backward(ctx, g):
        p, label = ctx.saved_tensors
        cfg = ctx.cfg
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        if tuple(label.shape) == tuple(p.shape):
            # probability labels: (p - label) * grad_scale, no
            # normalization
            grad = (p - label) * cfg["grad_scale"]
            return (grad * g if cfg["out_grad"] else grad), dlabel, None
        axis = 1 if cfg["multi_output"] else p.dim() - 1
        nclass = p.shape[axis]
        li = label.to(torch.int32).unsqueeze(axis)
        classes = torch.arange(nclass, device=p.device, dtype=torch.int32)
        onehot = (li == classes.reshape([nclass if i == axis else 1
                                         for i in range(p.dim())])
                  ).to(p.dtype)
        alpha = cfg["smooth_alpha"]
        if alpha > 0:
            onehot = onehot * (1 - alpha) + alpha / (nclass - 1) \
                * (1 - onehot)
        grad = p - onehot
        valid = None
        if cfg["use_ignore"]:
            valid = (label != cfg["ignore_label"]).to(p.dtype)
            grad = grad * valid.unsqueeze(axis)
        spatial = math.prod(p.shape[2:]) if cfg["multi_output"] else 1
        norm = cfg["normalization"]
        if norm == "batch":
            grad = grad / (p.shape[0] * spatial)
        elif norm == "valid":
            n_valid = valid.sum() if valid is not None \
                else torch.tensor(float(label.numel()), device=p.device)
            grad = grad / torch.clamp_min(n_valid, 1.0)
        elif spatial != 1:
            grad = grad / spatial
        grad = grad * cfg["grad_scale"]
        if cfg["out_grad"]:
            grad = grad * g
        return grad, dlabel, None


def _softmax_output(attrs, data, label):
    """Softmax forward with the cross-entropy gradient of a loss layer
    (reference: softmax_output-inl.h). ``normalization`` ``null``
    leaves the gradient summed over the batch (``Module`` rescales by
    1/batch in the optimizer), ``batch`` divides by the batch (times
    the spatial size under ``multi_output``), ``valid`` by the count of
    labels not ignored."""
    cfg = {"grad_scale": float(attrs.get("grad_scale", 1.0)),
           "ignore_label": float(attrs.get("ignore_label", -1.0)),
           "use_ignore": bool(attrs.get("use_ignore", False)),
           "multi_output": bool(attrs.get("multi_output", False)),
           "preserve_shape": bool(attrs.get("preserve_shape", False)),
           "normalization": attrs.get("normalization", "null"),
           "smooth_alpha": float(attrs.get("smooth_alpha", 0.0)),
           "out_grad": bool(attrs.get("out_grad", False))}
    return _SoftmaxOutput.apply(data, label, cfg)


register("SoftmaxOutput", _softmax_output, arg_names=("data", "label"),
         defaults={"grad_scale": 1.0, "ignore_label": -1.0,
                   "multi_output": False, "use_ignore": False,
                   "preserve_shape": False, "normalization": "null",
                   "out_grad": False, "smooth_alpha": 0.0},
         output_shapes=lambda attrs, data, label: [(tuple(data.shape),
                                                    data.dtype)],
         aliases=("Softmax",))
