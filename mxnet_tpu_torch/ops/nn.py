"""Neural-network operators (counterpart of ``mxnet_tpu/ops/nn.py``):
``FullyConnected``, ``Convolution``, ``Deconvolution``, ``Activation``,
``LeakyReLU``, ``BatchNorm``, ``LayerNorm``, ``InstanceNorm``, ``Pooling``, ``Dropout``, ``softmax``,
``log_softmax``, ``softmin``, ``SoftmaxActivation``, the loss layers
``SoftmaxOutput`` and the regression outputs, ``softmax_cross_entropy``,
``L2Normalization``, ``LRN``, ``UpSampling``, ``_contrib_div_sqrt_dim``,
``ctc_loss``, the sequence ops (``SequenceMask``, ``SequenceLast``,
``SequenceReverse``) and the ``_v1`` names of BatchNorm, Convolution and
Pooling. Matrix products
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

from ..base import MXNetError
from .registry import get_op, register

_D = ("data",)
_LOW = (torch.bfloat16, torch.float16)


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
    """``x W^T + b`` with the JAX package's dtype rule (``jnp.dot``):
    the product runs in ``torch.promote_types`` of data and weight, and
    a bias of another dtype promotes the sum again (a float32 input
    meeting a bfloat16 weight computes in float32)."""
    x = data.reshape(data.shape[0], -1) if attrs.get("flatten", True) \
        else data
    if attrs.get("no_bias", False):
        bias = None
    dt = torch.promote_types(x.dtype, weight.dtype)
    x, weight = x.to(dt), weight.to(dt)
    if bias is None or (bias.dtype == dt == torch.float32):
        return F.linear(x, weight, bias)
    # low precision: the product rounds before the bias is added, as
    # JAX's dot-then-add does (a fused bias would round once)
    return F.linear(x, weight) + bias


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
    weight = _same_dtype("Convolution", data, weight)
    out = _CONV[nd](data, weight,
                    bias if bias is None or bias.dtype == data.dtype
                    else None,
                    stride=_tup(attrs.get("stride"), nd, 1),
                    padding=_tup(attrs.get("pad"), nd, 0),
                    dilation=_tup(attrs.get("dilate"), nd, 1),
                    groups=int(attrs.get("num_group", 1)))
    return _add_bias(out, bias, nd)


def _same_dtype(name, data, weight):
    """``lax.conv_general_dilated`` takes one dtype: mixed data and
    weight raise, as in the JAX package. Shape inference (``meta``
    tensors, whose variables carry no dtype yet) returns the weight in
    the data's dtype instead."""
    if data.dtype == weight.dtype:
        return weight
    if data.device.type == "meta":
        return weight.to(data.dtype)
    raise TypeError("%s requires data and weight of one dtype, got "
                    "%s and %s" % (name, data.dtype, weight.dtype))


def _add_bias(out, bias, nd):
    """A bias of another dtype than the product, added after it with
    promotion (the JAX package's ``out + bias``)."""
    if bias is None or bias.dtype == out.dtype:
        return out
    return out + bias.reshape((1, -1) + (1,) * nd)


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
    weight = _same_dtype("Deconvolution", data, weight)
    out = _CONV_T[nd](data, weight,
                      bias if bias is None or bias.dtype == data.dtype
                      else None,
                      stride=_tup(attrs.get("stride"), nd, 1),
                      padding=_tup(attrs.get("pad"), nd, 0),
                      output_padding=_tup(attrs.get("adj"), nd, 0),
                      groups=int(attrs.get("num_group", 1)),
                      dilation=_tup(attrs.get("dilate"), nd, 1))
    return _add_bias(out, bias, nd)


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


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


def _leaky_relu_outputs(attrs):
    return 2 if attrs.get("act_type", "leaky") == "rrelu" else 1


def _leaky_relu_draws(attrs, is_train):
    return attrs.get("act_type", "leaky") == "rrelu" and is_train


def _leaky_relu(attrs, data, gamma=None, rng=None):
    """The LeakyReLU family by ``act_type``: ``leaky`` (``slope * x``
    below 0), ``elu`` (``slope * expm1(x)``), ``prelu`` (a learned
    ``gamma``, one slope a channel of axis 1), ``selu`` (the JAX
    package's constants), exact-erf ``gelu`` and ``rrelu``. ``rrelu``
    returns the slopes too: uniform draws in [lower_bound, upper_bound)
    in training, their mean in predict mode, where it draws nothing
    (``draws``), so a predict graph holding it stays replayable."""
    t = attrs.get("act_type", "leaky")
    slope = float(attrs.get("slope", 0.25))
    if t == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if t == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if t == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 and data.dim() > 1 else gamma
        return torch.where(data >= 0, data, g * data)
    if t == "selu":
        return _SELU_SCALE * torch.where(data >= 0, data,
                                         _SELU_ALPHA * torch.expm1(data))
    if t == "gelu":
        return F.gelu(data, approximate="none")
    if t == "rrelu":
        lo = float(attrs.get("lower_bound", 0.125))
        hi = float(attrs.get("upper_bound", 0.334))
        if not _leaky_relu_draws(attrs, _is_train(attrs)):
            mask = torch.full_like(data, (lo + hi) / 2.0)
        elif data.device.type == "meta":
            mask = torch.empty_like(data)
        else:
            if rng is None:
                from .. import random as _random
                rng = _random.generator(data.device)
            mask = torch.empty_like(data).uniform_(lo, hi, generator=rng)
        return torch.where(data >= 0, data, mask * data), mask
    raise ValueError("LeakyReLU: unknown act_type %r" % t)


register("LeakyReLU", _leaky_relu, arg_names=("data", "gamma"),
         needs_rng=True, draws=_leaky_relu_draws,
         defaults={"act_type": "leaky", "slope": 0.25, "lower_bound": 0.125,
                   "upper_bound": 0.334, "__train__": False},
         num_outputs=_leaky_relu_outputs,
         arg_names_fn=lambda attrs: ["data", "gamma"]
         if attrs.get("act_type") == "prelu" else ["data"],
         attr_docs={"act_type": "one of leaky/elu/prelu/selu/gelu/rrelu",
                    "slope": "the negative slope (leaky) or alpha (elu)"})


def _batch_norm_outputs(attrs):
    return 3 if attrs.get("output_mean_var", False) else 1


def _cast(x, dtype):
    """``x.to(dtype)``, skipped where ``x`` has it already: an eager call
    returns ``x`` either way, but ``torch.export`` records every ``to``
    as two nodes, which a predict program's export pays for."""
    return x if x.dtype == dtype else x.to(dtype)


def _bn_affine(data, g, beta, mean, inv, bshape):
    """``out = data * a + b`` with the per-channel ``a = inv * g`` and
    ``b = beta - mean * inv * g`` formed in fp32, then cast to the
    data's dtype: the JAX package's per-channel FMA, one pass over the
    data (``addcmul``)."""
    g32 = _cast(g, torch.float32)
    a = _cast(inv * g32, data.dtype)
    b = _cast(_cast(beta, torch.float32) - mean * inv * g32, data.dtype)
    if data.dtype in _LOW:
        # the product rounds to the data's dtype before the add, as
        # JAX's two bfloat16 ops do
        return data * a.reshape(bshape) + b.reshape(bshape)
    return torch.addcmul(b.reshape(bshape), data, a.reshape(bshape))


class _BNTrain(torch.autograd.Function):
    """Training-mode BatchNorm with the JAX package's hand-written VJP
    (``_bn_train_core``). Forward: one-pass moments in fp32, shifted by
    the moving mean ``c`` (no cancellation on large-mean channels), then
    the per-channel FMA. Backward: the fused gradient
    ``dx = (g*inv) * (dy - mean(dy) - xhat * mean(dy*xhat))``, saving
    only the input and the per-channel mean and inverse deviation. The
    batch mean and variance are outputs without gradient.

    ``sync`` (a ``(mesh, axis)`` pair) takes the moments over the GLOBAL
    batch of the ranks along ``axis``: the per-channel sums, sums of
    squares and row counts are all-reduced in the forward, and the two
    per-channel sums of the backward likewise. The gamma and beta
    gradients stay this rank's own sums, which the trainer's gradient
    exchange adds up."""

    @staticmethod
    def forward(ctx, data, g, beta, c, red, bshape, eps, sync=None):
        xc = data.to(torch.float32) - c
        count = math.prod(data.shape[i] for i in red)
        if sync is None:
            mean_c = xc.mean(dim=red)
            meansq_c = xc.square().mean(dim=red)
        else:
            from ..parallel.collectives import all_reduce
            mesh, axis = sync
            sums = torch.cat([xc.sum(dim=red), xc.square().sum(dim=red),
                              xc.new_full((1,), float(count))])
            sums = all_reduce(sums, mesh, axis)
            n_ch = (sums.numel() - 1) // 2
            count = sums[-1]
            mean_c = sums[:n_ch] / count
            meansq_c = sums[n_ch:2 * n_ch] / count
        var = torch.clamp_min(meansq_c - mean_c.square(), 0.0)
        mean = mean_c + c.reshape(mean_c.shape)
        inv = torch.rsqrt(var + eps)
        out = _bn_affine(data, g, beta, mean, inv, bshape)
        ctx.save_for_backward(data, g, mean, inv)
        ctx.red, ctx.bshape, ctx.sync, ctx.count = red, bshape, sync, count
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        data, g, mean, inv = ctx.saved_tensors
        red, bshape = ctx.red, ctx.bshape
        a = (inv * g.to(torch.float32)).to(data.dtype)
        nmean = (-mean * inv).to(data.dtype)
        xhat = data * inv.reshape(bshape).to(data.dtype) \
            + nmean.reshape(bshape)
        sum_dy = dy.sum(dim=red, dtype=torch.float32)
        sum_dy_xhat = (dy * xhat).sum(dim=red, dtype=torch.float32)
        tot_dy, tot_dy_xhat = sum_dy, sum_dy_xhat
        if ctx.sync is not None:
            from ..parallel.collectives import all_reduce
            both = all_reduce(torch.cat([sum_dy, sum_dy_xhat]), *ctx.sync)
            tot_dy, tot_dy_xhat = both.chunk(2)
        m = ctx.count
        c1 = (tot_dy / m).to(data.dtype).reshape(bshape)
        c2 = (tot_dy_xhat / m).to(data.dtype).reshape(bshape)
        dx = a.reshape(bshape) * (dy - c1 - xhat * c2)
        return (dx, sum_dy_xhat.to(g.dtype), sum_dy.to(g.dtype), None,
                None, None, None, None)


class _BNTrainMesh(torch.autograd.Function):
    """:class:`_BNTrain` over the shards of the in-process mesh: each
    shard's per-channel sums and sums of squares, taken on its device,
    are added on the master's device into the GLOBAL batch's moments,
    which go back to every shard for its affine; the backward's two
    per-channel sums are added the same way. The outputs are the
    shards' results, then the batch mean and variance (on the master's
    device); the gamma and beta gradients are the whole batch's."""

    @staticmethod
    def forward(ctx, g, beta, c, red, bshape, eps, *shards):
        from ..parallel.collectives import device_sum
        dev0 = g.device
        count = sum(math.prod(x.shape[i] for i in red) for x in shards)
        sums = []
        for x in shards:
            xc = x.to(torch.float32) - c.to(x.device)
            sums.append(torch.cat([xc.sum(dim=red),
                                   xc.square().sum(dim=red)]))
        tot = device_sum(sums, dev0)
        n_ch = tot.numel() // 2
        mean_c, meansq_c = tot[:n_ch] / count, tot[n_ch:] / count
        var = torch.clamp_min(meansq_c - mean_c.square(), 0.0)
        mean = mean_c + c.reshape(mean_c.shape)
        inv = torch.rsqrt(var + eps)
        outs = [_bn_affine(x, g.to(x.device), beta.to(x.device),
                           mean.to(x.device), inv.to(x.device), bshape)
                for x in shards]
        ctx.save_for_backward(g, mean, inv, *shards)
        ctx.red, ctx.bshape, ctx.count = red, bshape, count
        ctx.mark_non_differentiable(mean, var)
        return (*outs, mean, var)

    @staticmethod
    def backward(ctx, *grads):
        from ..parallel.collectives import device_sum
        g, mean, inv, *shards = ctx.saved_tensors
        red, bshape, m = ctx.red, ctx.bshape, ctx.count
        dev0 = g.device
        parts, sum_dy, sum_dy_xhat = [], [], []
        for x, dy in zip(shards, grads):
            inv_k, mean_k = inv.to(x.device), mean.to(x.device)
            a = (inv_k * g.to(x.device, torch.float32)).to(x.dtype)
            xhat = x * inv_k.reshape(bshape).to(x.dtype) \
                + (-mean_k * inv_k).to(x.dtype).reshape(bshape)
            parts.append((a, xhat))
            sum_dy.append(dy.sum(dim=red, dtype=torch.float32))
            sum_dy_xhat.append((dy * xhat).sum(dim=red,
                                               dtype=torch.float32))
        tot_dy = device_sum(sum_dy, dev0)
        tot_dy_xhat = device_sum(sum_dy_xhat, dev0)
        dxs = []
        for x, dy, (a, xhat) in zip(shards, grads, parts):
            c1 = (tot_dy / m).to(x.device, x.dtype).reshape(bshape)
            c2 = (tot_dy_xhat / m).to(x.device, x.dtype).reshape(bshape)
            dxs.append(a.reshape(bshape) * (dy - c1 - xhat * c2))
        return (tot_dy_xhat.to(g.dtype), tot_dy.to(g.dtype), None, None,
                None, None, *dxs)


def _batch_norm_mesh(attrs, vals, rng, mesh):
    """Training BatchNorm over a batch split on the in-process mesh: the
    global batch's moments (:class:`_BNTrainMesh`), as one device
    computes them on the whole. Eval, or a batch split along the channel
    axis, goes by the op's mesh rule."""
    from ..parallel.mesh import MeshTensor, is_split
    data, gamma, beta, moving_mean, moving_var = vals
    axis = int(attrs.get("axis", 1)) % data.dim()
    if not (_is_train(attrs) and not attrs.get("use_global_stats", False)) \
            or not is_split(data) or data.axis == axis \
            or any(is_split(v) for v in vals[1:]):
        return NotImplemented
    eps = float(attrs.get("eps", 1e-3))
    momentum = float(attrs.get("momentum", 0.9))
    red = tuple(i for i in range(data.dim()) if i != axis)
    bshape = tuple(data.shape[axis] if i == axis else 1
                   for i in range(data.dim()))
    g = torch.ones_like(gamma) if attrs.get("fix_gamma", True) else gamma
    c = moving_mean.detach().to(torch.float32, copy=True).reshape(bshape)
    res = _BNTrainMesh.apply(g, beta, c, red, bshape, eps, *data.shards)
    out = MeshTensor(res[:-2], mesh, data.axis)
    mean, var = res[-2], res[-1]
    new_mean = (momentum * moving_mean.detach().to(torch.float32)
                + (1 - momentum) * mean).to(moving_mean.dtype)
    new_var = (momentum * moving_var.detach().to(torch.float32)
               + (1 - momentum) * var).to(moving_var.dtype)
    mean = _cast(mean.detach(), gamma.dtype)
    var = _cast(var.detach(), gamma.dtype)
    outs = (out, mean, var) if attrs.get("output_mean_var", False) \
        else (out,)
    return outs + (new_mean, new_var)


def _global_batch():
    """``(mesh, axis)`` when the active mesh shards the batch over more
    than one rank (its ``dp``/``data`` axis), else None."""
    from ..parallel.mesh import current_mesh, data_axis
    mesh = current_mesh()
    axis = data_axis(mesh)
    if axis is None or mesh.axis_size(axis) == 1:
        return None
    return mesh, axis


def _batch_norm(attrs, data, gamma, beta, moving_mean, moving_var):
    """Normalize over every axis but ``axis``: by the batch moments in
    training (unless ``use_global_stats``), by the moving statistics in
    eval. Returns the outputs, then the new moving mean and variance
    ``momentum * old + (1 - momentum) * batch`` (fp32; unchanged in
    eval), which the caller writes back. Not ``F.batch_norm``: torch
    updates with the unbiased variance and weighs the new batch by
    ``momentum``. Under a mesh whose batch axis spans several ranks
    (``parallel.use_mesh``; the data-parallel trainers install theirs)
    the batch moments are the global batch's, as inside a JAX mesh
    program."""
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
        out, mean, var = _BNTrain.apply(data, g, beta, c, red, bshape, eps,
                                        _global_batch())
        new_mean = (momentum * moving_mean.detach().to(torch.float32)
                    + (1 - momentum) * mean).to(moving_mean.dtype)
        new_var = (momentum * moving_var.detach().to(torch.float32)
                   + (1 - momentum) * var).to(moving_var.dtype)
    else:
        mean = _cast(moving_mean, torch.float32)
        var = _cast(moving_var, torch.float32)
        new_mean, new_var = moving_mean, moving_var
        out = _bn_affine(data, g, beta, mean, torch.rsqrt(var + eps), bshape)
    mean = _cast(mean.detach(), gamma.dtype)
    var = _cast(var.detach(), gamma.dtype)
    outs = (out, mean, var) if attrs.get("output_mean_var", False) \
        else (out,)
    return outs + (new_mean, new_var)


register("BatchNorm", _batch_norm,
         arg_names=("data", "gamma", "beta", "moving_mean", "moving_var"),
         defaults={"eps": 1e-3, "momentum": 0.9, "fix_gamma": True,
                   "use_global_stats": False, "output_mean_var": False,
                   "axis": 1, "cudnn_off": False, "__train__": False},
         num_outputs=_batch_norm_outputs, mutable_inputs=(3, 4),
         mesh_impl=_batch_norm_mesh,
         attr_docs={"eps": "added to variance for numeric stability",
                    "momentum": "running-stat decay factor",
                    "fix_gamma": "freeze gamma at 1",
                    "use_global_stats": "normalize with running stats "
                                        "even in training",
                    "axis": "channel axis"},
         attr_ranges={"momentum": (0.0, 1.0), "eps": (0.0, None)})


def _layer_norm(attrs, data, gamma, beta):
    """The JAX package's arithmetic: normalize in the data's dtype, then
    scale and shift with promotion, so bfloat16 data with float32
    gamma/beta (what ``amp.DtypePolicy`` keeps) returns float32. One
    dtype throughout takes ``F.layer_norm``."""
    axis = int(attrs.get("axis", -1)) % data.ndim
    eps = float(attrs.get("eps", 1e-5))
    if not attrs.get("output_mean_var", False) and axis == data.ndim - 1 \
            and data.dtype == gamma.dtype == beta.dtype:
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


def _instance_norm(attrs, data, gamma, beta):
    """Each sample's channels normalized over their spatial dims (the
    JAX package's arithmetic: biased variance, ``rsqrt(var + eps)``),
    then scaled by ``gamma`` and shifted by ``beta`` a channel."""
    eps = float(attrs.get("eps", 1e-3))
    red = tuple(range(2, data.dim()))
    mean = torch.mean(data, dim=red, keepdim=True)
    var = torch.var(data, dim=red, keepdim=True, unbiased=False)
    out = (data - mean) * torch.rsqrt(var + eps)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


register("InstanceNorm", _instance_norm, arg_names=("data", "gamma", "beta"),
         defaults={"eps": 1e-3})


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
    if nd == 0:
        # no spatial dim: the JAX package's (1, 1) window over (N, C)
        if pool_type in ("max", "avg", "sum"):
            return data
        if pool_type == "lp":
            p = float(attrs.get("p_value", 2))
            return (torch.abs(data) ** p) ** (1.0 / p)
        raise ValueError("Pooling: unknown pool_type %r" % pool_type)
    if nd < 0 or nd > 3:
        raise MXNetError("Pooling: data of %d dims; 2 to 5 are supported"
                         % data.ndim)
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


def _dropout_mesh(attrs, vals, rng, mesh):
    """Dropout drawing over a batch split on the in-process mesh: the
    whole mask is drawn on the mesh's first device, as one device draws
    it, and each shard takes its part."""
    from ..parallel.mesh import MeshTensor
    data = vals[0]
    if not _dropout_draws(attrs, _is_train(attrs)):
        return NotImplemented
    keep = 1.0 - float(attrs.get("p", 0.5))
    shape = list(data.shape)
    for a in tuple(attrs.get("axes", ()) or ()):
        shape[a] = 1
    dev0 = mesh.devices[0]
    if rng is None:
        from .. import random as _random
        rng = _random.generator(dev0)
    mask = (torch.rand(shape, generator=rng, device=dev0)
            < keep).to(data.dtype)
    if shape[data.axis] == 1:
        masks = [mask] * mesh.size
    else:
        masks = mesh.split(mask, data.axis).shards
    return MeshTensor([x * m.to(x.device) / keep
                       for x, m in zip(data.shards, masks)], mesh, data.axis)


register("Dropout", _dropout, arg_names=_D, needs_rng=True,
         mesh_impl=_dropout_mesh,
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


def _softmax_t(x, axis):
    """Softmax; in low precision ``jax.nn.softmax``'s own steps, each
    rounded to the input's dtype (``exp(x - max) / sum``), which is
    what the JAX package computes there (torch's fused softmax rounds
    once)."""
    if x.dtype not in _LOW:
        return torch.softmax(x, axis)
    e = torch.exp(x - torch.amax(x, dim=axis, keepdim=True))
    return e / torch.sum(e, dim=axis, keepdim=True)


def _log_softmax_t(x, axis):
    """Log-softmax; in low precision ``jax.nn.log_softmax``'s steps."""
    if x.dtype not in _LOW:
        return torch.log_softmax(x, axis)
    shifted = x - torch.amax(x, dim=axis, keepdim=True).detach()
    return shifted - torch.log(torch.sum(torch.exp(shifted), dim=axis,
                                         keepdim=True))


register("softmax",
         lambda attrs, x: _softmax_t(_tempered(attrs, x),
                                     int(attrs.get("axis", -1))),
         arg_names=_D, defaults={"axis": -1, "temperature": None,
                                 "dtype": None})
register("log_softmax",
         lambda attrs, x: _log_softmax_t(_tempered(attrs, x),
                                         int(attrs.get("axis", -1))),
         arg_names=_D, defaults={"axis": -1, "temperature": None,
                                 "dtype": None})


def _so_softmax(data, cfg):
    """SoftmaxOutput's forward: softmax over axis 1 (``multi_output``),
    the last axis (``preserve_shape``) or the flattened trailing axes."""
    if cfg["multi_output"]:
        return _softmax_t(data, 1)
    if cfg["preserve_shape"]:
        return _softmax_t(data, -1)
    return _softmax_t(data.reshape(data.shape[0], -1),
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
                else torch.full((), float(label.numel()), device=p.device)
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


# ---------------------------------------------------------------------------
# Sequence ops: ``axis`` is the time axis (0: (T, B, ...), 1: (B, T, ...));
# with ``use_sequence_length`` each sample's own length applies
# ---------------------------------------------------------------------------

def _seq_args(attrs):
    return ["data", "sequence_length"] \
        if attrs.get("use_sequence_length", False) else ["data"]


def _time_index(data, axis):
    """``t`` broadcast over ``data``'s shape along ``axis``."""
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return torch.arange(data.shape[axis], device=data.device).reshape(shape)


def _sequence_mask(attrs, data, sequence_length=None):
    """Positions at or past each sample's length set to ``value``."""
    if not attrs.get("use_sequence_length", False) \
            or sequence_length is None:
        return data
    axis = int(attrs.get("axis", 0))
    batch_axis = 1 - axis
    shape = [1] * data.dim()
    shape[batch_axis] = data.shape[batch_axis]
    lens = sequence_length.to(torch.int32).reshape(shape)
    return torch.where(_time_index(data, axis) < lens, data,
                       torch.full((), float(attrs.get("value", 0.0)),
                                  dtype=data.dtype, device=data.device))


register("SequenceMask", _sequence_mask,
         arg_names=("data", "sequence_length"),
         defaults={"use_sequence_length": False, "value": 0.0, "axis": 0},
         arg_names_fn=_seq_args)


def _sequence_last(attrs, data, sequence_length=None):
    """Each sample's last valid step (the last step without lengths)."""
    axis = int(attrs.get("axis", 0))
    if not attrs.get("use_sequence_length", False) \
            or sequence_length is None:
        return data.select(axis, -1)
    moved = torch.movedim(data, axis, 0)                 # (T, B, ...)
    last = (sequence_length.to(torch.long) - 1).reshape(
        (1, -1) + (1,) * (moved.dim() - 2))
    return torch.take_along_dim(moved, last, dim=0)[0]


register("SequenceLast", _sequence_last,
         arg_names=("data", "sequence_length"),
         defaults={"use_sequence_length": False, "axis": 0},
         arg_names_fn=_seq_args)


def _sequence_reverse(attrs, data, sequence_length=None):
    """Each sample's first ``length`` steps reversed, the rest kept."""
    axis = int(attrs.get("axis", 0))
    if not attrs.get("use_sequence_length", False) \
            or sequence_length is None:
        return torch.flip(data, (axis,))
    moved = torch.movedim(data, axis, 0)                 # (T, B, ...)
    lens = sequence_length.to(torch.long).reshape(
        (1, -1) + (1,) * (moved.dim() - 2))
    t = _time_index(moved, 0)
    src = torch.where(t < lens, lens - 1 - t, t).expand(moved.shape)
    return torch.movedim(torch.gather(moved, 0, src), 0, axis)


register("SequenceReverse", _sequence_reverse,
         arg_names=("data", "sequence_length"),
         defaults={"use_sequence_length": False, "axis": 0},
         arg_names_fn=_seq_args)


# ---------------------------------------------------------------------------
# The softmax family's other members
# ---------------------------------------------------------------------------

register("softmin",
         lambda attrs, x: _softmax_t(-x, int(attrs.get("axis", -1))),
         arg_names=_D, defaults={"axis": -1, "temperature": None})


def _softmax_activation(attrs, x):
    if attrs.get("mode", "instance") == "channel":
        return _softmax_t(x, 1)
    return _softmax_t(x.reshape(x.shape[0], -1), -1).reshape(x.shape)


register("SoftmaxActivation", _softmax_activation, arg_names=_D,
         defaults={"mode": "instance"})


def _softmax_cross_entropy(attrs, data, label):
    """The summed cross-entropy of (N, C) logits against N class
    labels (a scalar)."""
    logp = _log_softmax_t(data, -1)
    picked = torch.gather(logp, -1, label.to(torch.long).reshape(-1, 1))
    return -torch.sum(picked)


register("softmax_cross_entropy", _softmax_cross_entropy,
         arg_names=("data", "label"))


def _div_sqrt_dim(attrs, x):
    # the float32 square root of the width, as jnp computes it in the
    # input's dtype
    root = torch.sqrt(torch.tensor(float(x.shape[-1]), dtype=x.dtype))
    return x / float(root)


register("_contrib_div_sqrt_dim", _div_sqrt_dim, arg_names=_D)


# ---------------------------------------------------------------------------
# Normalizations
# ---------------------------------------------------------------------------

def _l2_normalization(attrs, data):
    eps = float(attrs.get("eps", 1e-10))
    mode = attrs.get("mode", "instance")
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    elif mode == "spatial":
        red = tuple(range(2, data.dim()))
    else:
        raise ValueError("L2Normalization: unknown mode %r" % mode)
    return data / torch.sqrt(torch.sum(torch.square(data), dim=red,
                                       keepdim=True) + eps)


register("L2Normalization", _l2_normalization, arg_names=_D,
         defaults={"eps": 1e-10, "mode": "instance"})


def _lrn(attrs, data):
    """Local response normalization across channels: ``nsize``
    neighbouring channels' squares, zero-padded at the ends."""
    nsize = int(attrs.get("nsize", 5))
    alpha, beta = float(attrs.get("alpha", 1e-4)), \
        float(attrs.get("beta", 0.75))
    knorm = float(attrs.get("knorm", 2.0))
    half = nsize // 2
    sq = F.pad(torch.square(data),
               [0, 0] * (data.dim() - 2) + [half, half])
    windows = sum(sq[:, i:i + data.shape[1]] for i in range(nsize))
    return data / torch.pow(knorm + (alpha / nsize) * windows, beta)


register("LRN", _lrn, arg_names=_D,
         defaults={"nsize": 5, "alpha": 1e-4, "beta": 0.75, "knorm": 2.0})


def _upsampling(attrs, *inputs):
    """``nearest``: each input repeated to the first's upsampled size and
    concatenated on channels; ``bilinear``: the data resized with
    half-pixel centres (``jax.image.resize``; the weight input that
    MXNet's bilinear mode takes is not read, as in the JAX package)."""
    scale = int(attrs.get("scale", 1))
    data = inputs[0]
    if attrs.get("sample_type", "nearest") == "nearest":
        def up(x, s):
            return torch.repeat_interleave(
                torch.repeat_interleave(x, s, dim=2), s, dim=3)
        out = up(data, scale)
        if len(inputs) > 1:
            out = torch.cat([out] + [up(x, out.shape[2] // x.shape[2])
                                     for x in inputs[1:]], dim=1)
        return out
    n, c, h, w = data.shape
    return F.interpolate(data, size=(h * scale, w * scale), mode="bilinear",
                         align_corners=False, antialias=True)


register("UpSampling", _upsampling, arg_names=("data",),
         defaults={"scale": 1, "sample_type": "nearest", "num_args": 1,
                   "num_filter": 0, "multi_input_mode": "concat",
                   "workspace": 512},
         key_var_num_args="num_args")


# ---------------------------------------------------------------------------
# Regression output layers: the forward is the prediction, the backward
# the JAX package's custom VJP (regression_output.cc), which ignores the
# head gradient and gives the label a zero one
# ---------------------------------------------------------------------------

class _RegressionOutput(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "logistic" else data.clone()
        ctx.save_for_backward(out, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        diff = out - label.reshape(out.shape)
        grad = torch.sign(diff) if ctx.kind == "mae" else diff
        num_out = math.prod(out.shape[1:])
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad * (ctx.grad_scale / num_out), dlabel, None, None


def _regression_output(kind):
    def fwd(attrs, data, label):
        return _RegressionOutput.apply(data, label, kind,
                                       float(attrs.get("grad_scale", 1.0)))
    return fwd


for _name, _kind in (("LinearRegressionOutput", "linear"),
                     ("LogisticRegressionOutput", "logistic"),
                     ("MAERegressionOutput", "mae")):
    register(_name, _regression_output(_kind), arg_names=("data", "label"),
             defaults={"grad_scale": 1.0},
             output_shapes=lambda attrs, data, label: [
                 (tuple(data.shape), data.dtype)])


# ---------------------------------------------------------------------------
# CTC loss: optax's ``ctc_loss`` (the JAX package's body) in torch, step
# for step. It takes logits (T, N, C), applies log-softmax inside, blank
# 0; a zero label is padding unless ``use_label_lengths``; ``blank_label``
# is not read (the JAX package ignores it). An alignment that cannot
# exist gives a large finite loss (log(0) is -1e5 here), not inf as
# ``torch.nn.functional.ctc_loss`` would.
# ---------------------------------------------------------------------------

_CTC_LOG_EPS = -1e5


def _ctc_args(attrs):
    names = ["data", "label"]
    if attrs.get("use_data_lengths", False):
        names.append("data_lengths")
    if attrs.get("use_label_lengths", False):
        names.append("label_lengths")
    return names


def ctc_loss_padded(logits, logit_paddings, labels, label_paddings):
    """Per-sequence CTC loss of (N, T, C) logits; paddings are 1.0 where
    a frame or label is padding (labels right-padded)."""
    n, t_max, n_class = logits.shape
    n_lab = labels.shape[1]
    logprobs = _log_softmax_t(logits, -1)
    labellens = n_lab - torch.sum(label_paddings, dim=1).to(torch.long)
    repeat = (labels[:, :-1] == labels[:, 1:]).to(logits.dtype)
    repeat = F.pad(repeat, (0, 1))
    logprobs_phi = logprobs[:, :, 0:1].transpose(0, 1)            # T N 1
    in_range = (labels >= 0) & (labels < n_class)
    emit = torch.gather(logprobs, 2, labels.clamp(0, n_class - 1)
                        .unsqueeze(1).expand(n, t_max, n_lab))
    emit = (emit * in_range.unsqueeze(1).to(emit.dtype)).transpose(0, 1)
    pads = logit_paddings.transpose(0, 1).to(logits.dtype)
    eps = _CTC_LOG_EPS
    phi = torch.full((n, n_lab + 1), eps, dtype=logits.dtype,
                     device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=1)
    em = torch.full((n, n_lab), eps, dtype=logits.dtype,
                    device=logits.device)

    def add_phi(p, score):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], score)],
                         dim=-1)

    for t in range(t_max):
        prev_phi_orig = phi
        prev_phi = add_phi(phi, em + eps * repeat)
        next_emit = torch.logaddexp(prev_phi[:, :-1] + emit[t],
                                    em + emit[t])
        next_phi = add_phi(prev_phi + logprobs_phi[t],
                           em + logprobs_phi[t] + eps * (1.0 - repeat))
        pad = pads[t].reshape(n, 1)
        em = pad * em + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = add_phi(phi, em)
    pick = torch.arange(n_lab + 1, device=logits.device) \
        == labellens.unsqueeze(1)
    return -torch.sum(last * pick.to(last.dtype), dim=1)


def _ctc_loss(attrs, data, label, *rest):
    rest = list(rest)
    data_lengths = rest.pop(0) if attrs.get("use_data_lengths", False) \
        else None
    label_lengths = rest.pop(0) if attrs.get("use_label_lengths", False) \
        else None
    t_max, n, _ = data.shape
    logits = data.transpose(0, 1)
    t_iota = torch.arange(t_max, device=data.device).unsqueeze(0)
    if data_lengths is not None:
        logit_pad = (t_iota >= data_lengths.to(torch.long).unsqueeze(1))
    else:
        logit_pad = torch.zeros((n, t_max), dtype=torch.bool,
                                device=data.device)
    labels = label.to(torch.long)
    if label_lengths is not None:
        s_iota = torch.arange(labels.shape[1], device=data.device)
        label_pad = s_iota.unsqueeze(0) >= \
            label_lengths.to(torch.long).unsqueeze(1)
    else:
        label_pad = labels == 0
    return ctc_loss_padded(logits, logit_pad.to(torch.float32), labels,
                           label_pad.to(torch.float32))


register("_contrib_ctc_loss", _ctc_loss,
         arg_names=("data", "label", "data_lengths", "label_lengths"),
         defaults={"use_data_lengths": False, "use_label_lengths": False,
                   "blank_label": "first"},
         arg_names_fn=_ctc_args, aliases=("ctc_loss", "CTCLoss"))


# the legacy ``_v1`` names: the same op under its older interface name
for _v1, _cur in (("BatchNorm_v1", "BatchNorm"),
                  ("Convolution_v1", "Convolution"),
                  ("Pooling_v1", "Pooling")):
    _op = get_op(_cur)
    register(_v1, _op.forward, arg_names=tuple(_op.arg_names),
             defaults=dict(_op.defaults), num_outputs=_op.num_outputs,
             mutable_inputs=_op.mutable_inputs,
             arg_names_fn=_op.arg_names_fn, output_shapes=_op.output_shapes,
             attr_docs=_op.attr_docs, attr_ranges=_op.attr_ranges)
