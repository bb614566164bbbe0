"""INT8 quantization operators (counterpart of
``mxnet_tpu/ops/quantization.py``; reference: src/operator/quantization/
— quantize.cc, quantize_v2.cc, dequantize.cc, requantize.cc,
quantized_conv.cc, quantized_fully_connected.cc, quantized_pooling.cc,
quantized_flatten.cc, quantized_concat.cc).

Values are ``torch.int8`` tensors and accumulators ``torch.int32``.
Ranges ride as ``(min, max)`` 0-dim float32 tensors on the data's
device, never Python floats, so a program captured once (a CUDA graph,
an exported artifact) serves every range value: new ranges replay, they
recapture nothing. Calibrated ranges given as attributes are filled on
the device (``torch.full``), which a CUDA-graph capture takes.

The quantized products accumulate exactly in int32, as the JAX
package's ``preferred_element_type=int32`` products do: fully connected
through ``torch._int_mm`` (cuBLASLt's int8 path on the card), the
convolution through an int8 im2col (``Tensor.unfold`` windows;
``F.unfold`` takes no int8) and the same ``torch._int_mm``. Never an
fp32 product over int8 values: it is not exact once a sum passes 2^24.
``_int_mm`` on CUDA wants more than 16 rows and a multiple of 8 for the
inner and the output width: :func:`_int8_matmul` pads with zero rows and
columns (which add nothing to a sum) and slices the result back, on
every device alike.

The six ops that compute (quantize, quantize_v2, dequantize,
requantize, the quantized fully connected and convolution) are
``torch.library`` ops of the ``mxnet_tpu_torch`` namespace (:data:`OPS`)
whose one implementation, on every device, is the torch code here; a
fake implementation gives their shapes. An exported program then holds
one node a quantized op where the torch code traces into dozens, which
is what keeps a format-3 artifact's export time near the float graph's;
such an artifact loads where this package is importable, as one holding
attention does. Pooling, flatten and concat trace into a few nodes and
stay plain.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .registry import register

__all__ = []

_INT8_RANGE = 127.0
_INT32_RANGE = 2147483647.0
_D = ("data",)
_NS = "mxnet_tpu_torch::"
_Tensor = torch.Tensor
_OptTensor = Optional[torch.Tensor]
_OptFloat = Optional[float]
_Ranged = tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _scale_of(mn, mx):
    amax = torch.maximum(torch.abs(mn), torch.abs(mx))
    return torch.clamp_min(amax, 1e-8) / _INT8_RANGE


def _scale32_of(mn, mx):
    """int32 tensors use the amax/(2^31-1) convention (reference:
    quantization_utils.h FloatForOneQuantizedLevel<int32>)."""
    amax = torch.maximum(torch.abs(mn), torch.abs(mx))
    return torch.clamp_min(amax, 1e-30) / _INT32_RANGE


def _range(value, like):
    """A calibrated range attribute as a 0-dim tensor on ``like``'s
    device, filled there."""
    return torch.full((), float(value), dtype=like.dtype, device=like.device)


def _to_int8(x, scale):
    return torch.clamp(torch.round(x / scale), -_INT8_RANGE,
                       _INT8_RANGE).to(torch.int8)


def _range_like(data, *ranges, dtype=None):
    """A fake range output: the ranges' broadcast shape on ``data``'s
    device."""
    shape = torch.broadcast_shapes(*(r.shape for r in ranges))
    return data.new_empty(shape, dtype=dtype or ranges[0].dtype)


def _int8_of(data, scale):
    """``data`` as int8 with ``scale``, and its declared range."""
    amax = scale * _INT8_RANGE
    return _to_int8(data, scale), -amax, amax


@torch.library.custom_op(_NS + "quantize", mutates_args=())
def _quantize_op(data: _Tensor, min_range: _Tensor,
                 max_range: _Tensor) -> _Ranged:
    return _int8_of(data, _scale_of(min_range, max_range))


@_quantize_op.register_fake
def _quantize_fake(data, min_range, max_range):
    r = _range_like(data, min_range, max_range)
    return data.new_empty(data.shape, dtype=torch.int8), r, r.clone()


def _quantize(attrs, data, min_range, max_range):
    """float -> int8 with the given range (reference: quantize.cc)."""
    return _quantize_op(data, min_range, max_range)


register("_contrib_quantize", _quantize,
         arg_names=("data", "min_range", "max_range"),
         defaults={"out_type": "int8"}, num_outputs=3)


@torch.library.custom_op(_NS + "quantize_v2", mutates_args=())
def _quantize_v2_op(data: _Tensor, min_calib_range: _OptFloat,
                    max_calib_range: _OptFloat) -> _Ranged:
    if min_calib_range is None or max_calib_range is None:
        mn, mx = torch.amin(data), torch.amax(data)
    else:
        mn, mx = _range(min_calib_range, data), _range(max_calib_range, data)
    return _int8_of(data, _scale_of(mn, mx))


@_quantize_v2_op.register_fake
def _quantize_v2_fake(data, min_calib_range, max_calib_range):
    r = data.new_empty(())
    return data.new_empty(data.shape, dtype=torch.int8), r, r.clone()


def _quantize_v2(attrs, data):
    """float -> int8, the range from the data or from the calibrated
    attributes (reference: quantize_v2.cc)."""
    mn = attrs.get("min_calib_range")
    mx = attrs.get("max_calib_range")
    return _quantize_v2_op(data, None if mn is None else float(mn),
                           None if mx is None else float(mx))


register("_contrib_quantize_v2", _quantize_v2, arg_names=_D,
         defaults={"out_type": "int8", "min_calib_range": None,
                   "max_calib_range": None},
         num_outputs=3)


@torch.library.custom_op(_NS + "dequantize", mutates_args=())
def _dequantize_op(data: _Tensor, min_range: _Tensor,
                   max_range: _Tensor) -> _Tensor:
    return data.to(torch.float32) * _scale_of(min_range, max_range)


@_dequantize_op.register_fake
def _dequantize_fake(data, min_range, max_range):
    shape = torch.broadcast_shapes(data.shape, min_range.shape,
                                   max_range.shape)
    return data.new_empty(shape, dtype=torch.float32)


def _dequantize(attrs, data, min_range, max_range):
    """int8 -> float32 (reference: dequantize.cc)."""
    return _dequantize_op(data, min_range, max_range)


register("_contrib_dequantize", _dequantize,
         arg_names=("data", "min_range", "max_range"),
         defaults={"out_type": "float32"})


@torch.library.custom_op(_NS + "requantize", mutates_args=())
def _requantize_op(data: _Tensor, min_range: _Tensor, max_range: _Tensor,
                   min_calib_range: _OptFloat,
                   max_calib_range: _OptFloat) -> _Ranged:
    real = data.to(torch.float32) * _scale32_of(min_range, max_range)
    if min_calib_range is not None and max_calib_range is not None:
        new_min = _range(min_calib_range, real)
        new_max = _range(max_calib_range, real)
    else:
        new_min, new_max = torch.amin(real), torch.amax(real)
    return _int8_of(real, _scale_of(new_min, new_max))


@_requantize_op.register_fake
def _requantize_fake(data, min_range, max_range, min_calib_range,
                     max_calib_range):
    shape = torch.broadcast_shapes(data.shape, min_range.shape,
                                   max_range.shape)
    r = data.new_empty((), dtype=torch.float32)
    return data.new_empty(shape, dtype=torch.int8), r, r.clone()


def _requantize(attrs, data, min_range, max_range):
    """int32 accumulator -> int8 with a narrowed range (reference:
    requantize.cc)."""
    mn = attrs.get("min_calib_range")
    mx = attrs.get("max_calib_range")
    return _requantize_op(data, min_range, max_range,
                          None if mn is None else float(mn),
                          None if mx is None else float(mx))


register("_contrib_requantize", _requantize,
         arg_names=("data", "min_range", "max_range"),
         defaults={"out_type": "int8", "min_calib_range": None,
                   "max_calib_range": None},
         num_outputs=3)


def _out_range(a_min, a_max, b_min, b_max):
    """Declared float range of the int32 accumulator: one accumulator
    unit is worth a_scale*b_scale, and the int32 range convention maps
    2^31-1 to amax (the reference's
    quantization_range_for_multiplication)."""
    amax = _scale_of(a_min, a_max) * _scale_of(b_min, b_max) * _INT32_RANGE
    return -amax, amax


def _round_up(n, m):
    return -(-n // m) * m


def _int8_matmul(a, w):
    """``a (M, K) int8 @ w (N, K)^T int8 -> (M, N) int32``, exact, through
    ``torch._int_mm``: rows padded to more than 16 and a multiple of 8,
    K and N to multiples of 8, with zeros; the result sliced back."""
    M, K = a.shape
    N = w.shape[0]
    Mp, Kp, Np = max(_round_up(M, 8), 24), _round_up(K, 8), _round_up(N, 8)
    if (Mp, Kp) != (M, K):
        a = torch.nn.functional.pad(a, (0, Kp - K, 0, Mp - M))
    if (Np, Kp) != (N, K):
        w = torch.nn.functional.pad(w, (0, Kp - K, 0, Np - N))
    acc = torch._int_mm(a.contiguous(), w.contiguous().t())
    return acc[:M, :N]


def _add_bias(acc, bias, d_min, d_max, w_min, w_max, b_min, b_max, shape):
    """The int8 bias rescaled into accumulator units (one unit is worth
    a_scale*b_scale) and added."""
    acc_unit = _scale_of(d_min, d_max) * _scale_of(w_min, w_max)
    b_real = bias.to(torch.float32) * _scale_of(b_min, b_max)
    return acc + torch.round(b_real / acc_unit).to(torch.int32).reshape(
        shape)


def _split_quantized(attrs, inputs, no_bias_default):
    if bool(attrs.get("no_bias", no_bias_default)):
        data, weight, d_min, d_max, w_min, w_max = inputs
        return data, weight, None, d_min, d_max, w_min, w_max, None, None
    return inputs


@torch.library.custom_op(_NS + "quantized_fully_connected", mutates_args=())
def _quantized_fc_op(data: _Tensor, weight: _Tensor, bias: _OptTensor,
                     min_data: _Tensor, max_data: _Tensor,
                     min_weight: _Tensor, max_weight: _Tensor,
                     min_bias: _OptTensor, max_bias: _OptTensor,
                     flatten: bool) -> _Ranged:
    x2 = data.reshape(data.shape[0], -1) if flatten else data
    lead = x2.shape[:-1]
    acc = _int8_matmul(x2.to(torch.int8).reshape(-1, x2.shape[-1]),
                       weight.to(torch.int8)).reshape(lead + (-1,))
    omin, omax = _out_range(min_data, max_data, min_weight, max_weight)
    if bias is not None:
        acc = _add_bias(acc, bias, min_data, max_data, min_weight,
                        max_weight, min_bias, max_bias, (-1,))
    return acc, omin, omax


@_quantized_fc_op.register_fake
def _quantized_fc_fake(data, weight, bias, min_data, max_data, min_weight,
                       max_weight, min_bias, max_bias, flatten):
    lead = (data.shape[0],) if flatten else tuple(data.shape[:-1])
    r = _range_like(data, min_data, max_data, min_weight, max_weight)
    return (data.new_empty(lead + (weight.shape[0],), dtype=torch.int32), r,
            r.clone())


def _quantized_fully_connected(attrs, *inputs):
    """int8 GEMM with int32 accumulation (reference:
    quantized_fully_connected.cc)."""
    return _quantized_fc_op(*_split_quantized(attrs, inputs, False),
                            bool(attrs.get("flatten", True)))


register("_contrib_quantized_fully_connected", _quantized_fully_connected,
         arg_names=("data", "weight", "bias", "min_data", "max_data",
                    "min_weight", "max_weight", "min_bias", "max_bias"),
         defaults={"num_hidden": 0, "no_bias": False, "flatten": True},
         num_outputs=3,
         arg_names_fn=lambda a: (
             ["data", "weight", "min_data", "max_data", "min_weight",
              "max_weight"] if a.get("no_bias") else
             ["data", "weight", "bias", "min_data", "max_data",
              "min_weight", "max_weight", "min_bias", "max_bias"]))


def _im2col(x, kernel, stride, dilate, pad):
    """``x (N, C, *S) int8`` -> ``(N * prod(out), C * prod(kernel))``, the
    columns in ``(C, *kernel)`` order (a weight's ``reshape(O, -1)``),
    and the output spatial shape. Zero padding, any dtype."""
    nd = len(kernel)
    if any(pad):
        x = torch.nn.functional.pad(
            x, [p for p in reversed(pad) for _ in range(2)])
    for i in range(nd):
        span = (kernel[i] - 1) * dilate[i] + 1
        x = x.unfold(2 + i, span, stride[i])
        if dilate[i] > 1:
            x = x[..., ::dilate[i]]
    # (N, C, *out, *kernel) -> (N, *out, C, *kernel)
    out = tuple(x.shape[2:2 + nd])
    perm = (0,) + tuple(range(2, 2 + nd)) + (1,) \
        + tuple(range(2 + nd, 2 + 2 * nd))
    cols = x.permute(perm).reshape(x.shape[0] * math.prod(out), -1)
    return cols, out


@torch.library.custom_op(_NS + "quantized_conv", mutates_args=())
def _quantized_conv_op(data: _Tensor, weight: _Tensor, bias: _OptTensor,
                       min_data: _Tensor, max_data: _Tensor,
                       min_weight: _Tensor, max_weight: _Tensor,
                       min_bias: _OptTensor, max_bias: _OptTensor,
                       kernel: list[int], stride: list[int],
                       dilate: list[int], pad: list[int],
                       num_group: int) -> _Ranged:
    nd = len(kernel)
    data, weight = data.to(torch.int8), weight.to(torch.int8)
    N, C = data.shape[:2]
    O = weight.shape[0]
    cg, og = C // num_group, O // num_group
    parts = []
    for g in range(num_group):
        cols, out = _im2col(data[:, g * cg:(g + 1) * cg], kernel, stride,
                            dilate, pad)
        parts.append(_int8_matmul(
            cols, weight[g * og:(g + 1) * og].reshape(og, -1)))
    acc = parts[0] if num_group == 1 else torch.cat(parts, dim=1)
    # (N * out, O) -> (N, O, *out)
    acc = acc.reshape((N,) + out + (O,)).permute(
        (0, nd + 1) + tuple(range(1, nd + 1))).contiguous()
    omin, omax = _out_range(min_data, max_data, min_weight, max_weight)
    if bias is not None:
        acc = _add_bias(acc, bias, min_data, max_data, min_weight,
                        max_weight, min_bias, max_bias, (1, -1) + (1,) * nd)
    return acc, omin, omax


@_quantized_conv_op.register_fake
def _quantized_conv_fake(data, weight, bias, min_data, max_data,
                         min_weight, max_weight, min_bias, max_bias, kernel,
                         stride, dilate, pad, num_group):
    out = tuple((data.shape[2 + i] + 2 * pad[i]
                 - dilate[i] * (kernel[i] - 1) - 1) // stride[i] + 1
                for i in range(len(kernel)))
    r = _range_like(data, min_data, max_data, min_weight, max_weight)
    return (data.new_empty((data.shape[0], weight.shape[0]) + out,
                           dtype=torch.int32), r, r.clone())


def _quantized_conv(attrs, *inputs):
    """int8 convolution with int32 accumulation (reference:
    quantized_conv.cc): an int8 im2col, then :func:`_int8_matmul` a
    group."""
    from .nn import _tup
    kernel = tuple(attrs["kernel"])
    nd = len(kernel)
    return _quantized_conv_op(
        *_split_quantized(attrs, inputs, True), list(kernel),
        list(_tup(attrs.get("stride"), nd, 1)),
        list(_tup(attrs.get("dilate"), nd, 1)),
        list(_tup(attrs.get("pad"), nd, 0)), int(attrs.get("num_group", 1)))


register("_contrib_quantized_conv", _quantized_conv,
         arg_names=("data", "weight", "bias", "min_data", "max_data",
                    "min_weight", "max_weight", "min_bias", "max_bias"),
         defaults={"kernel": (), "stride": (), "dilate": (), "pad": (),
                   "num_filter": 0, "num_group": 1, "no_bias": True,
                   "layout": None},
         num_outputs=3,
         arg_names_fn=lambda a: (
             ["data", "weight", "min_data", "max_data", "min_weight",
              "max_weight"] if a.get("no_bias", True) else
             ["data", "weight", "bias", "min_data", "max_data",
              "min_weight", "max_weight", "min_bias", "max_bias"]))


def _quantized_pooling(attrs, data, d_min, d_max):
    """Pooling over int8 (reference: quantized_pooling.cc): the range
    is unchanged; max pooling stays exact, average pooling rounds back
    to int8."""
    from .nn import _pooling
    out = _pooling(attrs, data.to(torch.float32))
    if attrs.get("pool_type", "max") != "max":
        out = torch.clamp(torch.round(out), -128, 127)
    return out.to(torch.int8), d_min, d_max


register("_contrib_quantized_pooling", _quantized_pooling,
         arg_names=("data", "min_data", "max_data"),
         defaults={"kernel": (), "pool_type": "max", "stride": (),
                   "pad": (), "global_pool": False,
                   "pooling_convention": "valid", "cudnn_off": False},
         num_outputs=3)


def _quantized_flatten(attrs, data, d_min, d_max):
    return data.reshape(data.shape[0], -1), d_min, d_max


register("_contrib_quantized_flatten", _quantized_flatten,
         arg_names=("data", "min_data", "max_data"), num_outputs=3)


def _quantized_concat(attrs, *inputs):
    """Concat int8 inputs after rescaling each to the widest range
    (reference: quantized_concat.cc)."""
    n = int(attrs.get("num_args", len(inputs) // 3))
    datas, mins, maxs = inputs[:n], inputs[n:2 * n], inputs[2 * n:3 * n]
    wide_min, wide_max = mins[0], maxs[0]
    for m in mins[1:]:
        wide_min = torch.minimum(wide_min, m)
    for m in maxs[1:]:
        wide_max = torch.maximum(wide_max, m)
    wide_scale = _scale_of(wide_min, wide_max)
    parts = []
    for d, mn, mx in zip(datas, mins, maxs):
        ratio = _scale_of(mn, mx) / wide_scale
        parts.append(torch.clamp(torch.round(d.to(torch.float32) * ratio),
                                 -128, 127).to(torch.int8))
    return torch.cat(parts, dim=int(attrs.get("dim", 1))), wide_min, \
        wide_max


register("_contrib_quantized_concat", _quantized_concat,
         arg_names=("data",), defaults={"num_args": 1, "dim": 1},
         key_var_num_args="__qconcat_args__", num_outputs=3)


# op name -> the op: what an exported program names, and what
# deploy.load_compiled checks an artifact's ``custom_ops`` against
OPS = {_NS + name: op for name, op in (
    ("quantize", _quantize_op), ("quantize_v2", _quantize_v2_op),
    ("dequantize", _dequantize_op), ("requantize", _requantize_op),
    ("quantized_fully_connected", _quantized_fc_op),
    ("quantized_conv", _quantized_conv_op))}
