"""Neural-network operators (counterpart of ``mxnet_tpu/ops/nn.py``):
``FullyConnected``, ``Activation``, ``LayerNorm``, ``softmax`` and
``log_softmax``. Matrix products go to cuBLAS through torch, as the JAX
package leaves them to XLA; there is no hand kernel among them."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register

_D = ("data",)


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
