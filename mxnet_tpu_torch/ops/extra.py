"""Breadth operators (counterpart of ``mxnet_tpu/ops/extra.py``, without
its image and spatial-sampling ops, which come with a later step of
ROADMAP queue A): ``_contrib_SyncBatchNorm``, the dense bodies of the sparse ops
(``_square_sum``, ``_contrib_getnnz``, ``_contrib_SparseEmbedding``; the
sparse arrays themselves live in ``ndarray/sparse.py``), ``Crop``, the
FFT pair, the 2-D resize and adaptive pooling, ``_histogram``, the index (un)ravelling,
``hard_sigmoid``, ``add_n``, the graph helpers (``_grad_add``,
``_identity_with_attr_like_rhs``, ``_zeros_without_dtype``),
``_split_v2``, the slice and scatter assignments (out of place, as the
JAX bodies), ``_contrib_quadratic``, ``_contrib_gradientmultiplier``,
``SVMOutput`` and ``IdentityAttachKLSparseReg``.

The resizes are ``jax.image.resize``'s: half-pixel centres with an
antialiasing triangle kernel when shrinking, which is torch's
``interpolate(mode="bilinear", antialias=True)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register

_D = ("data",)


def _crop(attrs, *inputs):
    """A crop to ``h_w`` (or to the second input's spatial size), at
    ``offset`` or centred."""
    data = inputs[0]
    if len(inputs) > 1 and attrs.get("num_args", 1) == 2:
        th, tw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        th, tw = [int(s) for s in attrs.get("h_w", (0, 0))]
    if attrs.get("center_crop", False):
        oy, ox = (data.shape[2] - th) // 2, (data.shape[3] - tw) // 2
    else:
        oy, ox = (int(o) for o in attrs.get("offset", (0, 0)))
    return data[:, :, oy:oy + th, ox:ox + tw]


register("Crop", _crop, arg_names=_D,
         defaults={"num_args": 1, "offset": (0, 0), "h_w": (0, 0),
                   "center_crop": False},
         key_var_num_args="num_args")


def _fft(attrs, data):
    """The FFT of real rows, re/im interleaved on the last axis (2n)."""
    spec = torch.fft.fft(data.to(torch.complex64), dim=-1)
    out = torch.stack([spec.real, spec.imag], dim=-1)
    return out.reshape(data.shape[:-1] + (2 * data.shape[-1],)) \
        .to(torch.float32)


def _ifft(attrs, data):
    """The real part of the inverse FFT of interleaved re/im rows, times
    n (unnormalized, as the reference)."""
    n = data.shape[-1] // 2
    pairs = data.reshape(data.shape[:-1] + (n, 2))
    spec = torch.complex(pairs[..., 0].to(torch.float32),
                         pairs[..., 1].to(torch.float32))
    return torch.fft.ifft(spec, dim=-1).real.to(torch.float32) * n


register("_contrib_fft", _fft, arg_names=_D, defaults={"compute_size": 128})
register("_contrib_ifft", _ifft, arg_names=_D, defaults={"compute_size": 128})


def _resize(data, h, w):
    return F.interpolate(data, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=True)


register("_contrib_BilinearResize2D", lambda attrs, data: _resize(
    data, int(attrs.get("height", 1)), int(attrs.get("width", 1))),
    arg_names=_D, defaults={"height": 1, "width": 1, "scale_height": None,
                            "scale_width": None})


def _adaptive_avg_pool_2d(attrs, data):
    """Window means when the output divides the input; otherwise the
    JAX package's linear resize (not torch's adaptive windows)."""
    out = attrs.get("output_size", None)
    if not out:
        oh = ow = 1
    elif isinstance(out, int):
        oh = ow = out
    else:
        oh, ow = (int(s) for s in out)
    b, c, h, w = data.shape
    if h % oh == 0 and w % ow == 0:
        return data.reshape(b, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    return _resize(data, oh, ow)


register("_contrib_AdaptiveAvgPooling2D", _adaptive_avg_pool_2d,
         arg_names=_D, defaults={"output_size": None})


def _histogram(attrs, data, bins=None):
    """Counts of ``data`` in the bins (``jnp.histogram``: half-open bins,
    the last closed; values outside dropped), as float, and the edges."""
    if bins is None:
        lo, hi = (float(v) for v in attrs.get("range", (0.0, 1.0)))
        bins = torch.linspace(lo, hi, int(attrs.get("bin_cnt", 10)) + 1,
                              dtype=torch.float32, device=data.device)
    flat = data.reshape(-1)
    nb = bins.shape[0]
    idx = torch.searchsorted(bins.to(flat.dtype).contiguous(), flat,
                             right=True)
    idx = torch.where(flat == bins[-1], torch.full_like(idx, nb - 1), idx)
    counts = torch.zeros(nb + 1, dtype=flat.dtype, device=flat.device)
    counts = counts.scatter_add(0, idx, torch.ones_like(flat))
    return counts[1:nb], bins


register("_histogram", _histogram, arg_names=("data", "bins"),
         defaults={"bin_cnt": None, "range": None}, num_outputs=2,
         arg_names_fn=lambda a: ["data"] if a.get("bin_cnt")
         else ["data", "bins"])


def _ravel_multi_index(attrs, data):
    """Flat indices of the coordinate rows of ``data`` in ``shape``, each
    coordinate clipped into range."""
    shape = tuple(int(s) for s in attrs["shape"])
    flat = torch.zeros(data.shape[1:], dtype=torch.long, device=data.device)
    for i, n in enumerate(shape):
        flat = flat * n + data[i].to(torch.long).clamp(0, n - 1)
    return flat.to(data.dtype)


register("_ravel_multi_index", _ravel_multi_index, arg_names=_D,
         defaults={"shape": ()})


def _unravel_index(attrs, data):
    """Coordinates in ``shape`` of flat indices, stacked first (indices
    outside the array are clipped, as ``jnp.unravel_index``)."""
    shape = tuple(int(s) for s in attrs["shape"])
    total = 1
    for n in shape:
        total *= n
    idx = data.to(torch.long).reshape(-1)
    idx = torch.where(idx < 0, idx + total, idx).clamp(0, total - 1)
    coords = []
    for n in reversed(shape):
        coords.append(torch.remainder(idx, n))
        idx = torch.div(idx, n, rounding_mode="floor")
    return torch.stack(coords[::-1], dim=0).reshape(
        (len(shape),) + tuple(data.shape)).to(data.dtype)


register("_unravel_index", _unravel_index, arg_names=_D,
         defaults={"shape": ()})

def _square_sum(attrs, data):
    """The sum of squares over ``axis`` (all axes for None); ``exclude``
    is accepted and ignored, as in the JAX package."""
    axis = attrs.get("axis", None)
    sq = data * data
    if axis is None:
        out = sq.sum()
        return out.reshape((1,) * data.ndim) if attrs.get("keepdims") \
            else out
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    if not axes:
        return sq
    return sq.sum(dim=axes, keepdim=bool(attrs.get("keepdims", False)))


register("_square_sum", _square_sum, arg_names=_D,
         defaults={"axis": None, "keepdims": False, "exclude": False})


def _getnnz(attrs, data):
    """The count of non-zero entries (over ``axis``), int32 as the JAX
    package's index dtype."""
    nz = data.ne(0)
    axis = attrs.get("axis", None)
    if axis is None:
        return nz.sum(dtype=torch.int32)
    return nz.sum(dim=axis, dtype=torch.int32)


register("_contrib_getnnz", _getnnz, arg_names=_D, defaults={"axis": None})


def _sparse_embedding(attrs, data, weight):
    """``Embedding``'s lookup (its gradient is dense here, as in the JAX
    package)."""
    from .registry import get_op
    return get_op("Embedding").forward(dict(attrs), data, weight)


register("_contrib_SparseEmbedding", _sparse_embedding,
         arg_names=("data", "weight"),
         defaults={"input_dim": 0, "output_dim": 0, "dtype": "float32",
                   "sparse_grad": True})

register("hard_sigmoid", lambda attrs, x: torch.clamp(
    float(attrs.get("alpha", 0.2)) * x + float(attrs.get("beta", 0.5)),
    0.0, 1.0), arg_names=_D, defaults={"alpha": 0.2, "beta": 0.5})


def _add_n(attrs, *inputs):
    total = inputs[0]
    for x in inputs[1:]:
        total = total + x
    return total


register("add_n", _add_n, arg_names=("args",), defaults={"num_args": 1},
         key_var_num_args="num_args", aliases=("ElementWiseSum",))
register("_grad_add", lambda attrs, a, b: a + b, arg_names=("lhs", "rhs"))
register("_identity_with_attr_like_rhs", lambda attrs, lhs, rhs: lhs.clone(),
         arg_names=("lhs", "rhs"))


def _zeros_without_dtype(attrs):
    from .init_ops import _device
    return torch.zeros(tuple(attrs.get("shape", ())), dtype=torch.float32,
                       device=_device(attrs))


register("_zeros_without_dtype", _zeros_without_dtype, arg_names=(),
         defaults={"shape": (), "ctx": None, "dtype": None})


def _split_v2(attrs, data):
    axis = int(attrs.get("axis", 1))
    sections = int(attrs.get("sections", 0))
    if sections > 0:
        parts = torch.tensor_split(data, sections, dim=axis)
    else:
        parts = torch.tensor_split(
            data, [int(i) for i in attrs.get("indices", ())], dim=axis)
    if attrs.get("squeeze_axis", False):
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


def _split_v2_nout(attrs):
    s = int(attrs.get("sections", 0))
    return s if s > 0 else len(tuple(attrs.get("indices", ()))) + 1


register("_split_v2", _split_v2, arg_names=_D,
         defaults={"indices": (), "axis": 1, "squeeze_axis": False,
                   "sections": 0},
         num_outputs=_split_v2_nout)


def _assign_key(attrs, x):
    from .matrix import slice_key
    begin, end, step = attrs.get("begin", ()), attrs.get("end", ()), \
        attrs.get("step", ())
    slices = [slice(begin[i], end[i],
                    step[i] if i < len(step) and step[i] not in (None, 0)
                    else 1) for i in range(len(begin))]
    return slice_key(x.shape, slices, x.device)


def _slice_assign(attrs, lhs, rhs):
    """``lhs`` with ``lhs[begin:end:step] = rhs``, as a new array."""
    out = lhs.clone()
    out[_assign_key(attrs, lhs)] = rhs
    return out


def _slice_assign_scalar(attrs, lhs):
    out = lhs.clone()
    # a 0-d tensor on the device: a Python scalar would be copied from
    # the host for an indexed (negative-step) assignment
    out[_assign_key(attrs, lhs)] = torch.full(
        (), float(attrs.get("scalar", 0.0)), dtype=lhs.dtype,
        device=lhs.device)
    return out


register("_slice_assign", _slice_assign, arg_names=("lhs", "rhs"),
         defaults={"begin": (), "end": (), "step": ()})
register("_slice_assign_scalar", _slice_assign_scalar, arg_names=("lhs",),
         defaults={"begin": (), "end": (), "step": (), "scalar": 0.0})


def _scatter_set_nd(attrs, lhs, indices, rhs):
    idx = indices.to(torch.long)
    return lhs.index_put(tuple(idx[i] for i in range(idx.shape[0])), rhs)


register("_scatter_set_nd", _scatter_set_nd,
         arg_names=("lhs", "indices", "rhs"), defaults={"shape": ()})

register("_contrib_quadratic", lambda attrs, x: (
    float(attrs.get("a", 0.0)) * x * x + float(attrs.get("b", 0.0)) * x
    + float(attrs.get("c", 0.0))),
    arg_names=_D, defaults={"a": 0.0, "b": 0.0, "c": 0.0})


class _GradientMultiplier(torch.autograd.Function):
    """Identity forward; the backward scales the incoming gradient."""

    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


register("_contrib_gradientmultiplier",
         lambda attrs, x: _GradientMultiplier.apply(
             x, float(attrs.get("scalar", 1.0))),
         arg_names=_D, defaults={"scalar": 1.0})


class _SVMOutput(torch.autograd.Function):
    """Identity forward; the backward is the hinge gradient of the label
    class against the rest (svm_output.cc: L2-SVM's squared hinge by
    default, L1's with ``use_linear``), whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, label, cfg):
        ctx.save_for_backward(data, label)
        ctx.cfg = cfg
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        from .indexing import one_hot
        data, label = ctx.saved_tensors
        margin, reg, linear = ctx.cfg
        sign = 2 * one_hot(label, data.shape[-1], data.dtype) - 1
        slack = margin - sign * data
        viol = slack > 0
        grad = -sign * reg if linear else -2.0 * reg * sign * slack
        grad = torch.where(viol, grad, torch.zeros_like(grad))
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad.to(data.dtype), dlabel, None


register("SVMOutput", lambda attrs, data, label: _SVMOutput.apply(
    data, label, (float(attrs.get("margin", 1.0)),
                  float(attrs.get("regularization_coefficient", 1.0)),
                  bool(attrs.get("use_linear", False)))),
    arg_names=("data", "label"),
    defaults={"margin": 1.0, "regularization_coefficient": 1.0,
              "use_linear": False},
    output_shapes=lambda attrs, data, label: [(tuple(data.shape),
                                               data.dtype)])

# the JAX package's body is the identity: no sparseness penalty and no
# moving average (it registers no mutable input)
register("IdentityAttachKLSparseReg", lambda attrs, data: data.clone(),
         arg_names=_D,
         defaults={"sparseness_target": 0.1, "penalty": 0.001,
                   "momentum": 0.9})


def _sync_batch_norm(attrs, data, gamma, beta, moving_mean, moving_var):
    """Cross-device BatchNorm (reference: contrib/sync_batch_norm.cc):
    the BatchNorm body, whose moments are the global batch's under a
    mesh that shards the batch over several ranks (``ops/nn.py``)."""
    from .registry import get_op
    return get_op("BatchNorm").forward(dict(attrs), data, gamma, beta,
                                       moving_mean, moving_var)


register("_contrib_SyncBatchNorm", _sync_batch_norm,
         arg_names=("data", "gamma", "beta", "moving_mean", "moving_var"),
         defaults={"eps": 1e-3, "momentum": 0.9, "fix_gamma": True,
                   "use_global_stats": False, "output_mean_var": False,
                   "ndev": 1, "key": "", "__train__": False},
         mutable_inputs=(3, 4))
