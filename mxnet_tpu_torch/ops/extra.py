"""Breadth operators (counterpart of ``mxnet_tpu/ops/extra.py``): the
spatial sampling ops (``GridGenerator``, ``BilinearSampler``,
``SpatialTransformer``, one bilinear core), ``Correlation``, the image
ops (``_image_to_tensor``/``_image_totensor``, ``_image_normalize``,
``_image_resize``), ``_contrib_edge_id``, ``_contrib_SyncBatchNorm``,
the dense bodies of the sparse ops
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
``interpolate(mode="bilinear", antialias=True)``; like it, they return
float32 for an integer image.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register, get_op  # noqa: F401  (the reference's name)

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


# (the values as float hex strings, dtype, device) -> the tensor
# filled() made for them
_FILLED = {}


def filled(values, device, dtype=torch.float32):
    """A 1-D tensor of the Python numbers ``values`` on ``device``, made
    once per values, dtype and device and kept, so a later call launches
    nothing. It is made from one fill an entry: a host-to-device copy of
    a host array (or an entry set by indexing) makes the host wait for a
    CUDA device. One made while a CUDA graph is being captured is not
    kept: it holds its values only once the graph replays."""
    key = (tuple(float(v).hex() for v in values), dtype,
           torch.device(device))
    out = _FILLED.get(key)
    if out is None:
        out = torch.stack([torch.full((), float(v), dtype=dtype,
                                      device=device) for v in values])
        if not (out.is_cuda and torch.cuda.is_current_stream_capturing()):
            _FILLED[key] = out
    return out


def true_div(x, d):
    """``x / d`` for a Python number ``d``, correctly rounded on every
    device: torch's CUDA kernel multiplies by ``1 / d`` for a number
    divisor, which moves a floor or ceil that lands on an integer."""
    return x / torch.full_like(x, d)


# ---------------------------------------------------------------------------
# spatial sampling (grid_generator.cc, bilinear_sampler.cc,
# spatial_transformer.cc): one bilinear core
# ---------------------------------------------------------------------------

def _sample_bilinear(data, grid_x, grid_y):
    """``data`` (B, C, H, W) sampled at ``grid_x``/``grid_y`` (B, Ho, Wo),
    normalized to [-1, 1]; a corner outside the image adds zero."""
    B, C, H, W = data.shape
    x = (grid_x + 1.0) * (W - 1) / 2.0
    y = (grid_y + 1.0) * (H - 1) / 2.0
    x0, y0 = torch.floor(x), torch.floor(y)
    flat = data.reshape(B, C, H * W)
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0 + dx, y0 + dy
            w = (1 - torch.abs(x - xi)) * (1 - torch.abs(y - yi))
            inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
            idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
            idx = idx.reshape(B, 1, -1).expand(B, C, idx[0].numel())
            got = torch.gather(flat, 2, idx).reshape(
                (B, C) + tuple(grid_x.shape[1:]))
            out = out + got * (w * inside)[:, None]
    return out


def _affine_grid(theta, H, W):
    """``theta`` (B, 6) → the sampling grid's x and y, each (B, H, W)."""
    ys = torch.linspace(-1.0, 1.0, H, dtype=theta.dtype,
                        device=theta.device)
    xs = torch.linspace(-1.0, 1.0, W, dtype=theta.dtype,
                        device=theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], 0).reshape(3, -1)
    out = torch.einsum("bij,jk->bik", theta.reshape(-1, 2, 3), base)
    return out[:, 0].reshape(-1, H, W), out[:, 1].reshape(-1, H, W)


def _grid_generator(attrs, data):
    """affine: ``data`` (B, 6) and ``target_shape``; warp: ``data`` (B, 2,
    H, W), a flow in pixels added to the identity grid."""
    if attrs.get("transform_type", "affine") == "affine":
        H, W = [int(s) for s in attrs["target_shape"]]
        gx, gy = _affine_grid(data, H, W)
        return torch.stack([gx, gy], 1)
    B, _, H, W = data.shape
    gy, gx = torch.meshgrid(
        torch.arange(H, dtype=data.dtype, device=data.device),
        torch.arange(W, dtype=data.dtype, device=data.device),
        indexing="ij")
    nx = 2.0 * (gx + data[:, 0]) / max(W - 1, 1) - 1.0
    ny = 2.0 * (gy + data[:, 1]) / max(H - 1, 1) - 1.0
    return torch.stack([nx, ny], 1)


register("GridGenerator", _grid_generator, arg_names=_D,
         defaults={"transform_type": "affine", "target_shape": (0, 0)})

register("BilinearSampler", lambda attrs, data, grid: _sample_bilinear(
    data, grid[:, 0], grid[:, 1]),
    arg_names=("data", "grid"), defaults={"cudnn_off": None})


def _spatial_transformer(attrs, data, loc):
    H, W = [int(s) for s in attrs["target_shape"]]
    return _sample_bilinear(data, *_affine_grid(loc, H, W))


register("SpatialTransformer", _spatial_transformer,
         arg_names=("data", "loc"),
         defaults={"target_shape": (0, 0), "transform_type": "affine",
                   "sampler_type": "bilinear", "cudnn_off": None})


def _correlation(attrs, data1, data2):
    """correlation.cc: the mean over channels and a k x k window of the
    patch product (or absolute difference) at each displacement of the
    neighbourhood (stride2 apart); stride1 subsamples the output."""
    max_disp = int(attrs.get("max_displacement", 1))
    stride1 = int(attrs.get("stride1", 1))
    stride2 = int(attrs.get("stride2", 1))
    ksize = int(attrs.get("kernel_size", 1))
    multiply = bool(attrs.get("is_multiply", True))
    kr = (ksize - 1) // 2
    pad = max_disp + kr
    B, C, H, W = data1.shape
    p1 = F.pad(data1, (kr, kr, kr, kr))
    p2 = F.pad(data2, (pad, pad, pad, pad))
    offsets = range(-max_disp, max_disp + 1, stride2)
    norm = C * ksize * ksize
    maps = []
    for dy in offsets:
        for dx in offsets:
            acc = 0.0
            for ky in range(ksize):
                for kx in range(ksize):
                    a = p1[:, :, ky:ky + H, kx:kx + W]
                    oy, ox = pad + dy - kr + ky, pad + dx - kr + kx
                    b = p2[:, :, oy:oy + H, ox:ox + W]
                    term = a * b if multiply else torch.abs(a - b)
                    acc = acc + torch.sum(term, 1)
            maps.append(acc / norm)
    return torch.stack(maps, 1)[:, :, ::stride1, ::stride1]


register("Correlation", _correlation, arg_names=("data1", "data2"),
         defaults={"kernel_size": 1, "max_displacement": 1, "stride1": 1,
                   "stride2": 1, "pad_size": 0, "is_multiply": True})


# ---------------------------------------------------------------------------
# image ops (src/operator/image/)
# ---------------------------------------------------------------------------

def _image_to_tensor(attrs, data):
    """HWC (or NHWC) [0, 255] → CHW (NCHW) float32 [0, 1]."""
    x = data.to(torch.float32) / 255.0
    return x.permute(2, 0, 1) if x.dim() == 3 else x.permute(0, 3, 1, 2)


register("_image_to_tensor", _image_to_tensor, arg_names=_D,
         aliases=("_image_totensor",))


def _image_normalize(attrs, data):
    """(x - mean) / std over the channel axis of CHW or NCHW."""
    shape = [1] * data.dim()
    shape[data.dim() - 3] = -1
    mean = filled(attrs.get("mean", (0.0,)), data.device).reshape(shape)
    std = filled(attrs.get("std", (1.0,)), data.device).reshape(shape)
    return (data - mean) / std


register("_image_normalize", _image_normalize, arg_names=_D,
         defaults={"mean": (0.0,), "std": (1.0,)})


def resize_hwc(data, h, w):
    """``jax.image.resize(data, (..., h, w, C), "bilinear")`` of an HWC
    or NHWC image: antialiased when shrinking, float32 for an integer
    image (JAX promotes it and does not cast back)."""
    x = data if data.is_floating_point() else data.to(torch.float32)
    batched = x.dim() == 4
    img = x.permute(0, 3, 1, 2) if batched else x.permute(2, 0, 1)[None]
    out = _resize(img, h, w)
    return out.permute(0, 2, 3, 1) if batched else out[0].permute(1, 2, 0)


def _image_resize(attrs, data):
    size = attrs.get("size", 0)
    if isinstance(size, int):
        size = (size, size)
    return resize_hwc(data, int(size[1]), int(size[0]))


register("_image_resize", _image_resize, arg_names=_D,
         defaults={"size": 0, "keep_ratio": False, "interp": 1})


# the dense body of the CSR edge-id lookup: data[u, v]
register("_contrib_edge_id", lambda attrs, data, u, v: data[
    u.long(), v.long()], arg_names=("data", "u", "v"))
