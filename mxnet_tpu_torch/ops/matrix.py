"""Shape operators (counterpart of ``mxnet_tpu/ops/matrix.py``): Reshape
with MXNet's special codes (0 copies a dim, -1 infers one, -2 copies the
rest, -3 merges two, -4 splits one; ``reverse`` resolves right to left),
Flatten (all but the batch dim into one), SliceChannel (equal parts
along one axis, one output each), Concat (any number of inputs along
one axis), stack (along a new axis), expand_dims, transpose, reverse
(``flip``), dot (the last axis of ``lhs`` with the first of ``rhs``),
Pad (constant, edge or reflect, one ``(before, after)`` pair per
dim), SwapAxis (``swapaxes``), slice_axis, tile, reshape_like, slice
(Python slices per dim, negative steps included: torch's slicing takes
none, so those dims are flipped first), slice_like, squeeze, repeat,
batch_dot, khatri_rao, depth_to_space/space_to_depth, diag and
``_rnn_param_concat``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register

_D = ("data",)


def infer_reshape(src_shape, target, reverse=False):
    """Resolve an MXNet reshape spec against a concrete input shape."""
    src, tgt = list(src_shape), list(target)
    if reverse:
        out = _infer_reshape_fwd(src[::-1], _reverse_neg4(tgt[::-1]))
        return tuple(out[::-1])
    return tuple(_infer_reshape_fwd(src, tgt))


def _reverse_neg4(tgt):
    # after list reversal "-4 a b" reads "b a -4"; rewrite to "-4 b a"
    out, i = [], 0
    while i < len(tgt):
        if i + 2 < len(tgt) and tgt[i + 2] == -4:
            out.extend([-4, tgt[i], tgt[i + 1]])
            i += 3
        else:
            out.append(tgt[i])
            i += 1
    return out


def _infer_reshape_fwd(src, tgt):
    out, src_idx, inf_idx, i = [], 0, -1, 0
    while i < len(tgt):
        t = tgt[i]
        if t > 0:
            out.append(int(t))
            src_idx += 1
        elif t == 0:
            out.append(src[src_idx])
            src_idx += 1
        elif t == -1:
            inf_idx = len(out)
            out.append(-1)
            src_idx += 1
        elif t == -2:
            out.extend(src[src_idx:])
            src_idx = len(src)
        elif t == -3:
            out.append(src[src_idx] * src[src_idx + 1])
            src_idx += 2
        elif t == -4:
            d1, d2 = int(tgt[i + 1]), int(tgt[i + 2])
            s = src[src_idx]
            if d1 == -1 and d2 == -1:
                raise ValueError("reshape: -4 with two -1s")
            if d1 == -1:
                d1 = s // d2
            if d2 == -1:
                d2 = s // d1
            out.extend([d1, d2])
            src_idx += 1
            i += 2
        else:
            raise ValueError("reshape: invalid code %d" % t)
        i += 1
    if inf_idx >= 0:
        known, total = 1, 1
        for v in out:
            if v != -1:
                known *= v
        for v in src:
            total *= v
        out[inf_idx] = total // known
    return out


def _reshape(attrs, x):
    shape = attrs.get("shape", None)
    if shape is None or shape == ():
        return x.reshape(-1)
    if isinstance(shape, int):
        shape = (shape,)
    return x.reshape(infer_reshape(x.shape, shape,
                                   bool(attrs.get("reverse", False))))


register("Reshape", _reshape, arg_names=_D,
         defaults={"shape": None, "reverse": False}, aliases=("reshape",))


register("Flatten", lambda attrs, x: x.reshape(x.shape[0], -1),
         arg_names=_D, aliases=("flatten",))


def _split(attrs, x):
    """``num_outputs`` equal parts along ``axis``, each squeezed there
    with ``squeeze_axis``."""
    axis = int(attrs.get("axis", 1))
    n = int(attrs["num_outputs"])
    if x.shape[axis] % n:
        raise ValueError("SliceChannel: axis %d of size %d does not split "
                         "into %d equal parts" % (axis, x.shape[axis], n))
    parts = torch.split(x, x.shape[axis] // n, dim=axis)
    if attrs.get("squeeze_axis", False):
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


register("SliceChannel", _split, arg_names=_D,
         defaults={"num_outputs": 1, "axis": 1, "squeeze_axis": False},
         num_outputs=lambda attrs: int(attrs.get("num_outputs", 1)),
         aliases=("split",))


def _concat(attrs, *inputs):
    return torch.cat(inputs, dim=int(attrs.get("dim", 1)))


register("Concat", _concat, arg_names=("arg",),
         defaults={"dim": 1, "num_args": 1}, key_var_num_args="num_args",
         aliases=("concat",))


register("stack", lambda attrs, *inputs: torch.stack(
    inputs, dim=int(attrs.get("axis", 0))), arg_names=("arg",),
    defaults={"axis": 0, "num_args": 1}, key_var_num_args="num_args")

register("expand_dims", lambda attrs, x: x.unsqueeze(int(attrs["axis"])),
         arg_names=_D, defaults={"axis": 0})


def _transpose(attrs, x):
    axes = attrs.get("axes", None)
    return x.permute(*axes) if axes else x.permute(*reversed(range(x.dim())))


register("transpose", _transpose, arg_names=_D, defaults={"axes": None})


def _reverse(attrs, x):
    axis = attrs.get("axis", 0)
    return torch.flip(x, (axis,) if isinstance(axis, int) else tuple(axis))


register("reverse", _reverse, arg_names=_D, defaults={"axis": 0},
         aliases=("flip",))


def _dot(attrs, x, y):
    if attrs.get("transpose_a", False):
        x = x.permute(*reversed(range(x.dim())))
    if attrs.get("transpose_b", False):
        y = y.permute(*reversed(range(y.dim())))
    if x.dim() == 1 and y.dim() == 1:
        return torch.dot(x, y)
    return torch.tensordot(x, y, dims=1)


register("dot", _dot, arg_names=("lhs", "rhs"),
         defaults={"transpose_a": False, "transpose_b": False,
                   "forward_stype": None})


def _pad_index(n, lo, hi, mode, device):
    """Source index of each padded position along a dim of size ``n``:
    clamped (edge) or mirrored without repeating the border (reflect, as
    numpy's, a triangle wave when a pad exceeds ``n - 1``). Built on
    the device, so a CUDA graph can hold it."""
    idx = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return idx.clamp(0, n - 1)
    period = 2 * (n - 1)
    idx = idx.abs().remainder(period)
    return torch.where(idx >= n, period - idx, idx)


def _pad(attrs, x):
    """``pad_width`` holds ``(before, after)`` for every dim in order;
    ``constant`` fills with ``constant_value``, ``edge`` repeats the
    border, ``reflect`` mirrors around it."""
    mode = attrs.get("mode", "constant")
    pw = attrs["pad_width"]
    pairs = [(int(pw[2 * i]), int(pw[2 * i + 1])) for i in range(x.dim())]
    if mode == "constant":
        flat = [v for lo_hi in reversed(pairs) for v in lo_hi]
        return F.pad(x, flat, value=float(attrs.get("constant_value", 0.0)))
    if mode not in ("edge", "reflect"):
        raise ValueError("Pad: unknown mode %r" % mode)
    for dim, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = x.index_select(dim, _pad_index(x.shape[dim], lo, hi, mode,
                                               x.device))
    return x


register("Pad", _pad, arg_names=_D,
         defaults={"mode": "constant", "pad_width": (), "constant_value": 0.0},
         aliases=("pad",))


register("SwapAxis", lambda attrs, x: torch.swapaxes(
    x, int(attrs.get("dim1", 0)), int(attrs.get("dim2", 0))),
    arg_names=_D, defaults={"dim1": 0, "dim2": 0}, aliases=("swapaxes",))


def _slice_axis(attrs, x):
    """``x[begin:end]`` along ``axis`` (``end=None`` to the end;
    negative bounds count from the end)."""
    idx = [slice(None)] * x.dim()
    idx[int(attrs["axis"])] = slice(attrs.get("begin", 0),
                                    attrs.get("end", None))
    return x[tuple(idx)]


register("slice_axis", _slice_axis, arg_names=_D,
         defaults={"axis": 0, "begin": 0, "end": None})

register("tile", lambda attrs, x: torch.tile(x, tuple(attrs["reps"])),
         arg_names=_D, defaults={"reps": ()})

register("reshape_like", lambda attrs, x, y: x.reshape(y.shape),
         arg_names=("lhs", "rhs"))


def positive_slices(x, slices, first_dim=0):
    """``x[slices]`` for per-dim Python slices starting at ``first_dim``,
    negative steps included: each such dim is flipped and its slice
    rewritten with a positive step (the same elements in the same
    order)."""
    flips, key = [], [slice(None)] * first_dim
    for i, sl in enumerate(slices):
        if sl.step is not None and sl.step < 0:
            d = first_dim + i
            n = x.shape[d]
            start, stop, step = sl.indices(n)
            flips.append(d)
            sl = slice(n - 1 - start, n - 1 - stop, -step)
        key.append(sl)
    if flips:
        x = torch.flip(x, flips)
    return x[tuple(key)]


def slice_key(shape, slices, device):
    """An indexing key for ``slices`` that also writes: plain slices when
    every step is positive, else one ``arange`` per dim shaped to
    broadcast like ``numpy.ix_`` (the elements basic slicing selects, in
    its result shape)."""
    if all(sl.step is None or sl.step > 0 for sl in slices):
        return tuple(slices)
    k = len(slices)
    out = []
    for i, sl in enumerate(slices):
        r = torch.arange(*sl.indices(shape[i]), device=device)
        out.append(r.reshape([-1 if j == i else 1 for j in range(k)]))
    return tuple(out)


def _slice(attrs, x):
    begin, end = attrs["begin"], attrs["end"]
    step = attrs.get("step", None) or (None,) * len(begin)
    slices = [slice(begin[i], end[i] if i < len(end) else None,
                    step[i] if i < len(step) else None)
              for i in range(min(len(begin), x.dim()))]
    return positive_slices(x, slices)


register("slice", _slice, arg_names=_D,
         defaults={"begin": (), "end": (), "step": None})


def _slice_like(attrs, x, shape_like):
    axes = attrs.get("axes", ()) or tuple(range(min(x.dim(),
                                                    shape_like.dim())))
    idx = [slice(None)] * x.dim()
    for a in axes:
        idx[a % x.dim()] = slice(0, shape_like.shape[a % x.dim()])
    return x[tuple(idx)]


register("slice_like", _slice_like, arg_names=("lhs", "rhs"),
         defaults={"axes": ()})


def _squeeze(attrs, x):
    axis = attrs.get("axis", None)
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, (axis,) if isinstance(axis, int)
                         else tuple(axis))


register("squeeze", _squeeze, arg_names=_D, defaults={"axis": None})


def _repeat(attrs, x):
    axis = attrs.get("axis", None)
    reps = int(attrs["repeats"])
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), reps)
    return torch.repeat_interleave(x, reps, dim=int(axis))


register("repeat", _repeat, arg_names=_D,
         defaults={"repeats": 1, "axis": None})


def _batch_dot(attrs, x, y):
    if attrs.get("transpose_a", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_b", False):
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


register("batch_dot", _batch_dot, arg_names=("lhs", "rhs"),
         defaults={"transpose_a": False, "transpose_b": False,
                   "forward_stype": None})


def _khatri_rao(attrs, *mats):
    """The column-wise Kronecker product of the inputs (the first's rows
    vary slowest)."""
    out = mats[0]
    for m in mats[1:]:
        out = torch.einsum("ik,jk->ijk", out, m).reshape(-1, out.shape[-1])
    return out


register("khatri_rao", _khatri_rao, arg_names=("args",),
         defaults={"num_args": 1}, key_var_num_args="num_args")


def _depth_to_space(attrs, x):
    b = int(attrs["block_size"])
    n, c, h, w = x.shape
    x = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


def _space_to_depth(attrs, x):
    b = int(attrs["block_size"])
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


register("depth_to_space", _depth_to_space, arg_names=_D,
         defaults={"block_size": 1})
register("space_to_depth", _space_to_depth, arg_names=_D,
         defaults={"block_size": 1})


def _diag(attrs, x):
    """A 1-D input becomes the ``k``-th diagonal of a matrix; otherwise
    the ``k``-th diagonal of the ``axis1``/``axis2`` planes, moved last."""
    k = int(attrs.get("k", 0))
    if x.dim() == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=int(attrs.get("axis1", 0)),
                          dim2=int(attrs.get("axis2", 1)))


register("diag", _diag, arg_names=_D,
         defaults={"k": 0, "axis1": 0, "axis2": 1})

register("_rnn_param_concat", lambda attrs, *inputs: torch.cat(
    inputs, dim=int(attrs.get("dim", 0))), arg_names=("arg",),
    defaults={"dim": 0, "num_args": 1}, key_var_num_args="num_args")
