"""Shape operators (counterpart of ``mxnet_tpu/ops/matrix.py``): Reshape
with MXNet's special codes (0 copies a dim, -1 infers one, -2 copies the
rest, -3 merges two, -4 splits one; ``reverse`` resolves right to left),
Flatten (all but the batch dim into one), SliceChannel (equal parts
along one axis, one output each), Concat (any number of inputs along
one axis) and Pad (constant, edge or reflect, one ``(before, after)``
pair per dim)."""
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
