"""Indexing and ordering operators (counterpart of
``mxnet_tpu/ops/indexing.py``): ``Embedding`` (row lookup, indices
clipped into range), ``pick`` (one element per row along an axis,
``clip`` or ``wrap`` indices), ``gather_nd``/``scatter_nd``, ``take``,
``batch_take``, ``one_hot``, ``sort``/``argsort``/``topk``, ``_getitem``
(the NDArray indexing encoding as one op), ``_contrib_boolean_mask``,
``_contrib_index_copy`` and ``_sparse_retain`` (the dense body of row
retention).

Ties follow the JAX package, on both devices: ``sort``/``argsort`` sort
stably and flip for descending order (so tied elements come out in
reverse index order), ``topk`` keeps the lower index first
(``lax.top_k``), through a stable sort (``torch.topk`` makes no promise
on ties). Indices come back as float32 unless ``dtype`` says otherwise.
Every body stays on its input's device: no host read."""
from __future__ import annotations

import torch

from .registry import register

_D = ("data",)


def _embedding(attrs, data, weight):
    idx = data.to(torch.long).clamp(0, weight.shape[0] - 1)
    return torch.nn.functional.embedding(idx, weight)


register("Embedding", _embedding, arg_names=("data", "weight"),
         defaults={"input_dim": 0, "output_dim": 0, "dtype": "float32",
                   "sparse_grad": False},
         attr_docs={"input_dim": "vocabulary size",
                    "output_dim": "embedding width",
                    "sparse_grad": "produce a row_sparse gradient"},
         attr_ranges={"input_dim": (0, None), "output_dim": (0, None)})


def _pick(attrs, data, index):
    axis = attrs.get("axis", -1)
    axis = data.ndim - 1 if axis is None else int(axis) % data.ndim
    n = data.shape[axis]
    idx = index.to(torch.long)
    idx = torch.remainder(idx, n) if attrs.get("mode", "clip") == "wrap" \
        else idx.clamp(0, n - 1)
    out = torch.gather(data, axis, idx.unsqueeze(axis))
    return out if attrs.get("keepdims", False) else out.squeeze(axis)


register("pick", _pick, arg_names=("data", "index"),
         defaults={"axis": -1, "keepdims": False, "mode": "clip"},
         aliases=("choose_element_0index",))


def _gather_nd(attrs, data, indices):
    """``data[indices[0], ..., indices[M-1]]``: the leading axis of
    ``indices`` holds one coordinate plane per indexed dim of ``data``."""
    idx = indices.to(torch.long)
    return data[tuple(idx[i] for i in range(idx.shape[0]))]


register("gather_nd", _gather_nd, arg_names=("data", "indices"))


def _take(attrs, a, indices):
    axis = int(attrs.get("axis", 0)) % a.dim()
    n = a.shape[axis]
    idx = indices.to(torch.long)
    idx = torch.remainder(idx, n) if attrs.get("mode", "clip") == "wrap" \
        else idx.clamp(0, n - 1)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


register("take", _take, arg_names=("a", "indices"),
         defaults={"axis": 0, "mode": "clip"})


def _batch_take(attrs, a, indices):
    idx = indices.to(torch.long).clamp(0, a.shape[1] - 1)
    return torch.gather(a, 1, idx.reshape(-1, 1)).reshape(idx.shape)


register("batch_take", _batch_take, arg_names=("a", "indices"))


def one_hot(indices, depth, dtype):
    """0/1 rows of ``depth`` (an index outside ``[0, depth)`` gives a row
    of zeros, as ``jax.nn.one_hot``), built by comparison on the
    indices' device."""
    classes = torch.arange(depth, device=indices.device)
    return (indices.to(torch.long).unsqueeze(-1) == classes).to(dtype)


def _one_hot(attrs, indices):
    from ..ndarray.ndarray import torch_dtype
    dtype = torch_dtype(attrs.get("dtype", "float32"))
    on, off = float(attrs.get("on_value", 1.0)), \
        float(attrs.get("off_value", 0.0))
    eye = one_hot(indices, int(attrs["depth"]), dtype)
    return eye * torch.full((), on - off, dtype=dtype, device=eye.device) \
        + torch.full((), off, dtype=dtype, device=eye.device)


register("one_hot", _one_hot, arg_names=("indices",),
         defaults={"depth": 1, "on_value": 1.0, "off_value": 0.0,
                   "dtype": "float32"})


def _scatter_nd(attrs, data, indices):
    idx = indices.to(torch.long)
    out = torch.zeros(tuple(attrs["shape"]), dtype=data.dtype,
                      device=data.device)
    return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), data)


register("scatter_nd", _scatter_nd, arg_names=("data", "indices"),
         defaults={"shape": ()})


def _axis(attrs, x):
    """``(x, axis)``: ``axis=None`` sorts the flattened array."""
    axis = attrs.get("axis", -1)
    if axis is None:
        return x.reshape(-1), 0
    return x, int(axis)


def _sort(attrs, x):
    x, axis = _axis(attrs, x)
    out = torch.sort(x, dim=axis, stable=True).values
    return out if attrs.get("is_ascend", True) else torch.flip(out, (axis,))


register("sort", _sort, arg_names=_D, defaults={"axis": -1, "is_ascend": True})


def _argsort(attrs, x):
    from ..ndarray.ndarray import torch_dtype
    x, axis = _axis(attrs, x)
    idx = torch.argsort(x, dim=axis, stable=True)
    if not attrs.get("is_ascend", True):
        idx = torch.flip(idx, (axis,))
    return idx.to(torch_dtype(attrs.get("dtype", "float32")))


register("argsort", _argsort, arg_names=_D,
         defaults={"axis": -1, "is_ascend": True, "dtype": "float32"})


def _topk_outputs(attrs):
    return 2 if attrs.get("ret_typ", "indices") == "both" else 1


def _topk(attrs, x):
    """The ``k`` largest (smallest with ``is_ascend``) along ``axis``,
    the lower index first among equals: one ``argmax``/``argmin`` for
    ``k = 1`` (torch returns the first extreme), else a stable sort."""
    from ..ndarray.ndarray import torch_dtype
    x, axis = _axis(attrs, x)
    axis %= x.dim()
    k = int(attrs.get("k", 1))
    ascend = bool(attrs.get("is_ascend", False))
    ret_typ = attrs.get("ret_typ", "indices")
    xs = x.movedim(axis, -1)
    if k == 1:
        idx = (torch.argmin if ascend else torch.argmax)(
            xs, dim=-1, keepdim=True)
    else:
        idx = torch.sort(xs, dim=-1, descending=not ascend,
                         stable=True).indices[..., :k]
    if ret_typ == "mask":
        mask = torch.zeros_like(xs).scatter(-1, idx, 1.0)
        return mask.movedim(-1, axis)
    vals = torch.gather(xs, -1, idx).movedim(-1, axis)
    idx_o = idx.movedim(-1, axis).to(torch_dtype(attrs.get("dtype",
                                                           "float32")))
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idx_o
    return vals, idx_o


register("topk", _topk, arg_names=_D,
         defaults={"axis": -1, "k": 1, "ret_typ": "indices",
                   "is_ascend": False, "dtype": "float32"},
         num_outputs=_topk_outputs)


def _boolean_mask(attrs, data, index):
    """The rows where ``index`` is nonzero compacted to the front and the
    rest zero-padded: the JAX package's static-shape form (the output has
    ``data``'s shape, so a CUDA graph can hold it)."""
    axis = int(attrs.get("axis", 0))
    mask = (index != 0).to(torch.int32)
    order = torch.argsort(1 - mask, stable=True)
    keep = torch.flip(torch.sort(mask).values, (0,)).to(data.dtype)
    return data.index_select(axis, order) \
        * keep.reshape((-1,) + (1,) * (data.dim() - 1))


register("_contrib_boolean_mask", _boolean_mask, arg_names=("data", "index"),
         defaults={"axis": 0})

register("_contrib_index_copy",
         lambda attrs, old, idx, new: old.index_copy(0, idx.to(torch.long),
                                                     new),
         arg_names=("old_tensor", "index_vector", "new_tensor"))


def _getitem(attrs, data, *index_arrays):
    """``data[key]`` from the NDArray indexing encoding (``spec``): per
    item ``("s", start, stop, step)`` a slice, ``("i", v)`` an integer,
    ``("b", v)`` a bool scalar, ``("n",)`` a new axis, ``("e",)`` an
    ellipsis and ``("a",)`` the next of the array inputs. A slice with a
    negative step reads its dim flipped."""
    spec = attrs["spec"]
    takes = sum(1 for item in spec if item[0] in "sia")
    it = iter(index_arrays)
    key, dim, flips = [], 0, []
    for item in spec:
        kind = item[0]
        if kind == "s":
            sl = slice(item[1], item[2], item[3])
            if sl.step is not None and sl.step < 0:
                flips.append(dim)
                n = data.shape[dim]
                start, stop, step = sl.indices(n)
                sl = slice(n - 1 - start, n - 1 - stop, -step)
            key.append(sl)
            dim += 1
        elif kind == "i":
            key.append(item[1])
            dim += 1
        elif kind == "a":
            key.append(next(it).to(torch.long))
            dim += 1
        elif kind == "b":
            key.append(bool(item[1]))
        elif kind == "n":
            key.append(None)
        else:
            key.append(Ellipsis)
            dim += data.dim() - takes
    if flips:
        data = torch.flip(data, flips)
    return data[tuple(key)]


register("_getitem", _getitem, arg_names=("data",),
         defaults={"spec": (), "num_arrays": 0},
         key_var_num_args="num_arrays")


def _sparse_retain(attrs, data, indices):
    """Row retention on dense storage (reference:
    src/operator/tensor/sparse_retain.cc): the rows of ``data`` whose
    index ``indices`` does not name become zero (``ndarray.sparse.retain``
    drops them from a row_sparse array instead)."""
    n = data.shape[0]
    idx = indices.detach().reshape(-1).to(torch.long)
    # a scatter of the named rows (an index outside [0, n) names none),
    # which makes the host wait for nothing, as torch.isin would
    hits = torch.zeros(n, dtype=torch.int32, device=data.device)
    hits.index_put_((idx.clamp(0, n - 1),),
                    ((idx >= 0) & (idx < n)).to(torch.int32),
                    accumulate=True)
    keep = (hits > 0).to(data.dtype)
    return data * keep.reshape((-1,) + (1,) * (data.dim() - 1))


register("_sparse_retain", _sparse_retain, arg_names=("data", "indices"))
