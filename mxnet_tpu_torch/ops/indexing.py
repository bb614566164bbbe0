"""Indexing operators (counterpart of ``mxnet_tpu/ops/indexing.py``):
``Embedding`` (row lookup, indices clipped into range), ``pick``
(one element per row along an axis, ``clip`` or ``wrap`` indices) and
``gather_nd``."""
from __future__ import annotations

import torch

from .registry import register


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
