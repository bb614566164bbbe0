"""``cast_storage``'s registered op (counterpart of the op in
``mxnet_tpu/ops/deformable.py``; the module's deformable and proposal
ops come with ROADMAP queue A's order step 8).

A graph carries every array dense, so the body is the identity on
values; the storage type is honoured at the NDArray layer
(``nd.cast_storage`` and ``NDArray.tostype``, ``ndarray/sparse.py``),
where sparse arrays exist."""
from __future__ import annotations

from ..base import MXNetError
from .registry import register


def _cast_storage(attrs, data):
    stype = attrs.get("stype", "default")
    if stype not in ("default", "row_sparse", "csr"):
        raise MXNetError("cast_storage: unknown stype %r" % (stype,))
    return data.clone()


register("cast_storage", _cast_storage, arg_names=("data",),
         defaults={"stype": "default"},
         attr_docs={"stype": "target storage type: default | "
                             "row_sparse | csr"})
