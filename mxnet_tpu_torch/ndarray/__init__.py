"""NDArray namespace (``mx.nd``): the array type, its creation and
elementwise functions, one generated function per registered op
(``nd.FullyConnected``, ``nd.topk``, ...; the same stubs in ``nd.op``),
the sampling functions (``nd.random``), ``nd.contrib`` (the
``_contrib_*`` ops by their short names, ``foreach``, ``while_loop`` and
``cond``) and ``nd.sparse`` (csr and row_sparse arrays, with the
sparse-aware ``nd.dot`` and ``nd.cast_storage``)."""
from .ndarray import (NDArray, MeshNDArray, invoke_nd, array, zeros, ones,
                      full, empty, arange, linspace, eye, moveaxis,
                      concatenate, save, load, waitall, add, subtract, multiply, divide, modulo,
                      power, maximum, minimum, hypot, equal, not_equal,
                      greater, greater_equal, lesser, lesser_equal,
                      logical_and, logical_or, logical_xor, true_divide)
from .register import install_ops as _install_ops

_install_ops(globals())

import types as _types  # noqa: E402

op = _types.ModuleType(__name__ + ".op")
_install_ops(op.__dict__)

from . import random  # noqa: E402
from . import contrib  # noqa: E402

from . import sparse  # noqa: E402
from .sparse import (BaseSparseNDArray, CSRNDArray,  # noqa: E402
                     RowSparseNDArray, csr_matrix, row_sparse_array,
                     cast_storage, retain)

# the sparse-aware dot: a csr or row_sparse operand dispatches to the
# gather/scatter lowering (the reference's storage dispatch,
# src/operator/tensor/dot-inl.h)
_dense_dot = globals()["dot"]


def dot(lhs, rhs, transpose_a=False, transpose_b=False, out=None,
        **kwargs):
    if isinstance(lhs, BaseSparseNDArray) \
            or isinstance(rhs, BaseSparseNDArray):
        res = sparse.dot(lhs, rhs, transpose_a=transpose_a,
                         transpose_b=transpose_b)
        if out is not None:
            out._set_data(res._data)
            return out
        return res
    return _dense_dot(lhs, rhs, transpose_a=transpose_a,
                      transpose_b=transpose_b, out=out, **kwargs)


op.dot = dot
