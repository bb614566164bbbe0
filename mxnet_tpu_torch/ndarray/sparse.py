"""Sparse NDArrays: ``csr`` and ``row_sparse`` storage (counterpart of
``mxnet_tpu/ndarray/sparse.py``; parity: python/mxnet/ndarray/sparse.py
and src/operator/tensor/cast_storage-inl.h).

A sparse array is a set of dense tensors on one device (its values and
integer aux arrays, each held by an NDArray) plus a logical dense shape,
as in the JAX package. Compute lowers to gathers and scatters on those
tensors:

- ``dot(csr, dense)``          → ``index_select`` of the rhs rows named
                                 by the column ids, ``index_add_`` over
                                 the row ids;
- ``dot(csr, dense, trans_a)`` → the same with rows and columns swapped;
- ``cast_storage``             → a scatter (to dense) or a scan on the
                                 device (to sparse: ``torch.nonzero``,
                                 one host sync for the data-dependent
                                 count);
- ``retain``                   → a gather of the kept rows;
- the optimizers' lazy update  → gather rows, update, scatter
                                 (``optimizer/optimizer.py``).

Where the JAX package reads a row set on the host (a csr slice's
``indptr``, the pattern union of ``csr + csr`` or of two row_sparse
arrays) the port does the same: it is the reference's own sync. Values
are always computed on the arrays' device.

Aux arrays are int32, which is what the JAX package's arrays hold on the
CPU (its aux dtypes go through ``canonical_dtype``), although
``_aux_types`` reports int64 as the JAX package does. Nothing here is
recorded by autograd: like the JAX package's, a sparse result is a new
array outside the tape.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, current_context
from .ndarray import NDArray, _canonical, array as _dense_array

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "csr_matrix", "row_sparse_array", "cast_storage", "retain",
           "dot", "zeros", "empty", "array", "add", "subtract", "multiply",
           "divide"]

_INDEX = torch.int32


def _index_nd(ids, ctx):
    """An int32 NDArray of ``ids`` (host values or a tensor) on ``ctx``."""
    if isinstance(ids, NDArray):
        ids = ids._data
    if isinstance(ids, torch.Tensor):
        t = ids.detach()
    else:
        t = torch.from_numpy(np.asarray(ids, np.int64).reshape(-1))
    return NDArray(t.to(device=ctx.torch_device(), dtype=_INDEX))


def _long(nd):
    """The tensor of an index NDArray, as int64 for torch's index ops."""
    return nd._data.detach().to(torch.long)


def _moved(nd, ctx):
    """A copy of a component NDArray on ``ctx``."""
    return NDArray(nd._data.detach().to(ctx.torch_device(), copy=True))


class BaseSparseNDArray(NDArray):
    """Common behaviour of csr and row_sparse arrays.

    ``_data`` (the dense buffer) raises: a code path that reaches for it
    must handle sparse storage explicitly (the reference raises
    NotSupportedForSparseNDArray the same way)."""

    def __init__(self, shape, ctx=None):
        self._shape = tuple(int(s) for s in shape)
        self._ctx = ctx if ctx is not None else current_context()
        self.grad = None
        self._grad_req = "null"
        self._fresh_grad = False

    @property
    def _data(self):
        raise MXNetError(
            "%s has no dense buffer; use .data/.indices (and .indptr) "
            "or tostype('default')" % type(self).__name__)

    @property
    def shape(self):
        return self._shape

    @property
    def size(self):
        return int(np.prod(self._shape, dtype=np.int64))

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def context(self):
        return self._ctx

    ctx = context

    def __repr__(self):
        return "\n<%s %s @%s>" % (type(self).__name__,
                                  "x".join(str(s) for s in self._shape),
                                  self._ctx)

    def __len__(self):
        return self._shape[0]

    # -- the dense API that sparse storage does not support --------------
    def _not_supported(self, what):
        raise MXNetError("%s is not supported for %s"
                         % (what, type(self).__name__))

    def reshape(self, *shape, **kwargs):
        self._not_supported("reshape")

    def _at(self, idx):
        self._not_supported("_at")

    def _slice(self, start, stop):
        self._not_supported("_slice")

    # -- host transfer and copies ------------------------------------------
    def asnumpy(self):
        return self._dense_np()

    def wait_to_read(self):
        self.data.wait_to_read()

    def copyto(self, other):
        if isinstance(other, Context):
            return self._clone(ctx=other)
        if isinstance(other, BaseSparseNDArray):
            if other.stype != self.stype:
                raise MXNetError("copyto: storage type mismatch (%s vs %s)"
                                 % (self.stype, other.stype))
            other._assign_from(self)
            return other
        if isinstance(other, NDArray):
            return self.tostype("default").copyto(other)
        raise TypeError("copyto does not support type %s" % type(other))

    def copy(self):
        return self._clone()

    def astype(self, dtype, copy=True):
        c = self._clone()
        c._sp_data = c._sp_data.astype(dtype)
        return c

    def as_in_context(self, context):
        if context == self._ctx:
            return self
        return self._clone(ctx=context)

    as_in_ctx = as_in_context

    def check_format(self, full_check=True):
        self._check_format()

    # -- arithmetic: scalar ops keep the storage, the rest densify ---------
    def _scalar_sparsity_op(self, other, fn):
        if isinstance(other, (int, float)):
            c = self._clone()
            c._sp_data = fn(c._sp_data, other)
            return c
        return None

    def __mul__(self, other):
        r = self._scalar_sparsity_op(other, lambda d, s: d * s)
        if r is not None:
            return r
        return _densify_binop(self, other, lambda a, b: a * b)

    __rmul__ = __mul__

    def __div__(self, other):
        return self.__truediv__(other)

    def __truediv__(self, other):
        r = self._scalar_sparsity_op(other, lambda d, s: d / s)
        if r is not None:
            return r
        return _densify_binop(self, other, lambda a, b: a / b)

    def __add__(self, other):
        same = self._same_structure_op(other, lambda a, b: a + b)
        if same is not None:
            return same
        return _densify_binop(self, other, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, other):
        same = self._same_structure_op(other, lambda a, b: a - b)
        if same is not None:
            return same
        return _densify_binop(self, other, lambda a, b: a - b)

    def __neg__(self):
        c = self._clone()
        c._sp_data = -c._sp_data
        return c

    def _same_structure_op(self, other, fn):
        return None


def _densify_binop(lhs, rhs, fn):
    a = lhs.tostype("default") if isinstance(lhs, BaseSparseNDArray) else lhs
    b = rhs.tostype("default") if isinstance(rhs, BaseSparseNDArray) else rhs
    return fn(a, b)


def _merge_on_union(a_pos, a_data, b_pos, b_data, n, fn):
    """``fn`` of two value blocks scattered onto ``n`` union slots (host
    positions ``a_pos``/``b_pos``); the scatters run on the device."""
    dev = a_data._data.device
    shape = (n,) + tuple(a_data.shape[1:])
    with torch.no_grad():
        a = torch.zeros(shape, dtype=a_data._data.dtype, device=dev)
        b = torch.zeros(shape, dtype=b_data._data.dtype, device=dev)
        a.index_copy_(0, torch.as_tensor(a_pos, device=dev), a_data._data)
        b.index_copy_(0, torch.as_tensor(b_pos, device=dev), b_data._data)
    return fn(NDArray(a), NDArray(b))


class CSRNDArray(BaseSparseNDArray):
    """Compressed sparse row matrix (reference: sparse.py:287)."""

    def __init__(self, data, indices, indptr, shape, ctx=None):
        super().__init__(shape, ctx)
        if len(self._shape) != 2:
            raise MXNetError("csr requires a 2-D shape, got %s"
                             % (self._shape,))
        self._sp_data = data
        self._sp_indices = indices
        self._sp_indptr = indptr

    @property
    def stype(self):
        return "csr"

    @property
    def data(self):
        return self._sp_data

    @property
    def indices(self):
        return self._sp_indices

    @property
    def indptr(self):
        return self._sp_indptr

    @property
    def _aux_types(self):
        return [np.dtype(np.int64), np.dtype(np.int64)]

    def _clone(self, ctx=None):
        if ctx is None or ctx == self._ctx:
            return CSRNDArray(self._sp_data.copy(), self._sp_indices.copy(),
                              self._sp_indptr.copy(), self._shape,
                              ctx=self._ctx)
        return CSRNDArray(_moved(self._sp_data, ctx),
                          _moved(self._sp_indices, ctx),
                          _moved(self._sp_indptr, ctx), self._shape, ctx=ctx)

    def _assign_from(self, other):
        self._sp_data = other._sp_data.copy()
        self._sp_indices = other._sp_indices.copy()
        self._sp_indptr = other._sp_indptr.copy()
        self._shape = other._shape

    def _check_format(self):
        indptr = self._sp_indptr.asnumpy()
        indices = self._sp_indices.asnumpy()
        if indptr.shape != (self._shape[0] + 1,):
            raise MXNetError("csr indptr length %s != rows+1" %
                             (indptr.shape,))
        if indptr[0] != 0 or indptr[-1] != indices.shape[0]:
            raise MXNetError("csr indptr endpoints invalid")
        if (np.diff(indptr) < 0).any():
            raise MXNetError("csr indptr must be non-decreasing")
        if indices.size and (indices.min() < 0
                             or indices.max() >= self._shape[1]):
            raise MXNetError("csr indices out of bounds")

    def _dense_np(self):
        out = np.zeros(self._shape, dtype=self._sp_data.dtype)
        out[self._row_ids(), self._sp_indices.asnumpy()] = \
            self._sp_data.asnumpy()
        return out

    def _row_ids(self):
        """Each stored value's row, on the host (from ``indptr``)."""
        indptr = self._sp_indptr.asnumpy()
        return np.repeat(np.arange(self._shape[0]), np.diff(indptr))

    def _row_ids_t(self):
        """Each stored value's row as an int64 tensor on the device,
        expanded from ``indptr`` there (the count is the values' length:
        no host sync)."""
        indptr = _long(self._sp_indptr)
        return torch.repeat_interleave(
            torch.arange(self._shape[0], device=indptr.device),
            indptr[1:] - indptr[:-1], output_size=self._sp_data.shape[0])

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            data = self._sp_data._data.detach()
            with torch.no_grad():
                dense = torch.zeros(self._shape, dtype=data.dtype,
                                    device=data.device)
                dense.index_put_((self._row_ids_t(),
                                  _long(self._sp_indices)), data)
            return NDArray(dense)
        raise MXNetError("cast_storage from csr to %s is not supported"
                         % stype)

    def asscipy(self):
        import scipy.sparse as spsp
        return spsp.csr_matrix(
            (self._sp_data.asnumpy(), self._sp_indices.asnumpy(),
             self._sp_indptr.asnumpy()), shape=self._shape)

    def _same_structure_op(self, other, fn):
        # csr (+) csr keeps csr storage (the reference's elemwise_add(csr,
        # csr) returns csr): the pattern union from the index arrays on
        # the host, the values merged on the device
        if not (isinstance(other, CSRNDArray)
                and other._shape == self._shape):
            return None
        ncols = self._shape[1]
        a_keys = self._row_ids().astype(np.int64) * ncols \
            + self._sp_indices.asnumpy().astype(np.int64)
        b_keys = other._row_ids().astype(np.int64) * ncols \
            + other._sp_indices.asnumpy().astype(np.int64)
        union = np.union1d(a_keys, b_keys)
        out_data = _merge_on_union(
            np.searchsorted(union, a_keys), self._sp_data,
            np.searchsorted(union, b_keys), other._sp_data, len(union), fn)
        counts = np.bincount(union // ncols, minlength=self._shape[0])
        indptr = np.concatenate([[0], np.cumsum(counts)])
        return CSRNDArray(out_data, _index_nd(union % ncols, self._ctx),
                          _index_nd(indptr, self._ctx), self._shape,
                          ctx=self._ctx)

    def __getitem__(self, key):
        if isinstance(key, int):
            n = self._shape[0]
            if key < 0:
                key += n
            if not 0 <= key < n:
                raise IndexError("index %d out of bounds for %d rows"
                                 % (key, n))
            return self[key:key + 1]
        if isinstance(key, slice):
            start, stop, step = key.indices(self._shape[0])
            if step != 1:
                raise MXNetError("csr slicing supports step=1 only")
            stop = max(stop, start)
            indptr = self._sp_indptr.asnumpy().astype(np.int64)
            lo, hi = int(indptr[start]), int(indptr[stop])
            return CSRNDArray(
                NDArray(self._sp_data._data[lo:hi]),
                NDArray(self._sp_indices._data[lo:hi]),
                _index_nd(indptr[start:stop + 1] - lo, self._ctx),
                (stop - start, self._shape[1]), ctx=self._ctx)
        raise MXNetError("csr indexing supports int/slice only")


class RowSparseNDArray(BaseSparseNDArray):
    """Row-sparse array: a subset of rows is stored (reference:
    sparse.py:561); ``data.shape = (stored rows,) + shape[1:]``."""

    def __init__(self, data, indices, shape, ctx=None):
        super().__init__(shape, ctx)
        self._sp_data = data
        self._sp_indices = indices

    @property
    def stype(self):
        return "row_sparse"

    @property
    def data(self):
        return self._sp_data

    @property
    def indices(self):
        return self._sp_indices

    @property
    def _aux_types(self):
        return [np.dtype(np.int64)]

    def _clone(self, ctx=None):
        if ctx is None or ctx == self._ctx:
            return RowSparseNDArray(self._sp_data.copy(),
                                    self._sp_indices.copy(), self._shape,
                                    ctx=self._ctx)
        return RowSparseNDArray(_moved(self._sp_data, ctx),
                                _moved(self._sp_indices, ctx), self._shape,
                                ctx=ctx)

    def _assign_from(self, other):
        self._sp_data = other._sp_data.copy()
        self._sp_indices = other._sp_indices.copy()
        self._shape = other._shape

    def _check_format(self):
        idx = self._sp_indices.asnumpy()
        if (np.diff(idx) <= 0).any():
            raise MXNetError("row_sparse indices must be strictly "
                             "increasing")
        if idx.size and (idx.min() < 0 or idx.max() >= self._shape[0]):
            raise MXNetError("row_sparse indices out of bounds")
        if tuple(self._sp_data.shape[1:]) != self._shape[1:]:
            raise MXNetError("row_sparse data row shape mismatch")

    def _dense_np(self):
        out = np.zeros(self._shape, dtype=self._sp_data.dtype)
        out[self._sp_indices.asnumpy()] = self._sp_data.asnumpy()
        return out

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype == "default":
            data = self._sp_data._data.detach()
            with torch.no_grad():
                dense = torch.zeros(self._shape, dtype=data.dtype,
                                    device=data.device)
                dense.index_copy_(0, _long(self._sp_indices), data)
            return NDArray(dense)
        raise MXNetError("cast_storage from row_sparse to %s is not "
                         "supported" % stype)

    def retain(self, indices):
        return retain(self, indices)

    def __getitem__(self, key):
        if isinstance(key, slice):
            if key.start or key.step or (key.stop is not None
                                         and key.stop != self._shape[0]):
                raise MXNetError("row_sparse supports [:] slicing only")
            return self
        raise MXNetError("row_sparse indexing supports [:] only")

    def _same_structure_op(self, other, fn):
        if not (isinstance(other, RowSparseNDArray)
                and other._shape == self._shape):
            return None
        a_idx = self._sp_indices.asnumpy()
        b_idx = other._sp_indices.asnumpy()
        if a_idx.shape == b_idx.shape and (a_idx == b_idx).all():
            c = self._clone()
            c._sp_data = fn(self._sp_data, other._sp_data)
            return c
        union = np.union1d(a_idx, b_idx)
        return RowSparseNDArray(
            _merge_on_union(np.searchsorted(union, a_idx), self._sp_data,
                            np.searchsorted(union, b_idx), other._sp_data,
                            len(union), fn),
            _index_nd(union, self._ctx), self._shape, ctx=self._ctx)


# -- constructors (parity: sparse.py:825, 1020) ------------------------------

def _as_nd(x, dtype, ctx):
    """Values as an NDArray on ``ctx``, in the JAX package's canonical
    dtype (float64 → float32)."""
    if isinstance(x, NDArray):
        if dtype is not None and x.dtype != _canonical(dtype):
            return x.astype(_canonical(dtype))
        return x
    src = np.asarray(x, dtype=dtype)
    return _dense_array(src, ctx=ctx, dtype=_canonical(src.dtype))


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)``, ``(data, (row,
    col))``, an ``(M, N)`` shape (empty), a dense array or NDArray, a
    scipy.sparse matrix or another CSRNDArray."""
    ctx = ctx or current_context()
    try:
        import scipy.sparse as spsp
    except ImportError:
        spsp = None
    if isinstance(arg1, CSRNDArray):
        return arg1._clone(ctx=ctx)
    if spsp is not None and spsp.issparse(arg1):
        m = arg1.tocsr()
        return CSRNDArray(_as_nd(m.data, dtype or m.dtype, ctx),
                          _index_nd(m.indices, ctx), _index_nd(m.indptr, ctx),
                          m.shape, ctx=ctx)
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        if shape is None:
            ind = np.asarray(indices)
            shape = (len(np.asarray(indptr)) - 1,
                     int(ind.max()) + 1 if ind.size else 0)
        return CSRNDArray(_as_nd(data, dtype, ctx), _index_nd(indices, ctx),
                          _index_nd(indptr, ctx), shape, ctx=ctx)
    if isinstance(arg1, tuple) and len(arg1) == 2:
        if isinstance(arg1[0], int):
            return zeros("csr", arg1, ctx=ctx, dtype=dtype)
        # (data, (row, col)): COO form
        data, (row, col) = arg1
        m = spsp.csr_matrix((np.asarray(data),
                             (np.asarray(row), np.asarray(col))), shape=shape)
        return csr_matrix(m, ctx=ctx, dtype=dtype)
    src = arg1.asnumpy() if isinstance(arg1, NDArray) else \
        np.asarray(arg1, dtype=dtype)
    return cast_storage(_dense_array(src, ctx=ctx), "csr")


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)``, a shape (empty), a
    dense source or another RowSparseNDArray."""
    ctx = ctx or current_context()
    if isinstance(arg1, RowSparseNDArray):
        return arg1._clone(ctx=ctx)
    if isinstance(arg1, tuple) and len(arg1) == 2 \
            and not np.isscalar(arg1[0]):
        arr0 = arg1[0] if isinstance(arg1[0], NDArray) \
            else np.asarray(arg1[0])
        if getattr(arr0, "ndim", 0) >= 1:
            data, indices = arg1
            data_nd = _as_nd(data, dtype, ctx)
            idx_nd = _index_nd(indices, ctx)
            if shape is None:
                ids = idx_nd.asnumpy()
                shape = ((int(ids.max()) + 1 if ids.size else 0),) + \
                    tuple(data_nd.shape[1:])
            return RowSparseNDArray(data_nd, idx_nd, shape, ctx=ctx)
    if isinstance(arg1, tuple):
        return zeros("row_sparse", arg1, ctx=ctx, dtype=dtype)
    src = arg1.asnumpy() if isinstance(arg1, NDArray) else \
        np.asarray(arg1, dtype=dtype)
    return cast_storage(_dense_array(src, ctx=ctx), "row_sparse")


def zeros(stype, shape, ctx=None, dtype=None, **kwargs):
    """An all-zero array of storage ``stype`` (reference:
    sparse.py:1507)."""
    ctx = ctx or current_context()
    dtype = dtype or np.float32
    if stype == "default":
        from .ndarray import zeros as _dense_zeros
        return _dense_zeros(shape, ctx=ctx, dtype=dtype)
    if stype == "csr":
        return CSRNDArray(_dense_array(np.zeros((0,), dtype), ctx=ctx,
                                       dtype=dtype),
                          _index_nd([], ctx),
                          _index_nd(np.zeros(shape[0] + 1), ctx),
                          shape, ctx=ctx)
    if stype == "row_sparse":
        return RowSparseNDArray(
            _dense_array(np.zeros((0,) + tuple(shape[1:]), dtype), ctx=ctx,
                         dtype=dtype), _index_nd([], ctx), shape, ctx=ctx)
    raise MXNetError("unknown storage type %s" % stype)


def empty(stype, shape, ctx=None, dtype=None):
    return zeros(stype, shape, ctx=ctx, dtype=dtype)


def array(source_array, ctx=None, dtype=None):
    """The sparse-aware ``array`` (reference: sparse.py:1579): a sparse
    NDArray is copied, a scipy.sparse matrix becomes a CSRNDArray."""
    import scipy.sparse as spsp
    if isinstance(source_array, BaseSparseNDArray):
        return source_array._clone(ctx=ctx or source_array.context)
    if spsp.issparse(source_array):
        return csr_matrix(source_array, ctx=ctx, dtype=dtype)
    raise ValueError("Unexpected source_array type: use mx.nd.array for "
                     "dense sources")


# -- storage casts (parity: cast_storage-inl.h) -------------------------------

def cast_storage(arr, stype):
    """Convert between storage types. Dense to sparse scans for the
    non-zeros on the device (``torch.nonzero``: the count is
    data-dependent, so the conversion syncs the host once, as the
    reference's kernel walks the array)."""
    if isinstance(arr, BaseSparseNDArray) or stype == "default":
        return arr.tostype(stype)
    if not isinstance(arr, NDArray):
        raise TypeError("cast_storage expects an NDArray")
    g = arr._data.detach()
    ctx = arr.context
    if stype == "row_sparse":
        with torch.no_grad():
            mask = g.reshape(g.shape[0], -1).ne(0).any(1) if g.dim() > 1 \
                else g.ne(0)
            rows = torch.nonzero(mask).squeeze(1)
            data = g.index_select(0, rows)
        return RowSparseNDArray(NDArray(data), _index_nd(rows, ctx),
                                arr.shape, ctx=ctx)
    if stype == "csr":
        if g.dim() != 2:
            raise MXNetError("csr requires 2-D input")
        with torch.no_grad():
            nz = torch.nonzero(g)
            rows, cols = nz[:, 0], nz[:, 1]
            indptr = torch.searchsorted(
                rows, torch.arange(g.shape[0] + 1, device=g.device))
            data = g[rows, cols]
        return CSRNDArray(NDArray(data), _index_nd(cols, ctx),
                          _index_nd(indptr, ctx), arr.shape, ctx=ctx)
    raise MXNetError("unknown storage type %s" % stype)


def retain(rsp, indices):
    """The stored rows of ``rsp`` that ``indices`` names, in the order
    named (reference: the _retain op): a gather on the device."""
    if not isinstance(rsp, RowSparseNDArray):
        raise MXNetError("retain expects a RowSparseNDArray")
    have = _long(rsp.indices)
    if isinstance(indices, NDArray):
        want = _long(indices).reshape(-1).to(have.device)
    else:
        want = torch.as_tensor(np.asarray(indices, np.int64).reshape(-1),
                               device=have.device)
    with torch.no_grad():
        kept = want[torch.isin(want, have)]
        data = rsp.data._data.detach().index_select(
            0, torch.searchsorted(have, kept))
    return RowSparseNDArray(NDArray(data), _index_nd(kept, rsp.context),
                            rsp.shape, ctx=rsp.context)


# -- sparse dot (parity: src/operator/tensor/dot-inl.h) -----------------------

def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot: csr x dense gathers the rhs rows each stored
    value needs and sums them into their output rows with ``index_add_``
    (a 1-D rhs is matrix-vector); every other combination densifies."""
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, NDArray) \
            and not isinstance(rhs, BaseSparseNDArray) and not transpose_b:
        data = lhs.data._data.detach()
        cols = _long(lhs.indices)
        rows = lhs._row_ids_t()
        b = rhs._data.detach()
        src, dst, n_out = (cols, rows, lhs.shape[0]) if not transpose_a \
            else (rows, cols, lhs.shape[1])
        with torch.no_grad():
            taken = b.index_select(0, src)
            contrib = data * taken if b.dim() == 1 \
                else data[:, None] * taken
            out = torch.zeros((n_out,) + tuple(b.shape[1:]),
                              dtype=contrib.dtype, device=b.device)
            out.index_add_(0, dst, contrib)
        return NDArray(out)
    a = lhs.tostype("default") if isinstance(lhs, BaseSparseNDArray) else lhs
    b = rhs.tostype("default") if isinstance(rhs, BaseSparseNDArray) else rhs
    return a.dot(b, transpose_a=transpose_a, transpose_b=transpose_b)


# -- elementwise wrappers (parity: sparse.py:1193-1504) -----------------------

def add(lhs, rhs):
    return lhs + rhs


def subtract(lhs, rhs):
    return lhs - rhs


def multiply(lhs, rhs):
    return lhs * rhs


def divide(lhs, rhs):
    return lhs / rhs
