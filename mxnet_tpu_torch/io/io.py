"""Data iterators (counterpart of ``mxnet_tpu/io/io.py``; parity:
python/mxnet/io/io.py + src/io/).

:class:`DataDesc`, :class:`DataBatch`, the :class:`DataIter` protocol,
:class:`NDArrayIter` over in-memory arrays, :class:`ResizeIter`,
:class:`MNISTIter` (idx files), :class:`CSVIter` and
:class:`PrefetchingIter`, a thin wrapper over the async input pipeline
(``io/pipeline.py``). ``shuffle`` draws from numpy's global generator,
as the JAX package's does, so a seeded run sees the same order in both
packages; the last partial batch is padded from the start (``pad``),
rolled over into the next epoch (``roll_over``) or dropped
(``discard``).

The split protocol (``next_raw`` + ``decode_raw``) builds each batch on
the HOST: ``decode_raw`` returns CPU tensors, which the pipeline's
placer copies to the card from pinned memory on its own stream. The
eager ``next()`` is ``decode_raw(next_raw())`` with the batch then put
on the current context, as the JAX package's ``nd_array`` puts it on
the default device.

:class:`LibSVMIter` parses a libsvm file into one scipy CSR matrix on
the host and yields its batches as ``CSRNDArray``s on the current
context (``ndarray/sparse.py``), never densified.
"""
from __future__ import annotations

import gzip
import os
import struct
from collections import namedtuple, OrderedDict

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray.ndarray import _canonical

__all__ = ["DataDesc", "DataBatch", "DataIter", "ResizeIter",
           "PrefetchingIter", "NDArrayIter", "MNISTIter", "CSVIter",
           "LibSVMIter"]


def _data_wait_span():
    """The telemetry ``data_wait`` phase around an iterator fetch (a
    nested span of the same phase counts once)."""
    from .. import telemetry
    return telemetry.span("data_wait")


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name and shape of one input, with its dtype and layout
    (reference: io/io.py:57)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    """One batch of data and labels (reference: io/io.py:146)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), \
                "Data must be list of NDArrays"
        if label is not None:
            assert isinstance(label, (list, tuple)), \
                "Label must be list of NDArrays"
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        label_shapes = [lb.shape for lb in self.label] if self.label \
            else None
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, data_shapes, label_shapes)


def host_array(src):
    """A host (CPU) NDArray of a numpy array with ``nd.array``'s dtype
    rules (float64 becomes float32, int64 int32); no copy when ``src`` is
    already contiguous in that dtype."""
    src = np.ascontiguousarray(src, dtype=_canonical(src.dtype))
    return NDArray(torch.from_numpy(src))


def to_context(batch, ctx=None):
    """``batch`` (a :class:`DataBatch`) with its arrays on ``ctx`` (the
    current context by default): the eager ``next()`` of a split-protocol
    iterator."""
    from ..context import current_context
    device = (ctx or current_context()).torch_device()

    def move(arrays):
        if arrays is None:
            return None
        return [NDArray(a._data.to(device)) if isinstance(a, NDArray)
                else a for a in arrays]
    batch.data = move(batch.data)
    batch.label = move(batch.label)
    return batch


class DataIter:
    """Iterator base (reference: io/io.py:211).

    Iterators that want multi-worker decode under the async input
    pipeline (``io/pipeline.py``) also implement the *split protocol*:
    ``next_raw()``, the cheap serialized part (record IO, cursor math,
    random draws) returning an opaque work item, and
    ``decode_raw(raw)``, the expensive thread-safe part returning the
    finished host :class:`DataBatch`. ``next()`` equals
    ``decode_raw(next_raw())`` put on the current context, so the pooled
    path is bit-identical to the eager one."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        with _data_wait_span():
            if self.iter_next():
                return DataBatch(data=self.getdata(), label=self.getlabel(),
                                 pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


class ResizeIter(DataIter):
    """Resize over/under-sized iterators (reference: io/io.py:299)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class _CombinedSource(DataIter):
    """Several iterators as one source: one ``next()`` pulls a batch
    from every child and concatenates the data and label rosters (the
    first exhausted child ends the epoch)."""

    def __init__(self, iters):
        super().__init__(getattr(iters[0], "batch_size", 0) or 0)
        self.iters = iters

    def next(self):
        batches = [i.next() for i in self.iters]
        return DataBatch(
            data=sum([b.data for b in batches], []),
            label=sum([(b.label or []) for b in batches], []),
            pad=max(b.pad or 0 for b in batches))

    def reset(self):
        for i in self.iters:
            i.reset()

    @property
    def provide_data(self):
        return sum([i.provide_data for i in self.iters], [])

    @property
    def provide_label(self):
        return sum([i.provide_label for i in self.iters], [])


class PrefetchingIter(DataIter):
    """Background prefetcher (the dmlc::ThreadedIter / PrefetcherIter
    role, reference: io/io.py:355 + iter_prefetcher.h), a thin wrapper
    over :class:`~mxnet_tpu_torch.io.pipeline.AsyncInputPipeline`: a
    decode pool of ``num_workers`` (``MXNET_DATA_WORKERS``; order kept),
    an optional ``placement`` (a device, context or per-array callable)
    onto which the placer copies batches ahead of time, ``reset()`` at
    the configured ``prefetch_depth``, and a drain-then-join shutdown
    with stop-aware puts."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2, num_workers=None, placement=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.prefetch_depth = max(1, int(prefetch_depth))
        from .pipeline import AsyncInputPipeline
        source = iters[0] if self.n_iter == 1 else _CombinedSource(iters)
        self._pipeline = AsyncInputPipeline(
            source, num_workers=num_workers,
            prefetch_depth=self.prefetch_depth, placement=placement)

    def _renamed(self, renames, attr):
        if renames is None:
            return sum([getattr(i, attr) for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(r[x[0]], x[1])
                     for x in getattr(i, attr)]
                    for r, i in zip(renames, self.iters)], [])

    @property
    def provide_data(self):
        return self._renamed(self.rename_data, "provide_data")

    @property
    def provide_label(self):
        return self._renamed(self.rename_label, "provide_label")

    def set_placement(self, placement):
        """Place batches on ``placement`` from the next one the placer
        takes (``fit`` sets the bound executor's device)."""
        self._pipeline.set_placement(placement)

    def reset(self):
        self._pipeline.reset()

    def close(self):
        pipeline = getattr(self, "_pipeline", None)
        if pipeline is not None:
            pipeline.close()

    def __del__(self):
        try:
            self.close()
        except Exception:       # interpreter teardown
            pass

    def next(self):
        # the pipeline opens a data_wait span only when its queue is dry
        return self._pipeline.next()

    def iter_next(self):
        return self._pipeline.iter_next()

    def getdata(self):
        return self._pipeline.getdata()

    def getlabel(self):
        return self._pipeline.getlabel()

    def getpad(self):
        return self._pipeline.getpad()

    def getindex(self):
        return self._pipeline.getindex()


def _as_host_view(v):
    """A host numpy view of one source array: numpy passes through
    ``np.asarray`` (no copy) and a CPU NDArray is viewed through its
    tensor (no copy; the iterator only gathers from it). An NDArray on
    the card is copied to the host once."""
    if isinstance(v, NDArray):
        t = v._data.detach()
        return t.numpy() if t.device.type == "cpu" else v.asnumpy()
    return np.asarray(v)


def _init_data(data, allow_empty, default_name):
    """``[(name, host numpy array)]`` from an array, a list of them or a
    dict (reference: io/utils.py)."""
    assert (data is not None) or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = OrderedDict([(default_name, data[0])])
        else:
            data = OrderedDict([("_%d_%s" % (i, default_name), d)
                                for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    for k, v in data.items():
        if not isinstance(v, (np.ndarray, NDArray)):
            raise TypeError("Invalid type '%s' for %s, should be NDArray or "
                            "numpy.ndarray" % (type(v), k))
    return [(k, _as_host_view(v)) for k, v in data.items()]


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference: io/io.py:490)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = np.arange(self.data[0][1].shape[0])
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self.num_data = self.idx.shape[0]
        if last_batch_handle == "discard":
            self.num_data = (self.num_data // batch_size) * batch_size
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                -self.batch_size < self.cursor < 0:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) \
                % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        with _data_wait_span():
            return to_context(self.decode_raw(self.next_raw()))

    # -- split protocol (async pipeline, io/pipeline.py) -----------------
    def next_raw(self):
        """Serialized half: advance the cursor and hand the gather
        position to a decode worker."""
        if not self.iter_next():
            raise StopIteration
        return (self.cursor, self._pad_at(self.cursor))

    def decode_raw(self, raw):
        """Parallel half: gather the batch at an explicit cursor into
        host tensors (pure reads of the source arrays and the epoch's
        order, safe across decode workers)."""
        cursor, pad = raw
        return DataBatch(data=self._getdata(self.data, cursor),
                         label=self._getdata(self.label, cursor),
                         pad=pad, index=None)

    def _getdata(self, data_source, cursor=None):
        cursor = self.cursor if cursor is None else cursor
        end = min(cursor + self.batch_size, self.num_data)
        s = slice(cursor, end)
        out = []
        for _, src in data_source:
            chunk = src[self.idx[s]]
            if chunk.shape[0] < self.batch_size \
                    and self.last_batch_handle == "pad":
                pad = self.batch_size - chunk.shape[0]
                chunk = np.concatenate([chunk, src[self.idx[:pad]]], axis=0)
            out.append(host_array(chunk))
        return out

    def getdata(self):
        return to_context(DataBatch(self._getdata(self.data))).data

    def getlabel(self):
        return to_context(DataBatch(self._getdata(self.label))).data

    def _pad_at(self, cursor):
        if self.last_batch_handle == "pad" and \
                cursor + self.batch_size > self.num_data:
            return cursor + self.batch_size - self.num_data
        return 0

    def getpad(self):
        return self._pad_at(self.cursor)


def _read_idx_file(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(dims)


class MNISTIter(DataIter):
    """MNIST idx-format iterator (reference: src/io/iter_mnist.cc).

    Reads standard idx(.gz) files. ``flat`` yields (batch, 784);
    otherwise (batch, 1, 28, 28). Pixels scaled to [0, 1) as the
    reference's iter_mnist.cc normalizes them."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 input_shape=None, **kwargs):
        super().__init__(batch_size)
        for p in (image, label):
            if not os.path.exists(p) and not os.path.exists(p + ".gz"):
                raise MXNetError("MNISTIter: file not found: %s" % p)
        image = image if os.path.exists(image) else image + ".gz"
        label = label if os.path.exists(label) else label + ".gz"
        self._images = _read_idx_file(image).astype(np.float32) / 256.0
        self._labels = _read_idx_file(label).astype(np.float32)
        if flat:
            self._images = self._images.reshape(len(self._images), -1)
        else:
            self._images = self._images.reshape(len(self._images), 1,
                                                *self._images.shape[1:])
        self._shuffle = shuffle
        self._seed = seed
        self._inner = NDArrayIter(self._images, self._labels, batch_size,
                                  shuffle=shuffle,
                                  last_batch_handle="discard")

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


class CSVIter(DataIter):
    """CSV iterator (reference: src/io/iter_csv.cc)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32,
                          ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
        else:
            label = np.zeros((data.shape[0],), dtype=np.float32)
        self._inner = NDArrayIter(
            data, label, batch_size,
            last_batch_handle="roll_over" if round_batch else "discard")
        self._inner.label = [("label", self._inner.label[0][1])]

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return [DataDesc("label", d.shape, d.dtype)
                for d in self._inner.provide_label]

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


class LibSVMIter(DataIter):
    """LibSVM-format iterator (reference: src/io/iter_libsvm.cc).

    Parses ``label idx:val ...`` lines into ONE scipy CSR matrix and
    yields CSRNDArray batches by slicing it: the sparse structure is
    never densified (the reference's iterator likewise stays CSR end to
    end). ``round_batch=True`` wraps the final short batch around to the
    beginning, as the reference's ``round_batch``; otherwise it is
    padded with row 0 and ``pad`` says how many rows. ``label_libsvm``
    reads the labels from a second libsvm file (dense, of
    ``label_shape``)."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=None, batch_size=1, round_batch=True,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        import scipy.sparse as spsp
        feat_dim = int(np.prod(data_shape))

        def parse(fname, dim):
            vals, cols, indptr, heads = [], [], [0], []
            with open(fname) as f:
                for line in f:
                    parts = line.strip().split()
                    if not parts:
                        continue
                    heads.append(float(parts[0]))
                    for tok in parts[1:]:
                        i, v = tok.split(":")
                        cols.append(int(i))
                        vals.append(float(v))
                    indptr.append(len(cols))
            m = spsp.csr_matrix(
                (np.asarray(vals, np.float32), np.asarray(cols, np.int64),
                 np.asarray(indptr, np.int64)),
                shape=(len(indptr) - 1, dim))
            return m, np.asarray(heads, np.float32)

        self._csr, label = parse(data_libsvm, feat_dim)
        if label_libsvm is not None:
            lmat, _ = parse(label_libsvm, int(np.prod(label_shape)))
            label = lmat.toarray()
        self._label = label
        self._num = self._csr.shape[0]
        self._round = round_batch
        self._cursor = 0
        self._data_shape = tuple(data_shape)
        self._data_name = data_name
        self._label_name = label_name

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self._data_shape)]

    @property
    def provide_label(self):
        return [DataDesc(self._label_name,
                         (self.batch_size,) + self._label.shape[1:])]

    def reset(self):
        self._cursor = 0

    def iter_next(self):
        return self._cursor < self._num

    def next(self):
        if not self.iter_next():
            raise StopIteration
        from ..context import current_context
        from ..ndarray import sparse as _sp
        start = self._cursor
        stop = start + self.batch_size
        self._cursor = stop
        pad = 0
        if stop <= self._num:
            idx = np.arange(start, stop)
        elif self._round:
            idx = np.arange(start, stop) % self._num
        else:
            pad = stop - self._num
            idx = np.concatenate([np.arange(start, self._num),
                                  np.zeros(pad, np.int64)])
        ctx = current_context()
        data = _sp.csr_matrix(self._csr[idx], ctx=ctx)
        label = NDArray(host_array(self._label[idx])._data.to(
            ctx.torch_device()))
        return DataBatch(data=[data], label=[label], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
