"""Data iterators (counterpart of ``mxnet_tpu/io/io.py``):
:class:`DataDesc`, :class:`DataBatch`, the :class:`DataIter` protocol
and :class:`NDArrayIter`, which batches in-memory arrays on the host and
puts each batch on the current context. ``shuffle`` draws from numpy's
global generator, as the JAX package's does, so a seeded run sees the
same order in both packages; the last partial batch is padded from the
start (``pad``), rolled over into the next epoch (``roll_over``) or
dropped (``discard``).
"""
from __future__ import annotations

from collections import namedtuple, OrderedDict

import numpy as np

from ..ndarray import NDArray, array as nd_array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter"]


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


class DataIter:
    """Iterator base (reference: io/io.py:211)."""

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
    return [(k, v.asnumpy() if isinstance(v, NDArray) else np.asarray(v))
            for k, v in data.items()]


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
            if not self.iter_next():
                raise StopIteration
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)

    def _getdata(self, data_source):
        end = min(self.cursor + self.batch_size, self.num_data)
        s = slice(self.cursor, end)
        out = []
        for _, src in data_source:
            chunk = src[self.idx[s]]
            if chunk.shape[0] < self.batch_size \
                    and self.last_batch_handle == "pad":
                pad = self.batch_size - chunk.shape[0]
                chunk = np.concatenate([chunk, src[self.idx[:pad]]], axis=0)
            out.append(nd_array(chunk))
        return out

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0
