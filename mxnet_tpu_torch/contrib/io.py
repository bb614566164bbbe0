"""Contrib IO (counterpart of ``mxnet_tpu/contrib/io.py``; reference:
python/mxnet/contrib/io.py): a Gluon ``DataLoader`` as a classic
``DataIter``, so the Module API reads Gluon data pipelines."""
from __future__ import annotations

from ..io.io import DataIter, DataDesc
from .. import ndarray as nd

__all__ = ["DataLoaderIter"]


class DataLoaderIter(DataIter):
    """Batches of a ``gluon.data.DataLoader`` through the DataIter
    protocol (reference: contrib/io.py:30). The last partial batch is
    zero-padded to ``batch_size`` on its own device, and ``pad`` reports
    the filler count, as the C-backed iterators do."""

    def __init__(self, loader, data_name="data",
                 label_name="softmax_label", dtype="float32"):
        self._loader = loader
        self._iter = iter(loader)
        data, label = next(self._iter)
        super().__init__(data.shape[0])
        self.dtype = dtype
        self.provide_data = [DataDesc(data_name, tuple(data.shape), dtype)]
        self.provide_label = [DataDesc(label_name, tuple(label.shape),
                                       dtype)]
        self._current_batch = None
        self.reset()

    def reset(self):
        self._iter = iter(self._loader)

    def iter_next(self):
        self._current_batch = next(self._iter, None)
        return self._current_batch is not None

    def _padded(self, arr):
        arr = arr.astype(self.dtype)
        pad = self.getpad()
        if not pad:
            return [arr]
        full = nd.zeros((self.batch_size,) + tuple(arr.shape[1:]),
                        ctx=arr.context, dtype=self.dtype)
        full[:arr.shape[0]] = arr
        return [full]

    def getdata(self):
        return self._padded(self._current_batch[0])

    def getlabel(self):
        return self._padded(self._current_batch[1])

    def getpad(self):
        return self.batch_size - self._current_batch[0].shape[0]

    def getindex(self):
        return None
