"""Gluon datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``;
parity: python/mxnet/gluon/data/dataset.py): ``Dataset`` with its lazy
``transform``/``filter``/``take``, ``SimpleDataset``, ``ArrayDataset``
and ``RecordFileDataset`` over a ``.rec``/``.idx`` pair, and
``_DownloadedDataset``, the base of the vision datasets that read a
dataset's files under a root."""
from __future__ import annotations

import os
import threading

from ... import ndarray as nd
from ... import recordio

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset",
           "_DownloadedDataset"]


class Dataset:
    """Abstract dataset (reference: dataset.py:31)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([i for i in self if fn(i)])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([i for i in trans])

    def transform_first(self, fn, lazy=True):
        def base_fn(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)
        return self.transform(base_fn, lazy)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Zip of arrays (reference: dataset.py:136)."""

    def __init__(self, *args):
        assert len(args) > 0, "Needs at least 1 arrays"
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                "All arrays must have the same length; array[0] has length "\
                "%d while array[%d] has %d." % (self._length, i, len(data))
            if isinstance(data, nd.NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO file (reference: dataset.py:170). One
    file handle, so a seek and its read happen under a lock: the
    DataLoader's workers are threads."""

    def __init__(self, filename):
        self.idx_file = os.path.splitext(filename)[0] + '.idx'
        self.filename = filename
        self._record = recordio.MXIndexedRecordIO(self.idx_file,
                                                  self.filename, 'r')
        self._lock = threading.Lock()

    def __getitem__(self, idx):
        with self._lock:
            return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)


class _DownloadedDataset(Dataset):
    """A dataset whose ``_get_data`` fills ``_data`` and ``_label`` from
    files under ``root`` (made if missing; nothing is downloaded)."""

    def __init__(self, root, transform):
        super().__init__()
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        os.makedirs(self._root, exist_ok=True)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError
