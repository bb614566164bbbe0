"""Vision datasets (counterpart of
``mxnet_tpu/gluon/data/vision/datasets.py``; parity:
python/mxnet/gluon/data/vision/datasets.py): ``MNIST``,
``FashionMNIST``, ``CIFAR10``, ``CIFAR100``, ``ImageFolderDataset`` and
``ImageRecordDataset``.

They read the standard formats from local files (idx for MNIST and
FashionMNIST, pickled batches for CIFAR, a folder a class, a RecordIO
file) and attempt no download: a missing file raises ``MXNetError``.
Images come back as HWC uint8 NDArrays on ``cpu()``, as the reference
keeps them (a DataLoader's batch moves to the card as a whole), labels as
int32 numpy values.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import warnings

import numpy as np

from .... import ndarray as nd
from .... import recordio
from ....base import MXNetError
from ....context import cpu
from ....image import imdecode, imread
from ..dataset import Dataset, RecordFileDataset, _DownloadedDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "ImageRecordDataset"]


def _read_idx(path):
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rb') as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def _find(root, names):
    for name in names:
        for cand in (name, name + '.gz'):
            p = os.path.join(root, cand)
            if os.path.exists(p):
                return p
    return None


class MNIST(_DownloadedDataset):
    """MNIST from idx files in ``root`` (reference: datasets.py:37)."""

    _train_files = (['train-images-idx3-ubyte'],
                    ['train-labels-idx1-ubyte'])
    _test_files = (['t10k-images-idx3-ubyte'], ['t10k-labels-idx1-ubyte'])

    def __init__(self, root=os.path.join('~', '.mxnet', 'datasets',
                                         'mnist'),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        imgs_names, lbls_names = self._train_files if self._train \
            else self._test_files
        img_path = _find(self._root, imgs_names)
        lbl_path = _find(self._root, lbls_names)
        if img_path is None or lbl_path is None:
            raise MXNetError(
                "%s: dataset files not found under %s (no network egress; "
                "place idx files there)" % (type(self).__name__, self._root))
        data = _read_idx(img_path)
        label = _read_idx(lbl_path)
        self._data = nd.array(data.reshape(len(data), 28, 28, 1),
                              ctx=cpu(), dtype=np.uint8)
        self._label = label.astype(np.int32)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join('~', '.mxnet', 'datasets',
                                         'fashion-mnist'),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from python-pickle batches (reference: datasets.py:126)."""

    _n_classes = 10

    def __init__(self, root=os.path.join('~', '.mxnet', 'datasets',
                                         'cifar10'),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _load_batch(self, path):
        with open(path, 'rb') as f:
            batch = pickle.load(f, encoding='latin1')
        data = batch['data'].reshape(-1, 3, 32, 32)
        label = batch.get('labels', batch.get('fine_labels'))
        return data, np.asarray(label)

    def _get_data(self):
        sub = 'cifar-10-batches-py'
        base = os.path.join(self._root, sub) \
            if os.path.isdir(os.path.join(self._root, sub)) else self._root
        if self._train:
            files = ['data_batch_%d' % i for i in range(1, 6)]
        else:
            files = ['test_batch']
        datas, labels = [], []
        for fn in files:
            p = os.path.join(base, fn)
            if not os.path.exists(p):
                raise MXNetError(
                    "CIFAR10: batch file %s not found (no network egress)"
                    % p)
            d, l = self._load_batch(p)
            datas.append(d)
            labels.append(l)
        data = np.concatenate(datas).transpose(0, 2, 3, 1)
        self._data = nd.array(data, ctx=cpu(), dtype=np.uint8)
        self._label = np.concatenate(labels).astype(np.int32)


class CIFAR100(CIFAR10):
    _n_classes = 100

    def __init__(self, root=os.path.join('~', '.mxnet', 'datasets',
                                         'cifar100'),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _get_data(self):
        sub = 'cifar-100-python'
        base = os.path.join(self._root, sub) \
            if os.path.isdir(os.path.join(self._root, sub)) else self._root
        fn = 'train' if self._train else 'test'
        p = os.path.join(base, fn)
        if not os.path.exists(p):
            raise MXNetError("CIFAR100: file %s not found" % p)
        with open(p, 'rb') as f:
            batch = pickle.load(f, encoding='latin1')
        data = batch['data'].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        key = 'fine_labels' if self._fine_label else 'coarse_labels'
        self._data = nd.array(data, ctx=cpu(), dtype=np.uint8)
        self._label = np.asarray(batch[key]).astype(np.int32)


class ImageFolderDataset(Dataset):
    """folder/label/img.jpg layout (reference: datasets.py:225)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = ['.jpg', '.jpeg', '.png']
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                warnings.warn('Ignoring %s, which is not a directory.'
                              % path, stacklevel=3)
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    warnings.warn(
                        'Ignoring %s of type %s. Only support %s' % (
                            filename, ext, ', '.join(self._exts)))
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        img = imread(self.items[idx][0], self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)


class ImageRecordDataset(Dataset):
    """RecordIO-packed image dataset (reference: datasets.py:274)."""

    def __init__(self, filename, flag=1, transform=None):
        self._record_ds = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __getitem__(self, idx):
        record = self._record_ds[idx]
        header, img_bytes = recordio.unpack(record)
        img = imdecode(img_bytes, self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self._record_ds)
