"""Image IO and augmentation (counterpart of ``mxnet_tpu/image/image.py``;
parity: python/mxnet/image/image.py + src/io/image_aug_default.cc).

Decoding and augmenting run on the host (cv2, else PIL): ``imread`` and
``imdecode`` give ``cpu()`` arrays, as the reference's do, and the
augmenters' constants live there too; a batch's data and its labels each
reach the default context as one transfer in ``next()``, as the
reference's ImageRecordIOParser2 hands its batches over. ``imresize`` is the ``_image_resize`` op's
antialiased bilinear resize (``jax.image.resize``'s), cast back to the
image's dtype by truncation as the JAX package casts it. The augmenters
draw from Python's ``random`` module in the JAX package's order, so
under one ``random.seed`` both packages augment alike.
"""
from __future__ import annotations

import os
import random as pyrandom

import numpy as np
import torch

from ..base import MXNetError
from ..context import cpu
from .. import ndarray as nd
from .. import io as _io
from .. import recordio
from ..ops.extra import resize_hwc

__all__ = ["imread", "imdecode", "imresize", "fixed_crop", "center_crop",
           "random_crop", "resize_short", "color_normalize",
           "CreateAugmenter", "Augmenter", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "CenterCropAug", "HorizontalFlipAug", "CastAug",
           "ColorNormalizeAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "ImageIter"]


def _backend():
    try:
        import cv2
        return "cv2", cv2
    except ImportError:
        pass
    try:
        from PIL import Image
        return "pil", Image
    except ImportError:
        raise MXNetError("image ops require cv2 or PIL; neither is "
                         "available")


def imread(filename, flag=1, to_rgb=True):
    """Read image file → HWC uint8 NDArray (reference: image.py imread)."""
    kind, mod = _backend()
    if kind == "cv2":
        img = mod.imread(filename, mod.IMREAD_COLOR if flag else
                         mod.IMREAD_GRAYSCALE)
        if img is None:
            raise MXNetError("imread failed: %s" % filename)
        if flag and to_rgb:
            img = img[:, :, ::-1]
        if not flag:
            img = img[:, :, None]
    else:
        im = mod.open(filename)
        im = im.convert("RGB" if flag else "L")
        img = np.asarray(im)
        if not flag:
            img = img[:, :, None]
    return nd.array(np.ascontiguousarray(img), ctx=cpu(), dtype=np.uint8)


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode image bytes (reference: src/io/image_io.cc imdecode)."""
    kind, mod = _backend()
    if isinstance(buf, nd.NDArray):
        buf = buf.asnumpy().tobytes()
    if kind == "cv2":
        img = mod.imdecode(np.frombuffer(buf, dtype=np.uint8),
                           mod.IMREAD_COLOR if flag else
                           mod.IMREAD_GRAYSCALE)
        if img is None:
            raise MXNetError("imdecode failed")
        if flag and to_rgb:
            img = img[:, :, ::-1]
        if not flag:
            img = img[:, :, None]
    else:
        import io as _pyio
        im = mod.open(_pyio.BytesIO(buf))
        im = im.convert("RGB" if flag else "L")
        img = np.asarray(im)
        if not flag:
            img = img[:, :, None]
    return nd.array(np.ascontiguousarray(img), ctx=cpu(), dtype=np.uint8)


def imresize(src, w, h, interp=1):
    """``src`` (HWC) resized to ``w`` x ``h``: bilinear and antialiased
    (``interp`` nonzero) or nearest, in float32, then cast back to the
    image's dtype (uint8 for a list)."""
    if isinstance(src, nd.NDArray):
        data, dtype = src._data, src._data.dtype
    else:
        data = torch.from_numpy(np.ascontiguousarray(src))
        dtype = data.dtype if hasattr(src, "dtype") else torch.uint8
    data = data.to(torch.float32)
    if interp:
        out = resize_hwc(data, h, w)
    else:
        # jax.image.resize's nearest, source floor((i + 0.5) * m / n), as
        # XLA compiles it: (i + 0.5) * float32(m * float32(1 / n))
        def rows(m, n):
            step = float(np.float32(m) * np.float32(1.0 / n))
            return torch.floor((torch.arange(n, dtype=torch.float32,
                                             device=data.device) + 0.5)
                               * step).long()
        out = data[rows(data.shape[0], h)][:, rows(data.shape[1], w)]
    return nd.NDArray(out.to(dtype))


def resize_short(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp=1 if interp else 0)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp=1)
    return out


def random_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = size
    x0 = pyrandom.randint(0, max(0, w - new_w))
    y0 = pyrandom.randint(0, max(0, h - new_h))
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[0], src.shape[1]
    new_w, new_h = size
    x0 = max(0, (w - new_w) // 2)
    y0 = max(0, (h - new_h) // 2)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    if mean is not None:
        src = src - mean
    if std is not None:
        src = src / std
    return src


class Augmenter:
    """Base augmenter (reference: image.py:576)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return src.flip(axis=1)
        return src


class CastAug(Augmenter):
    def __init__(self, typ='float32'):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = mean if mean is None or isinstance(mean, nd.NDArray) \
            else nd.array(mean, ctx=cpu())
        self.std = std if std is None or isinstance(std, nd.NDArray) \
            else nd.array(std, ctx=cpu())

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast
        self.coef = nd.array([[[0.299, 0.587, 0.114]]], ctx=cpu())

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        gray = src * self.coef
        gray = (3.0 * (1.0 - alpha) / gray.size) * gray.sum()
        return src * alpha + gray


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation
        self.coef = nd.array([[[0.299, 0.587, 0.114]]], ctx=cpu())

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        gray = src * self.coef
        gray = gray.sum(axis=2, keepdims=True)
        return src * alpha + gray * (1.0 - alpha)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Standard augmenter list (reference: image.py:744)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness:
        auglist.append(BrightnessJitterAug(brightness))
    if contrast:
        auglist.append(ContrastJitterAug(contrast))
    if saturation:
        auglist.append(SaturationJitterAug(saturation))
    if mean is True:
        mean = nd.array([123.68, 116.28, 103.53], ctx=cpu())
    elif mean is not None and not isinstance(mean, nd.NDArray):
        mean = nd.array(mean, ctx=cpu())
    if std is True:
        std = nd.array([58.395, 57.12, 57.375], ctx=cpu())
    elif std is not None and not isinstance(std, nd.NDArray):
        std = nd.array(std, ctx=cpu())
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(_io.DataIter):
    """Image iterator with augmentation over RecordIO or image lists
    (reference: image.py:1050 + src/io/iter_image_recordio_2.cc)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root='.',
                 shuffle=False, aug_list=None, imglist=None,
                 data_name='data', label_name='softmax_label', **kwargs):
        super().__init__(batch_size)
        assert len(data_shape) == 3
        self.data_shape = tuple(data_shape)
        self.batch_size = batch_size
        self.label_width = label_width
        self._shuffle = shuffle
        self._data_name = data_name
        self._label_name = label_name
        self.auglist = aug_list if aug_list is not None \
            else CreateAugmenter(data_shape, **{
                k: v for k, v in kwargs.items()
                if k in ('resize', 'rand_crop', 'rand_resize',
                         'rand_mirror', 'mean', 'std', 'brightness',
                         'contrast', 'saturation', 'hue', 'pca_noise',
                         'rand_gray', 'inter_method')})
        self._rec = None
        self.imglist = None
        if path_imgrec is not None:
            idx_path = os.path.splitext(path_imgrec)[0] + '.idx'
            if os.path.exists(idx_path):
                self._rec = recordio.MXIndexedRecordIO(idx_path,
                                                       path_imgrec, 'r')
                self._keys = list(self._rec.keys)
            else:
                self._rec = recordio.MXRecordIO(path_imgrec, 'r')
                self._keys = None
        elif path_imglist is not None or imglist is not None:
            items = []
            if path_imglist is not None:
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split('\t')
                        label = [float(x) for x in parts[1:-1]]
                        items.append((parts[-1], label))
            else:
                for entry in imglist:
                    items.append((entry[-1], [float(x)
                                              for x in entry[:-1]]))
            self.imglist = items
            self._root = path_root
        else:
            raise MXNetError("ImageIter needs path_imgrec, path_imglist or "
                             "imglist")
        self._order = None
        self.reset()

    @property
    def provide_data(self):
        return [_io.DataDesc(self._data_name,
                             (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [_io.DataDesc(self._label_name, shape)]

    def reset(self):
        self._cursor = 0
        if self.imglist is not None:
            self._order = list(range(len(self.imglist)))
        elif self._keys is not None:
            self._order = list(range(len(self._keys)))
        else:
            self._rec.reset()
            self._order = None
        if self._shuffle and self._order is not None:
            pyrandom.shuffle(self._order)

    def _read_sample(self, i):
        if self.imglist is not None:
            fname, label = self.imglist[self._order[i]]
            img = imread(os.path.join(self._root, fname))
        elif self._keys is not None:
            rec = self._rec.read_idx(self._keys[self._order[i]])
            header, buf = recordio.unpack(rec)
            img = imdecode(buf)
            label = header.label
        else:
            rec = self._rec.read()
            if rec is None:
                raise StopIteration
            header, buf = recordio.unpack(rec)
            img = imdecode(buf)
            label = header.label
        for aug in self.auglist:
            img = aug(img)
        return img, np.asarray(label, dtype=np.float32).reshape(-1)

    def next(self):
        n = len(self._order) if self._order is not None else None
        if n is not None and self._cursor + self.batch_size > n:
            raise StopIteration
        c, h, w = self.data_shape
        batch_data = np.zeros((self.batch_size, c, h, w), dtype=np.float32)
        batch_label = np.zeros((self.batch_size, self.label_width),
                               dtype=np.float32)
        for k in range(self.batch_size):
            img, label = self._read_sample(self._cursor + k)
            arr = img.asnumpy() if isinstance(img, nd.NDArray) else img
            batch_data[k] = np.transpose(arr, (2, 0, 1))
            batch_label[k, :len(label)] = label[:self.label_width]
        self._cursor += self.batch_size
        if self.label_width == 1:
            batch_label = batch_label.reshape(-1)
        return _io.DataBatch(data=[nd.array(batch_data)],
                             label=[nd.array(batch_label)], pad=0)

    def iter_next(self):
        try:
            self._next_cache = self.next()
            return True
        except StopIteration:
            return False
