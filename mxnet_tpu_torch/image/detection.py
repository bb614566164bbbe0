"""The detection image pipeline (counterpart of
``mxnet_tpu/image/detection.py``; parity: python/mxnet/image/
detection.py:39-624): the ``Det*`` augmenters, ``CreateDetAugmenter``
and ``ImageDetIter``. Labels are (N, 5+) float rows ``[cls, x1, y1, x2,
y2, ...]``, corners normalized to [0, 1]; an augmenter moves the image
and its boxes together, and an object a crop ejects becomes an invalid
row (cls = -1). The box geometry is numpy on the host, as the
reference's OpenCV path; a batch's labels are padded with -1 rows to
``(batch, max_objects, object_width)``.
"""
from __future__ import annotations

import json
import random as pyrandom

import numpy as np

from ..base import MXNetError
from .. import io as _io
from .. import ndarray as nd
from .image import (Augmenter, CreateAugmenter, ImageIter, ResizeAug,
                    imresize)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateMultiRandCropAugmenter", "CreateDetAugmenter",
           "ImageDetIter"]


def _as_np(img):
    return img.asnumpy() if isinstance(img, nd.NDArray) else np.asarray(img)


class DetAugmenter(object):
    """Detection augmenter base: ``__call__(src, label) -> (src, label)``
    (ref detection.py:39)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs.copy()
        for k, v in self._kwargs.items():
            if isinstance(v, np.ndarray):
                self._kwargs[k] = v.tolist()

    def dumps(self):
        """Name + init params, for iterator serialization."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap a plain image augmenter whose transform keeps box geometry
    valid (color/cast/normalize) (ref detection.py:65)."""

    def __init__(self, augmenter):
        if not isinstance(augmenter, Augmenter):
            raise TypeError("DetBorrowAug requires an image Augmenter")
        super().__init__(augmenter=augmenter.__class__.__name__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly run one of ``aug_list`` (or none, with ``skip_prob``)
    (ref detection.py:90)."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if not self.aug_list or pyrandom.random() < self.skip_prob:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and x-coordinates with probability ``p``
    (ref detection.py:126)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() >= self.p:
            return src, label
        img = _as_np(src)[:, ::-1]
        out = np.array(label, np.float32, copy=True)
        valid = out[:, 0] >= 0
        x1 = out[valid, 1].copy()
        out[valid, 1] = 1.0 - out[valid, 3]
        out[valid, 3] = 1.0 - x1
        return img, out


def _crop_boxes(label, x0, y0, w, h, W, H, min_eject_coverage):
    """Boxes (normalized, on a W x H image) remapped into the pixel
    crop (x0, y0, w, h); a box keeping less than ``min_eject_coverage``
    of its area is ejected (cls = -1)."""
    out = np.array(label, np.float32, copy=True)
    valid = out[:, 0] >= 0
    if not np.any(valid):
        return out
    b = out[valid, 1:5] * [W, H, W, H]
    area = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(
        b[:, 3] - b[:, 1], 0)
    ix1 = np.maximum(b[:, 0], x0)
    iy1 = np.maximum(b[:, 1], y0)
    ix2 = np.minimum(b[:, 2], x0 + w)
    iy2 = np.minimum(b[:, 3], y0 + h)
    inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
    keep = inter >= min_eject_coverage * np.maximum(area, 1e-10)
    nb = np.stack([np.clip((ix1 - x0) / w, 0, 1),
                   np.clip((iy1 - y0) / h, 0, 1),
                   np.clip((ix2 - x0) / w, 0, 1),
                   np.clip((iy2 - y0) / h, 0, 1)], axis=1)
    rows = np.where(valid)[0]
    out[rows, 1:5] = nb
    out[rows[~keep], 0] = -1.0
    return out


class DetRandomCropAug(DetAugmenter):
    """Random crop constrained to keep at least ``min_object_covered``
    of some object, sampling aspect ratio and area like the reference
    (ref detection.py:152, the TF sample_distorted_bounding_box recipe).
    Falls through (no crop) when no valid crop is found in
    ``max_attempts``."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def _sample(self, H, W, label):
        for _ in range(self.max_attempts):
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            area = pyrandom.uniform(*self.area_range) * H * W
            w = int(round(np.sqrt(area * ratio)))
            h = int(round(np.sqrt(area / ratio)))
            if w > W or h > H or w < 1 or h < 1:
                continue
            x0 = pyrandom.randint(0, W - w)
            y0 = pyrandom.randint(0, H - h)
            valid = label[:, 0] >= 0
            if np.any(valid):
                b = label[valid, 1:5] * [W, H, W, H]
                area_obj = np.maximum(b[:, 2] - b[:, 0], 0) * \
                    np.maximum(b[:, 3] - b[:, 1], 0)
                ix = np.maximum(
                    np.minimum(b[:, 2], x0 + w) - np.maximum(b[:, 0], x0),
                    0)
                iy = np.maximum(
                    np.minimum(b[:, 3], y0 + h) - np.maximum(b[:, 1], y0),
                    0)
                cover = ix * iy / np.maximum(area_obj, 1e-10)
                if cover.max() < self.min_object_covered:
                    continue
            return x0, y0, w, h
        return None

    def __call__(self, src, label):
        img = _as_np(src)
        H, W = img.shape[:2]
        label = np.asarray(label, np.float32)
        crop = self._sample(H, W, label)
        if crop is None:
            return img, label
        x0, y0, w, h = crop
        out = _crop_boxes(label, x0, y0, w, h, W, H,
                          self.min_eject_coverage)
        return img[y0:y0 + h, x0:x0 + w], out


class DetRandomPadAug(DetAugmenter):
    """Random expansion: paste the image at a random offset on a larger
    ``pad_val`` canvas, shrinking boxes accordingly
    (ref detection.py:323)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        img = _as_np(src)
        H, W = img.shape[:2]
        label = np.asarray(label, np.float32)
        for _ in range(self.max_attempts):
            ratio = pyrandom.uniform(*self.aspect_ratio_range)
            area = pyrandom.uniform(*self.area_range) * H * W
            nw = int(round(np.sqrt(area * ratio)))
            nh = int(round(np.sqrt(area / ratio)))
            if nw < W or nh < H:
                continue
            x0 = pyrandom.randint(0, nw - W)
            y0 = pyrandom.randint(0, nh - H)
            canvas = np.empty((nh, nw, img.shape[2]), img.dtype)
            canvas[...] = np.asarray(self.pad_val, img.dtype)
            canvas[y0:y0 + H, x0:x0 + W] = img
            out = np.array(label, np.float32, copy=True)
            valid = out[:, 0] >= 0
            out[valid, 1] = (out[valid, 1] * W + x0) / nw
            out[valid, 3] = (out[valid, 3] * W + x0) / nw
            out[valid, 2] = (out[valid, 2] * H + y0) / nh
            out[valid, 4] = (out[valid, 4] * H + y0) / nh
            return canvas, out
        return img, label


class _DetResizeAug(DetAugmenter):
    """Force-resize to (w, h): normalized boxes are invariant."""

    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src, label):
        out = imresize(_as_np(src), self.size[0], self.size[1], self.interp)
        return _as_np(out), label


def CreateMultiRandCropAugmenter(min_object_covered=0.1,
                                 aspect_ratio_range=(0.75, 1.33),
                                 area_range=(0.05, 1.0),
                                 min_eject_coverage=0.3, max_attempts=50,
                                 skip_prob=0.0):
    """One DetRandomSelectAug over per-parameter DetRandomCropAug
    choices; scalar params broadcast (ref detection.py:417)."""
    def listify(v):
        return v if isinstance(v, (list, tuple)) and v \
            and isinstance(v[0], (list, tuple)) else [v]

    covered = min_object_covered if isinstance(
        min_object_covered, (list, tuple)) else [min_object_covered]
    ratios = listify(aspect_ratio_range)
    areas = listify(area_range)
    ejects = min_eject_coverage if isinstance(
        min_eject_coverage, (list, tuple)) else [min_eject_coverage]
    n = max(len(covered), len(ratios), len(areas), len(ejects))

    def at(seq, i):
        return seq[i] if i < len(seq) else seq[-1]

    crops = [DetRandomCropAug(
        min_object_covered=at(covered, i),
        aspect_ratio_range=at(ratios, i), area_range=at(areas, i),
        min_eject_coverage=at(ejects, i), max_attempts=max_attempts)
        for i in range(n)]
    return DetRandomSelectAug(crops, skip_prob=skip_prob)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None,
                       std=None, brightness=0, contrast=0, saturation=0,
                       pca_noise=0, hue=0, inter_method=2,
                       min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """Detection augmenter list (ref detection.py:482): optional
    random pad/crop (with probabilities ``rand_pad``/``rand_crop``),
    mirror, force-resize to data_shape, then borrowed color/cast/
    normalize augmenters."""
    auglist = []
    if resize > 0:
        # resize-shorter keeps aspect; normalized boxes unaffected
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = CreateMultiRandCropAugmenter(
            min_object_covered=min_object_covered,
            aspect_ratio_range=aspect_ratio_range,
            area_range=(min(area_range[0], 1.0),
                        min(area_range[1], 1.0)),
            min_eject_coverage=min_eject_coverage,
            max_attempts=max_attempts, skip_prob=1 - rand_crop)
        auglist.append(crop)
    if rand_pad > 0:
        pad = DetRandomPadAug(
            aspect_ratio_range=aspect_ratio_range,
            area_range=(max(area_range[0], 1.0),
                        max(area_range[1], 1.0)),
            max_attempts=max_attempts, pad_val=pad_val)
        auglist.append(DetRandomSelectAug([pad], skip_prob=1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    # force to the network's input size LAST among geometry augs
    auglist.append(_DetResizeAug((data_shape[2], data_shape[1]),
                                 inter_method))
    color = CreateAugmenter(
        (data_shape[0], data_shape[1], data_shape[2]), resize=0,
        rand_crop=False, rand_mirror=False, mean=mean, std=std,
        brightness=brightness, contrast=contrast, saturation=saturation,
        hue=hue, pca_noise=pca_noise, rand_gray=rand_gray)
    for aug in color:
        name = aug.__class__.__name__
        if name in ("CenterCropAug", "RandomCropAug"):
            continue  # geometry handled above
        auglist.append(DetBorrowAug(aug))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator over .rec / .lst / in-memory lists
    (ref detection.py:624).

    List-format labels are the im2rec detection layout:
    ``[header_width, object_width, (cls, x1, y1, x2, y2, ...)*N]``;
    batches are padded to ``(batch, max_objects, object_width)`` with
    -1 rows.
    """

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=".", shuffle=False,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="label", **kwargs):
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec,
                         path_imglist=path_imglist, path_root=path_root,
                         shuffle=shuffle, aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name)
        self.auglist = aug_list if aug_list is not None \
            else CreateDetAugmenter(data_shape, **kwargs)
        self.label_shape = self._estimate_label_shape()
        self._label_name = label_name

    # -- label plumbing --------------------------------------------------
    def _parse_label(self, raw):
        """im2rec detection layout -> (N, object_width) array."""
        raw = np.asarray(raw, np.float32).reshape(-1)
        if raw.size < 2:
            raise MXNetError("detection label too short: %r" % (raw,))
        header_width = int(raw[0])
        obj_width = int(raw[1])
        if obj_width < 5:
            raise MXNetError(
                "object width %d < 5 (cls,x1,y1,x2,y2)" % obj_width)
        body = raw[header_width:]
        if body.size % obj_width:
            raise MXNetError(
                "label body %d not a multiple of object width %d"
                % (body.size, obj_width))
        return body.reshape(-1, obj_width).copy()

    def _estimate_label_shape(self):
        """Scan every label once to derive (max_objects, object_width),
        like the reference (detection.py _estimate_label_shape) — no
        hardcoded pad that could truncate crowded images or clip wide
        object rows."""
        max_objs, width = 0, 5
        if self.imglist is not None:
            for _, raw in self.imglist:
                lab = self._parse_label(raw)
                max_objs = max(max_objs, lab.shape[0])
                width = max(width, lab.shape[1])
        elif getattr(self, "_rec", None) is not None:
            from .. import recordio
            if self._keys is not None:
                recs = (self._rec.read_idx(k) for k in self._keys)
            else:
                self._rec.reset()
                recs = iter(self._rec.read, None)
            for rec in recs:
                header, _ = recordio.unpack(rec)
                lab = self._parse_label(header.label)
                max_objs = max(max_objs, lab.shape[0])
                width = max(width, lab.shape[1])
            if self._keys is None:
                self._rec.reset()
        return (max(max_objs, 1), width)

    @property
    def provide_label(self):
        return [_io.DataDesc(self._label_name,
                             (self.batch_size,) + self.label_shape)]

    @provide_label.setter
    def provide_label(self, value):      # base class sets a default
        pass

    def reshape(self, data_shape=None, label_shape=None):
        """Change data/label shapes between epochs
        (ref detection.py reshape)."""
        if data_shape is not None:
            self.data_shape = tuple(data_shape)
        if label_shape is not None:
            self.label_shape = tuple(label_shape)

    def sync_label_shape(self, it, verbose=False):
        """Synchronize label padding with another ImageDetIter (train /
        val pairs must agree) and return the harmonized shape."""
        assert isinstance(it, ImageDetIter)
        shape = (max(self.label_shape[0], it.label_shape[0]),
                 max(self.label_shape[1], it.label_shape[1]))
        self.label_shape = shape
        it.label_shape = shape
        return shape

    # -- iteration -------------------------------------------------------
    def _read_det_sample(self, i):
        if self.imglist is not None:
            from .image import imread
            import os
            fname, raw = self.imglist[self._order[i]]
            img = imread(os.path.join(self._root, fname))
            label = self._parse_label(raw)
        else:
            from .. import recordio
            if self._keys is not None:
                rec = self._rec.read_idx(self._keys[self._order[i]])
            else:
                rec = self._rec.read()
                if rec is None:
                    raise StopIteration
            from .image import imdecode
            header, buf = recordio.unpack(rec)
            img = imdecode(buf)
            label = self._parse_label(header.label)
        return img, label

    def next(self):
        n = len(self._order) if self._order is not None else None
        if n is not None and self._cursor + self.batch_size > n:
            raise StopIteration
        c, h, w = self.data_shape
        pw, ow = self.label_shape
        data = np.zeros((self.batch_size, c, h, w), np.float32)
        labels = np.full((self.batch_size, pw, ow), -1.0, np.float32)
        for k in range(self.batch_size):
            img, label = self._read_det_sample(self._cursor + k)
            img = _as_np(img).astype(np.float32)
            for aug in self.auglist:
                img, label = aug(img, label) if isinstance(
                    aug, DetAugmenter) else (aug(img), label)
            img = _as_np(img)
            if img.shape[:2] != (h, w):
                img = _as_np(imresize(img, w, h, 2))
            data[k] = np.transpose(img, (2, 0, 1))
            if label.shape[1] > ow:
                raise MXNetError(
                    "object width %d exceeds label_shape width %d; call "
                    "reshape(label_shape=...) or sync_label_shape first"
                    % (label.shape[1], ow))
            m = min(label.shape[0], pw)
            labels[k, :m, :label.shape[1]] = label[:m]
        self._cursor += self.batch_size
        return _io.DataBatch(data=[nd.array(data)],
                             label=[nd.array(labels)], pad=0)

    def draw_next(self, color=(255, 0, 0), thickness=2):
        """Yield augmented images (HWC uint8 numpy) with their boxes
        drawn — the reference's debug visualization, minus cv2 text."""
        while True:
            try:
                batch = self.next()
            except StopIteration:
                return
            imgs = batch.data[0].asnumpy().transpose(0, 2, 3, 1)
            labs = batch.label[0].asnumpy()
            for img, lab in zip(imgs, labs):
                canvas = np.clip(img, 0, 255).astype(np.uint8).copy()
                H, W = canvas.shape[:2]
                for row in lab:
                    if row[0] < 0:
                        continue
                    x1, y1, x2, y2 = (row[1] * W, row[2] * H,
                                      row[3] * W, row[4] * H)
                    x1, y1, x2, y2 = map(int, (x1, y1, x2, y2))
                    t = thickness
                    canvas[y1:y2, x1:x1 + t] = color
                    canvas[y1:y2, max(x2 - t, 0):x2] = color
                    canvas[y1:y1 + t, x1:x2] = color
                    canvas[max(y2 - t, 0):y2, x1:x2] = color
                yield canvas
