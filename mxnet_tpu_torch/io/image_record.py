"""ImageRecordIter and ImageDetRecordIter (counterpart of
``mxnet_tpu/io/image_record.py``; reference:
src/io/iter_image_recordio_2.cc:748 with its PrefetcherIter/BatchLoader
layering).

One reader walks the .rec file (keyed by the .idx sidecar when present;
a sequential scan reads through the native prefetching reader,
``io/native.py``, when it is available), a thread pool decodes and
augments the images (cv2, else PIL: both release the GIL in JPEG
decode, the role of the reference's OMP parser threads), and whole
batches land as host tensors, which the input pipeline's placer copies
to the card. Augmentation covers the training core of
image_aug_default.cc: resize of the shorter edge, random or center
crop, random mirror, mean/std normalization, all in numpy, as in the
JAX package. The augmentation's random draws are made serially
(``_draw`` from ``next_raw``), so pooled decode is bit-identical to the
eager ``next()`` for the same seed.
"""
from __future__ import annotations

import concurrent.futures
import os
import threading

import numpy as np

from ..base import MXNetError
from ..recordio import MXRecordIO, MXIndexedRecordIO, unpack
from .io import DataBatch, DataDesc, DataIter, host_array, to_context

__all__ = ["ImageRecordIter", "ImageDetRecordIter"]


def _decode_jpeg(payload):
    try:
        import cv2
        img = cv2.imdecode(np.frombuffer(payload, np.uint8),
                           cv2.IMREAD_COLOR)
        return img[:, :, ::-1]                  # BGR → RGB
    except ImportError:
        pass
    import io as _io
    from PIL import Image
    return np.asarray(Image.open(_io.BytesIO(payload)).convert("RGB"))


def _resize_shorter(img, size):
    import math
    h, w = img.shape[:2]
    if min(h, w) == size:
        return img
    if h < w:
        nh, nw = size, max(1, int(round(w * size / h)))
    else:
        nh, nw = max(1, int(round(h * size / w))), size
    try:
        import cv2
        return cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    except ImportError:
        from PIL import Image
        return np.asarray(Image.fromarray(img).resize((nw, nh)))


class ImageRecordIter(DataIter):
    """Batched, augmented iteration over an image RecordIO file
    (reference: ImageRecordIter, iter_image_recordio_2.cc:748)."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, label_width=1, shuffle=False,
                 rand_crop=False, rand_mirror=False, resize=-1,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, scale=1.0,
                 preprocess_threads=4, prefetch_buffer=4, seed=0,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        if len(data_shape) != 3:
            raise MXNetError(
                "ImageRecordIter data_shape must be (C, H, W), got %s"
                % (data_shape,))
        self._shape = tuple(int(s) for s in data_shape)
        self._label_width = int(label_width)
        self._shuffle = shuffle
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        self._resize = int(resize)
        self._mean = np.asarray([mean_r, mean_g, mean_b], np.float32)
        self._std = np.asarray([std_r, std_g, std_b], np.float32)
        self._scale = float(scale)
        self._rng = np.random.RandomState(seed)
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, int(preprocess_threads)),
            thread_name_prefix="imgrec")
        self._depth = max(1, int(prefetch_buffer))

        if path_imgidx and os.path.exists(path_imgidx):
            self._rec = MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
            self._keys = list(self._rec.keys)
        else:
            if shuffle:
                raise MXNetError(
                    "ImageRecordIter(shuffle=True) needs the .idx "
                    "sidecar (pass path_imgidx; im2rec writes one) — "
                    "sequential .rec scans cannot be shuffled")
            from . import native as _native
            if _native.available():
                # C++ prefetch thread stays ahead of decode (the
                # reference's PrefetcherIter, iter_prefetcher.h:47)
                self._rec = _native.PrefetchingRecordReader(path_imgrec)
            else:
                self._rec = MXRecordIO(path_imgrec, "r")
            self._keys = None           # sequential-scan mode
        self._lock = threading.Lock()   # serializes record reads

        c, h, w = self._shape
        self.provide_data = [DataDesc(data_name,
                                      (batch_size, c, h, w))]
        lshape = (batch_size,) if self._label_width == 1 \
            else (batch_size, self._label_width)
        self.provide_label = [DataDesc(label_name, lshape)]
        self.reset()

    # -- record access ----------------------------------------------------
    def _read_raw(self, key):
        with self._lock:
            if key is None:
                return self._rec.read()
            return self._rec.read_idx(key)

    def _epoch_keys(self):
        if self._keys is None:
            return None
        order = list(self._keys)
        if self._shuffle:
            self._rng.shuffle(order)
        return order

    # -- decode + augment -------------------------------------------------
    def _prepare_image(self, payload, mirror, crop_pos):
        """Decode + augment one record; returns (chw, header, geometry)
        where geometry = (oy, ox, th, tw, h, w, mirrored) describes the
        crop so subclasses can transform coordinates accordingly."""
        header, body = unpack(payload)
        img = _decode_jpeg(body).astype(np.float32)
        c, th, tw = self._shape
        if self._resize > 0:
            img = _resize_shorter(img.astype(np.uint8),
                                  self._resize).astype(np.float32)
        h, w = img.shape[:2]
        if h < th or w < tw:
            img = _resize_shorter(img.astype(np.uint8),
                                  max(th, tw)).astype(np.float32)
            h, w = img.shape[:2]
        if self._rand_crop:
            oy = int(crop_pos[0] * (h - th))
            ox = int(crop_pos[1] * (w - tw))
        else:
            oy, ox = (h - th) // 2, (w - tw) // 2
        img = img[oy:oy + th, ox:ox + tw]
        if mirror:
            img = img[:, ::-1]
        img = (img - self._mean) / self._std * self._scale
        chw = np.transpose(img, (2, 0, 1))
        return chw, header, (oy, ox, th, tw, h, w, bool(mirror))

    def _prepare(self, payload, mirror, crop_pos):
        chw, header, _ = self._prepare_image(payload, mirror, crop_pos)
        label = np.asarray(header.label, np.float32).reshape(-1)
        if label.size == 0:
            label = np.zeros((self._label_width,), np.float32)
        return chw, label[:self._label_width]

    def _draw(self, n):
        """The batch's augmentation randomness — drawn SERIALLY (from
        ``next_raw`` on the pipeline's scheduler thread, or inline on
        the eager path) so pooled decode is bit-identical to eager for
        the same seed, in the same batch order."""
        mirrors = self._rng.rand(n) < 0.5 \
            if self._rand_mirror else [False] * n
        crops = self._rng.rand(n, 2)
        return mirrors, crops

    def _assemble(self, payloads):
        mirrors, crops = self._draw(len(payloads))
        return self._assemble_drawn(payloads, mirrors, crops)

    def _assemble_drawn(self, payloads, mirrors, crops):
        futures = [self._pool.submit(self._prepare, p, m, cp)
                   for p, m, cp in zip(payloads, mirrors, crops)]
        images, labels = zip(*[f.result() for f in futures])
        lab = np.stack(labels)
        if self._label_width == 1 and lab.ndim == 2:
            lab = lab[:, 0]
        return DataBatch([host_array(np.stack(images))], [host_array(lab)],
                         pad=0)

    def _next_payloads(self):
        """Serialized record IO for one batch: raw (still-encoded)
        payloads + the pad count, or StopIteration at epoch end."""
        bs = self.batch_size
        if self._order is not None:
            if self._cursor >= len(self._order):
                raise StopIteration
            keys = self._order[self._cursor:self._cursor + bs]
            self._cursor += bs
            pad = bs - len(keys)
            if pad:
                # round_batch semantics: wrap to the epoch start (cycling
                # if the dataset is smaller than one batch) and report
                # the pad count so score()/metrics can mask
                keys = keys + [self._order[i % len(self._order)]
                               for i in range(pad)]
            payloads = []
            for k in keys:
                raw = self._read_raw(k)
                if raw is None:
                    raise StopIteration
                payloads.append(raw)
            return payloads, pad
        # sequential scan: read up to bs records, pad from this batch
        payloads = []
        for _ in range(bs):
            raw = self._read_raw(None)
            if raw is None:
                break
            payloads.append(raw)
        if not payloads:
            raise StopIteration
        pad = bs - len(payloads)
        if pad:
            reps = [payloads[i % len(payloads)] for i in range(pad)]
            payloads = payloads + reps
        return payloads, pad

    # -- DataIter protocol ------------------------------------------------
    def reset(self):
        self._order = self._epoch_keys()
        self._cursor = 0
        if self._keys is None:
            self._rec.reset()

    # split protocol (io/pipeline.py): record IO + rng draws serialize
    # in next_raw; the expensive JPEG decode/augment parallelizes in
    # decode_raw across the pipeline's workers (each of which may also
    # fan single images out to this iterator's own thread pool)
    def next_raw(self):
        payloads, pad = self._next_payloads()
        mirrors, crops = self._draw(len(payloads))
        return payloads, mirrors, crops, pad

    def decode_raw(self, raw):
        payloads, mirrors, crops, pad = raw
        batch = self._assemble_drawn(payloads, mirrors, crops)
        batch.pad = pad
        return batch

    def next(self):
        return to_context(self.decode_raw(self.next_raw()))

    def close(self):
        """Shut the decode pool and the record reader down."""
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)
            self._pool = None
        rec = getattr(self, "_rec", None)
        if rec is not None:
            rec.close()
            self._rec = None

    def __del__(self):
        self.close()


class ImageDetRecordIter(ImageRecordIter):
    """Detection variant (reference: src/io/iter_image_det_recordio.cc):
    each record's label is a variable-length flat vector of
    ``object_width``-wide object rows ([cls, x1, y1, x2, y2, ...]);
    batches pad every image to ``label_pad_width`` objects with
    ``label_pad_value`` so the label tensor is rectangular —
    (batch, label_pad_width, object_width)."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 object_width=5, label_pad_width=16,
                 label_pad_value=-1.0, **kwargs):
        self._object_width = int(object_width)
        self._label_pad_width = int(label_pad_width)
        self._label_pad_value = float(label_pad_value)
        kwargs.setdefault("label_width", 1)
        super().__init__(path_imgrec, data_shape, batch_size, **kwargs)
        self.provide_label = [DataDesc(
            self.provide_label[0].name,
            (self.batch_size, self._label_pad_width, self._object_width))]

    def _transform_boxes(self, objs, geom):
        """Map normalized [x1,y1,x2,y2] from the original image into
        the cropped/mirrored frame (reference:
        image_det_aug_default.cc); boxes left entirely outside the crop
        become padding rows."""
        oy, ox, th, tw, h, w, mirrored = geom
        out = objs.copy()
        x1 = objs[:, 1] * w - ox
        y1 = objs[:, 2] * h - oy
        x2 = objs[:, 3] * w - ox
        y2 = objs[:, 4] * h - oy
        nx1 = np.clip(x1 / tw, 0.0, 1.0)
        ny1 = np.clip(y1 / th, 0.0, 1.0)
        nx2 = np.clip(x2 / tw, 0.0, 1.0)
        ny2 = np.clip(y2 / th, 0.0, 1.0)
        if mirrored:
            nx1, nx2 = 1.0 - nx2, 1.0 - nx1
        out[:, 1], out[:, 2], out[:, 3], out[:, 4] = nx1, ny1, nx2, ny2
        gone = (nx2 - nx1 <= 0) | (ny2 - ny1 <= 0)
        out[gone] = self._label_pad_value
        return out

    def _prepare(self, payload, mirror, crop_pos):
        img, header, geom = self._prepare_image(payload, mirror,
                                                crop_pos)
        flat = np.asarray(header.label, np.float32).reshape(-1)
        ow, pw = self._object_width, self._label_pad_width
        if flat.size % ow:
            raise MXNetError(
                "detection record label length %d is not a multiple of "
                "object_width %d" % (flat.size, ow))
        n = flat.size // ow
        if n > pw:
            raise MXNetError(
                "record has %d objects but label_pad_width is %d; "
                "raise label_pad_width" % (n, pw))
        objs = np.full((pw, ow), self._label_pad_value, np.float32)
        if n:
            objs[:n] = self._transform_boxes(flat.reshape(n, ow), geom)
        return img, objs

