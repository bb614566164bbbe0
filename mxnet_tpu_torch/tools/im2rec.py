"""im2rec — pack an image dataset into RecordIO (counterpart of
``mxnet_tpu/tools/im2rec.py``; reference: tools/im2rec.py /
tools/im2rec.cc). Its ``.lst``, ``.rec`` and ``.idx`` files are
byte-identical to the JAX package's for the same images.

Two stages, same as the reference tool:
- :func:`make_list` walks an image directory tree and writes the
  ``.lst`` file (``index\tlabel\trelative_path`` rows, labels assigned
  per subdirectory).
- :func:`im2rec` reads a ``.lst``, JPEG-encodes each image (optionally
  resizing the shorter edge), and writes the ``.rec`` + ``.idx`` pair
  via :class:`MXIndexedRecordIO` with IRHeader packing.

Usable as a CLI: ``python -m mxnet_tpu_torch.tools.im2rec prefix root``.
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from ..recordio import MXIndexedRecordIO, IRHeader, pack, pack_img

__all__ = ["make_list", "im2rec", "read_list"]

_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def make_list(root, prefix, recursive=True, shuffle=False, seed=0):
    """Write ``prefix.lst`` over the images under ``root``; one class
    label per immediate subdirectory (reference: im2rec.py list_image)."""
    entries = []
    classes = {}
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        rel_dir = os.path.relpath(dirpath, root)
        for fname in sorted(filenames):
            if not fname.lower().endswith(_EXTS):
                continue
            label = classes.setdefault(
                rel_dir if rel_dir != "." else "", len(classes))
            entries.append((label,
                            os.path.normpath(os.path.join(rel_dir,
                                                          fname))))
        if not recursive:
            break
    if shuffle:
        np.random.RandomState(seed).shuffle(entries)
    lst_path = prefix + ".lst"
    tmp = "%s.tmp.%d" % (lst_path, os.getpid())
    with open(tmp, "w") as out:
        for i, (label, rel) in enumerate(entries):
            out.write("%d\t%f\t%s\n" % (i, float(label), rel))
    os.replace(tmp, lst_path)
    return lst_path, classes


def read_list(lst_path):
    """Yield (index, label(s), relative_path) rows of a .lst file."""
    with open(lst_path) as f:
        for line in f:
            cells = line.strip().split("\t")
            if len(cells) < 3:
                continue
            idx = int(cells[0])
            labels = [float(x) for x in cells[1:-1]]
            yield idx, labels, cells[-1]


def im2rec(lst_path, root, prefix, quality=95, resize=0,
           encoding=".jpg", pass_through=False):
    """Pack every .lst row into ``prefix.rec`` + ``prefix.idx``
    (reference: im2rec.py write_record)."""
    rec = MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    count = 0
    for idx, labels, rel in read_list(lst_path):
        path = os.path.join(root, rel)
        label = labels[0] if len(labels) == 1 else np.asarray(labels)
        header = IRHeader(0, label, idx, 0)
        if pass_through:
            with open(path, "rb") as f:
                payload = pack(header, f.read())
        else:
            img = _load_image(path, resize)
            payload = pack_img(header, img, quality=quality,
                               img_fmt=encoding)
        rec.write_idx(idx, payload)
        count += 1
    rec.close()
    logging.info("im2rec: wrote %d records to %s.rec", count, prefix)
    return count


def _load_image(path, resize):
    try:
        import cv2
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise IOError("cv2 failed to read %s" % path)
        if resize:
            h, w = img.shape[:2]
            if h < w:
                nh, nw = resize, int(round(w * resize / h))
            else:
                nh, nw = int(round(h * resize / w)), resize
            img = cv2.resize(img, (nw, nh))
        return img
    except ImportError:
        from PIL import Image
        img = Image.open(path).convert("RGB")
        if resize:
            w, h = img.size
            if h < w:
                nh, nw = resize, int(round(w * resize / h))
            else:
                nh, nw = int(round(h * resize / w)), resize
            img = img.resize((nw, nh))
        # cv2 absent ⇒ pack_img will also encode via PIL, which
        # expects RGB — keep PIL's native channel order
        return np.asarray(img)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("prefix", help="output prefix for .lst/.rec/.idx")
    ap.add_argument("root", help="image directory root")
    ap.add_argument("--no-list", action="store_true",
                    help="reuse an existing prefix.lst")
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--resize", type=int, default=0)
    ap.add_argument("--shuffle", action="store_true")
    args = ap.parse_args()
    if not args.no_list:
        make_list(args.root, args.prefix, shuffle=args.shuffle)
    im2rec(args.prefix + ".lst", args.root, args.prefix,
           quality=args.quality, resize=args.resize)


if __name__ == "__main__":
    main()
