"""RecordIO container format (counterpart of ``mxnet_tpu/recordio.py``;
API parity: python/mxnet/recordio.py; wire format: dmlc-core recordio).

The byte-level framing lives in two module functions
(:func:`_write_frame` / :func:`_read_frame`) shared by both classes, so
the user-facing objects only manage file lifecycle and the key index.
Records are framed ``<magic><kind|length>`` little-endian, payload
padded to a 4-byte boundary: byte-compatible with files written by the
reference, by the JAX package and by ``tools/im2rec``. Images are
encoded and decoded with cv2, else PIL; with neither installed
:func:`pack_img` / :func:`unpack_img` raise ``ImportError``.
"""
from __future__ import annotations

import numbers
import os
import struct
from collections import namedtuple

import numpy as np

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xced7230a
_WORD = struct.Struct("<II")
_KIND_SHIFT = 29                      # upper 3 bits carry the chunk kind
_LEN_MASK = (1 << _KIND_SHIFT) - 1


def _padding(length):
    return -length % 4


def _write_frame(fh, payload, kind=0):
    word = (kind << _KIND_SHIFT) | (len(payload) & _LEN_MASK)
    fh.write(_WORD.pack(_MAGIC, word))
    fh.write(payload)
    fh.write(b"\x00" * _padding(len(payload)))


def _read_frame(fh):
    head = fh.read(_WORD.size)
    if len(head) < _WORD.size:
        return None                   # clean EOF
    magic, word = _WORD.unpack(head)
    if magic != _MAGIC:
        raise RuntimeError(
            "corrupt RecordIO stream: bad magic 0x%08x at offset %d"
            % (magic, fh.tell() - _WORD.size))
    length = word & _LEN_MASK
    payload = fh.read(length)
    fh.seek(_padding(length), os.SEEK_CUR)
    return payload


class _Stream:
    """Owns the OS file handle + the owning pid (fork detection)."""

    __slots__ = ("fh", "pid")

    def __init__(self, path, mode):
        self.fh = open(path, mode)
        self.pid = os.getpid()

    def forked(self):
        return self.pid != os.getpid()

    def drop(self):
        self.fh.close()


class MXRecordIO:
    """Sequential .rec reader/writer (reference: recordio.py:37).

    Also usable as a context manager. Fork-safety matches the
    reference: a reader re-opens in the child, a writer refuses.
    Internally the handle lives in a :class:`_Stream` so subclasses and
    pickling share one lifecycle path.
    """

    def __init__(self, uri, flag):
        if flag not in ("r", "w"):
            raise ValueError(
                "MXRecordIO flag must be 'r' or 'w', got %r" % (flag,))
        self.uri, self.flag = uri, flag
        self._s = None
        self.open()

    writable = property(lambda self: self.flag == "w")
    is_open = property(lambda self: getattr(self, "_s", None) is not None)
    record = property(lambda self: self._s.fh if self._s else None)
    pid = property(lambda self: self._s.pid if self._s else None)

    # -- lifecycle --------------------------------------------------------
    def open(self):
        self._s = _Stream(self.uri, self.flag + "b")

    def close(self):
        if getattr(self, "_s", None) is not None:
            self._s.drop()
            self._s = None

    def reset(self):
        self.close()
        self.open()

    __enter__ = lambda self: self
    __exit__ = lambda self, *exc: self.close()
    __del__ = lambda self: self.close()

    # -- pickling (DataLoader workers ship iterators) ---------------------
    def __getstate__(self):
        was_open = self.is_open
        self.close()
        state = dict(self.__dict__, _was_open=was_open)
        state.pop("_s", None)
        return state

    def __setstate__(self, state):
        reopen = state.pop("_was_open", False)
        self.__dict__.update(state)
        self._s = None
        if reopen:
            self.open()

    def _guard_fork(self):
        if not self._s.forked():
            return
        if self.writable:
            raise RuntimeError(
                "RecordIO writer used from a forked process; re-open it "
                "in the child instead")
        self.reset()                  # readers transparently re-open

    # -- IO ---------------------------------------------------------------
    def write(self, buf):
        if not self.writable:
            raise RuntimeError("RecordIO opened for reading; cannot write")
        self._guard_fork()
        _write_frame(self._s.fh, buf)

    def read(self):
        if self.writable:
            raise RuntimeError("RecordIO opened for writing; cannot read")
        self._guard_fork()
        return _read_frame(self._s.fh)

    def tell(self):
        return self._s.fh.tell()

    def seek(self, pos):
        if self.writable:
            raise RuntimeError("seek is only valid on a reader")
        self._guard_fork()      # BEFORE positioning: a post-fork reset
        self._s.fh.seek(pos)    # would silently rewind to offset 0


class MXIndexedRecordIO(MXRecordIO):
    """Random-access .rec + .idx pair (reference: recordio.py:160). The
    sidecar index maps key -> byte offset, one tab-separated row each."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path, self.key_type = idx_path, key_type
        self.idx, self.keys, self.fidx = {}, [], None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx, self.keys = {}, []
        self.fidx = open(self.idx_path, self.flag)
        if not self.writable:
            for row in self.fidx:
                key_s, _, pos_s = row.strip().partition("\t")
                self._remember(self.key_type(key_s), int(pos_s))

    def _remember(self, key, offset):
        self.idx[key] = offset
        self.keys.append(key)

    def close(self):
        if self.is_open and self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def __getstate__(self):
        state = super().__getstate__()
        state.pop("fidx", None)
        return state

    def seek(self, idx):
        super().seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key, offset = self.key_type(idx), self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (key, offset))
        self._remember(key, offset)


# ---------------------------------------------------------------------------
# image-record payload packing (IRHeader)
# ---------------------------------------------------------------------------

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR = struct.Struct("IfQQ")


def pack(header, s):
    """Prefix payload ``s`` with an IRHeader; a vector label is spilled
    after the header with its length in ``flag``
    (reference: recordio.py:305)."""
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        fields = header._replace(flag=0)
        extra = b""
    else:
        vec = np.asarray(header.label, dtype=np.float32)
        fields = header._replace(flag=vec.size, label=0)
        extra = vec.tobytes()
    return _IR.pack(*fields) + extra + s


def unpack(s):
    """Inverse of :func:`pack` (reference: recordio.py:336)."""
    header = IRHeader(*_IR.unpack_from(s))
    payload = memoryview(s)[_IR.size:]
    if header.flag:
        n = header.flag * 4
        header = header._replace(
            label=np.frombuffer(payload[:n], dtype=np.float32))
        payload = payload[n:]
    return header, bytes(payload)


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Encode ``img`` (jpeg/png via cv2, PIL fallback) and pack it."""
    return pack(header, _imencode(img, quality, img_fmt))


def unpack_img(s, iscolor=-1):
    header, payload = unpack(s)
    return header, _imdecode(payload, iscolor)


def _imencode(img, quality, img_fmt):
    jpeg = img_fmt.lower() in (".jpg", ".jpeg")
    try:
        import cv2
        ok, buf = cv2.imencode(
            img_fmt.lower(), img,
            [cv2.IMWRITE_JPEG_QUALITY, quality] if jpeg else [])
        if not ok:
            raise RuntimeError("cv2.imencode failed for %s" % img_fmt)
        return buf.tobytes()
    except ImportError:
        pass
    try:
        import io
        from PIL import Image
    except ImportError:
        raise ImportError("pack_img needs cv2 or PIL installed")
    sink = io.BytesIO()
    Image.fromarray(np.asarray(img)).save(
        sink, format="JPEG" if jpeg else "PNG", quality=quality)
    return sink.getvalue()


def _imdecode(payload, iscolor=-1):
    try:
        import cv2
        return cv2.imdecode(np.frombuffer(payload, dtype=np.uint8),
                            iscolor)
    except ImportError:
        pass
    try:
        import io
        from PIL import Image
    except ImportError:
        raise ImportError("unpack_img needs cv2 or PIL installed")
    return np.asarray(Image.open(io.BytesIO(payload)))
