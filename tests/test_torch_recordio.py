"""Port parity: RecordIO (``mxnet_tpu_torch.recordio``), the packing
tools (``tools.im2rec``, ``tools.rec2idx``) and the native reader
(``io/native.py`` over ``io/csrc/recordio_io.cc``, built here with g++)
against ``mxnet_tpu``, on the CPU.

Files written by either package are read byte for byte by the other, and
the two packages write byte-identical ``.rec``, ``.idx`` and ``.lst``
files for the same records; the native reader follows
``tests/test_native_io.py``'s cases against the port's Python reader.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import recordio as trec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


def _records(seed=0, n=24):
    """(key, header, payload) rows: scalar and array labels, empty and
    pad-edge payloads."""
    rng = np.random.RandomState(seed)
    rows = []
    for i in range(n):
        body = rng.bytes(int(rng.randint(0, 700)))
        if i % 3 == 0:
            label = rng.rand(int(rng.randint(1, 6))).astype(np.float32)
        else:
            label = float(rng.randint(0, 10))
        rows.append((i, (0, label, i, i * 7), body))
    rows.append((n, (0, 1.0, n, 0), b""))
    rows.append((n + 1, (0, 2.0, n + 1, 0), b"x"))
    return rows


def _write(mod, prefix, rows, key_type=int):
    rec = mod.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w",
                                key_type=key_type)
    for key, header, body in rows:
        rec.write_idx(key, mod.pack(mod.IRHeader(*header), body))
    rec.close()


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _assert_same_record(a, b):
    ha, pa = a
    hb, pb = b
    assert pa == pb
    assert (ha.flag, ha.id, ha.id2) == (hb.flag, hb.id, hb.id2)
    np.testing.assert_array_equal(np.asarray(ha.label),
                                  np.asarray(hb.label))


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)],
                         ids=["jax_writes", "port_writes"])
def test_files_cross_read(tmp_path, writer, reader):
    rows = _records()
    prefix = str(tmp_path / "x")
    _write(writer, prefix, rows)
    ind = reader.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    assert ind.keys == [k for k, _, _ in rows]
    for key, header, body in reversed(rows):      # random access
        got = reader.unpack(ind.read_idx(key))
        want = writer.unpack(writer.pack(writer.IRHeader(*header), body))
        _assert_same_record(got, want)
    ind.close()
    seq = reader.MXRecordIO(prefix + ".rec", "r")   # sequential scan
    for _, header, body in rows:
        got = reader.unpack(seq.read())
        assert got[1] == body
    assert seq.read() is None
    seq.close()


@pytest.mark.parametrize("key_type", [int, str])
def test_written_files_byte_identical(tmp_path, key_type):
    rows = [(key_type(k), h, b) for k, h, b in _records(seed=1)]
    _write(jrec, str(tmp_path / "j"), rows, key_type)
    _write(trec, str(tmp_path / "t"), rows, key_type)
    for ext in (".rec", ".idx"):
        assert _bytes(str(tmp_path / ("j" + ext))) == \
            _bytes(str(tmp_path / ("t" + ext)))


def test_pack_unpack_header_bytes():
    for label in (3.0, np.arange(5, dtype=np.float32), [1.5, 2.5]):
        header = (0, label, 11, 4)
        packed = trec.pack(trec.IRHeader(*header), b"payload")
        assert packed == jrec.pack(jrec.IRHeader(*header), b"payload")
        _assert_same_record(trec.unpack(packed), jrec.unpack(packed))


def test_pack_img_cross_decode():
    img = np.random.RandomState(2).randint(0, 255, (20, 24, 3),
                                           dtype=np.uint8)
    header = (0, 4.0, 1, 0)
    for fmt in (".jpg", ".png"):
        tp = trec.pack_img(trec.IRHeader(*header), img, quality=90,
                           img_fmt=fmt)
        jp = jrec.pack_img(jrec.IRHeader(*header), img, quality=90,
                           img_fmt=fmt)
        assert tp == jp
        th, timg = trec.unpack_img(tp)
        jh, jimg = jrec.unpack_img(tp)
        np.testing.assert_array_equal(timg, jimg)
        if fmt == ".png":
            np.testing.assert_array_equal(timg, img)


def test_reader_fork_guard(tmp_path):
    rows = _records(n=3)
    prefix = str(tmp_path / "f")
    _write(trec, prefix, rows)
    r = trec.MXRecordIO(prefix + ".rec", "r")
    r.read()
    r._s.pid = -1                 # as seen from a forked child
    assert trec.unpack(r.read())[1] == rows[0][2]   # reopened at 0
    r.close()
    w = trec.MXRecordIO(str(tmp_path / "w.rec"), "w")
    w._s.pid = -1
    with pytest.raises(RuntimeError, match="forked"):
        w.write(b"abc")
    w.close()
    with pytest.raises(ValueError, match="flag"):
        trec.MXRecordIO(prefix + ".rec", "a")


def _image_tree(root, classes=2, per_class=4, size=(40, 32)):
    from PIL import Image
    rng = np.random.RandomState(0)
    for c in range(classes):
        d = os.path.join(root, "class%d" % c)
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            img = np.clip(40 + 120 * c + rng.randint(0, 20, size + (3,)),
                          0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(d, "img%d.jpg" % i),
                                      quality=95)


@pytest.mark.parametrize("resize", [0, 24])
def test_im2rec_and_rec2idx_byte_identical(tmp_path, resize):
    from mxnet_tpu.tools import im2rec as jtool, rec2idx as jidx
    from mxnet_tpu_torch.tools import im2rec as ttool, rec2idx as tidx
    root = str(tmp_path / "imgs")
    _image_tree(root)
    outs = {}
    for name, tool in (("j", jtool), ("t", ttool)):
        prefix = str(tmp_path / name)
        lst, classes = tool.make_list(root, prefix, shuffle=True, seed=3)
        n = tool.im2rec(lst, root, prefix, quality=90, resize=resize)
        assert n == 8 and len(classes) == 2
        outs[name] = prefix
    for ext in (".lst", ".rec", ".idx"):
        assert _bytes(outs["j"] + ext) == _bytes(outs["t"] + ext), ext
    for seq in (False, True):
        jn = jidx.build_index(outs["j"] + ".rec", outs["j"] + ".i2",
                              sequential_keys=seq)
        tn = tidx.build_index(outs["t"] + ".rec", outs["t"] + ".i2",
                              sequential_keys=seq)
        assert jn == tn == 8
        assert _bytes(outs["j"] + ".i2") == _bytes(outs["t"] + ".i2")
    assert _bytes(outs["t"] + ".i2") != b""


def test_rec2idx_cli(tmp_path, capsys):
    from mxnet_tpu_torch.tools import rec2idx
    prefix = str(tmp_path / "c")
    _write(trec, prefix, _records(n=5))
    assert rec2idx.main([prefix + ".rec", prefix + ".i2"]) == 7
    assert "wrote 7 index entries" in capsys.readouterr().out
    assert _bytes(prefix + ".i2") == _bytes(prefix + ".idx")


# ---------------------------------------------------------------------------
# the native reader (tests/test_native_io.py's cases)
# ---------------------------------------------------------------------------

@pytest.fixture
def native(monkeypatch):
    monkeypatch.setenv("MXNET_USE_NATIVE_IO", "1")
    from mxnet_tpu_torch.io import native as mod
    mod._TRIED, mod._LIB = False, None
    assert mod.available(), mod.lib_path()
    yield mod
    mod._TRIED, mod._LIB = False, None


def _write_plain(path, payloads):
    rec = trec.MXRecordIO(str(path), "w")
    for p in payloads:
        rec.write(p)
    rec.close()


def test_native_library_is_the_ports_own_build(native):
    path = native.lib_path()
    assert path.startswith(os.path.join(REPO, "mxnet_tpu_torch", "_build"))
    assert os.path.exists(path)
    import hashlib
    src = os.path.join(REPO, "mxnet_tpu_torch", "io", "csrc",
                       "recordio_io.cc")
    digest = hashlib.sha256(_bytes(src)).hexdigest()[:16]
    assert os.path.basename(path) == "libmxtpu_io-%s.so" % digest
    # the loaded library is that build, never native/build's
    assert native._LIB._name == path


def test_native_reader_byte_parity(native, tmp_path):
    rng = np.random.RandomState(0)
    payloads = [rng.bytes(rng.randint(1, 5000)) for _ in range(64)]
    payloads += [b"", b"x"]
    rec_path = tmp_path / "t.rec"
    _write_plain(rec_path, payloads)
    with native.NativeRecordReader(str(rec_path)) as r:
        assert list(r) == payloads
    pyr = trec.MXRecordIO(str(rec_path), "r")
    for want in payloads:
        assert pyr.read() == want
    assert pyr.read() is None
    # the JAX package's Python reader reads the same stream
    jr = jrec.MXRecordIO(str(rec_path), "r")
    assert [jr.read() for _ in payloads] == payloads


def test_native_reader_seek(native, tmp_path):
    payloads = [b"a" * 10, b"b" * 20, b"c" * 30]
    rec = trec.MXIndexedRecordIO(str(tmp_path / "s.idx"),
                                 str(tmp_path / "s.rec"), "w")
    for i, p in enumerate(payloads):
        rec.write_idx(i, p)
    rec.close()
    offsets = trec.MXIndexedRecordIO(str(tmp_path / "s.idx"),
                                     str(tmp_path / "s.rec"), "r").idx
    with native.NativeRecordReader(str(tmp_path / "s.rec")) as r:
        r.seek(offsets[2])
        assert r.read() == payloads[2]
        r.seek(offsets[0])
        assert r.read() == payloads[0]
        r.reset()
        assert r.read() == payloads[0]


def test_native_reader_corrupt_stream(native, tmp_path):
    rec_path = tmp_path / "bad.rec"
    rec_path.write_bytes(b"\x00" * 16)
    with native.NativeRecordReader(str(rec_path)) as r:
        with pytest.raises(RuntimeError, match="bad magic"):
            r.read()
    with pytest.raises(RuntimeError, match="bad magic"):
        trec.MXRecordIO(str(rec_path), "r").read()


def test_prefetching_reader_order_and_reset(native, tmp_path):
    rng = np.random.RandomState(1)
    payloads = [rng.bytes(rng.randint(100, 2000)) for _ in range(200)]
    rec_path = tmp_path / "p.rec"
    _write_plain(rec_path, payloads)
    # a tiny capacity forces producer/consumer backpressure
    r = native.PrefetchingRecordReader(str(rec_path), capacity_bytes=4096)
    try:
        assert list(r) == payloads
        assert r.read() is None
        r.reset()
        assert r.read() == payloads[0]
    finally:
        r.close()


def test_image_record_iter_uses_native_prefetch(native, tmp_path):
    import cv2
    from mxnet_tpu_torch.io.image_record import ImageRecordIter
    rng = np.random.RandomState(2)
    rec_path = str(tmp_path / "imgs.rec")
    rec = trec.MXRecordIO(rec_path, "w")
    for i in range(6):
        ok, buf = cv2.imencode(".png", rng.randint(0, 255, (32, 32, 3),
                                                   np.uint8))
        rec.write(trec.pack(trec.IRHeader(0, float(i % 3), i, 0),
                            buf.tobytes()))
    rec.close()
    it = ImageRecordIter(path_imgrec=rec_path, data_shape=(3, 32, 32),
                         batch_size=2)
    try:
        assert isinstance(it._rec, native.PrefetchingRecordReader)
        shapes = [b.data[0].shape for b in it]
        assert shapes == [(2, 3, 32, 32)] * 3
        it.reset()
        assert next(iter(it)).label[0].asnumpy().tolist() == [0.0, 1.0]
    finally:
        it.close()


def test_python_reader_when_native_io_off(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_USE_NATIVE_IO", "0")
    from mxnet_tpu_torch.io import native as mod
    from mxnet_tpu_torch.io.image_record import ImageRecordIter
    mod._TRIED, mod._LIB = False, None
    try:
        assert not mod.available()
        with pytest.raises(RuntimeError, match="unavailable"):
            mod.NativeRecordReader(str(tmp_path / "none.rec"))
        rec_path = str(tmp_path / "one.rec")
        rec = trec.MXRecordIO(rec_path, "w")
        rec.write(trec.pack_img(trec.IRHeader(0, 1.0, 0, 0),
                                np.zeros((8, 8, 3), np.uint8),
                                img_fmt=".png"))
        rec.close()
        it = ImageRecordIter(path_imgrec=rec_path, data_shape=(3, 8, 8),
                             batch_size=1)
        assert isinstance(it._rec, trec.MXRecordIO)
        it.close()
    finally:
        mod._TRIED, mod._LIB = False, None
