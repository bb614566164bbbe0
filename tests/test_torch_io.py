"""Port parity: ``mx.io``'s iterators against ``mxnet_tpu``, on the CPU.

``ImageRecordIter`` and ``ImageDetRecordIter`` over the same ``.rec``
with the same seed give batches EXACTLY equal to the JAX package's
(rtol = atol = 0: both decode with the same library and augment in
numpy), with shuffle, random crop, mirror, resize, mean/std and
round-batch padding; ``CSVIter``, ``MNISTIter`` over local idx files,
``ResizeIter`` and ``PrefetchingIter`` follow the JAX iterators batch for
batch; ``make_sharded_pipeline`` gives each rank of a ``dp`` mesh its
rows (two gloo ranks).
``LibSVMIter``'s csr batches are held to the JAX package's in
``tests/test_torch_sparse.py``.
"""
import gzip
import os
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

EXACT = dict(rtol=0, atol=0)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


def _write_images(mod, prefix, n, size=(36, 44), labels=None, seed=0):
    """``n`` JPEG records of smooth gradients plus noise, written by the
    package ``mod``; ``labels(i)`` gives record i's label."""
    rng = np.random.RandomState(seed)
    rec = mod.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                         "w")
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        base = np.stack([(yy * (3 + i) + xx * 2) % 256,
                         (xx * (5 + i)) % 256,
                         (yy + xx + 20 * i) % 256], axis=-1)
        img = np.clip(base + rng.randint(0, 16, (h, w, 3)), 0,
                      255).astype(np.uint8)
        label = labels(i) if labels else float(i % 4)
        rec.write_idx(i, mod.recordio.pack_img(
            mod.recordio.IRHeader(0, label, i, 0), img, quality=90))
    rec.close()


def _drain(it):
    out = []
    while True:
        try:
            out.append(it.next())
        except StopIteration:
            return out


def _arrays(batches):
    return [([d.asnumpy() for d in b.data], [lb.asnumpy() for lb in b.label],
             b.pad) for b in batches]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for a, b in zip(gd + gl, wd + wl):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_allclose(a, b, **EXACT)


_CASES = {
    "shuffle_crop_mirror_resize_norm": dict(
        shuffle=True, rand_crop=True, rand_mirror=True, resize=30,
        mean_r=123.68, mean_g=116.28, mean_b=103.53, std_r=58.395,
        std_g=57.12, std_b=57.375, seed=7),
    "center_crop_scale": dict(scale=1.0 / 255, seed=1),
    "upscale_small_images": dict(rand_crop=True, resize=20, seed=3),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_image_record_iter_matches_jax(tmp_path, case):
    kw = dict(_CASES[case])
    shape = (3, 24, 28) if case != "upscale_small_images" else (3, 32, 32)
    out = {}
    for name, mx in (("j", jmx), ("t", tmx)):
        prefix = str(tmp_path / name)
        _write_images(mx, prefix, 12)
        it = mx.io.ImageRecordIter(
            path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
            data_shape=shape, batch_size=5, preprocess_threads=2, **kw)
        epochs = [_arrays(_drain(it))]
        it.reset()
        epochs.append(_arrays(_drain(it)))
        it.close()
        out[name] = epochs
    for e in range(2):
        assert [p for _, _, p in out["t"][e]] == [0, 0, 3]
        _assert_batches_equal(out["t"][e], out["j"][e])
    # the second epoch drew anew
    assert not np.array_equal(out["t"][0][0][0][0], out["t"][1][0][0][0]) \
        or not kw.get("shuffle")


def test_image_record_iter_sequential_scan_and_label_width(tmp_path):
    out = {}
    for name, mx in (("j", jmx), ("t", tmx)):
        prefix = str(tmp_path / name)
        _write_images(mx, prefix, 7,
                      labels=lambda i: np.array([i, 2 * i], np.float32))
        # no .idx: a sequential scan, padded from the batch itself
        it = mx.io.ImageRecordIter(
            path_imgrec=prefix + ".rec", data_shape=(3, 20, 20),
            batch_size=4, label_width=2, rand_mirror=True, seed=5)
        out[name] = _arrays(_drain(it))
        it.close()
    assert [p for _, _, p in out["t"]] == [0, 1]
    assert out["t"][0][1][0].shape == (4, 2)
    _assert_batches_equal(out["t"], out["j"])
    with pytest.raises(tmx.base.MXNetError, match="idx"):
        tmx.io.ImageRecordIter(path_imgrec=str(tmp_path / "t.rec"),
                               data_shape=(3, 20, 20), batch_size=4,
                               shuffle=True)


def test_image_record_iter_round_batch_cycles_small_epoch(tmp_path):
    out = {}
    for name, mx in (("j", jmx), ("t", tmx)):
        prefix = str(tmp_path / name)
        _write_images(mx, prefix, 3)
        it = mx.io.ImageRecordIter(
            path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
            data_shape=(3, 16, 16), batch_size=8, shuffle=True, seed=2)
        out[name] = _arrays(_drain(it))
        it.close()
    assert [p for _, _, p in out["t"]] == [5]
    _assert_batches_equal(out["t"], out["j"])


def test_image_det_record_iter_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    boxes = []
    for i in range(6):
        n = 1 + i % 3
        lo = rng.uniform(0, 0.5, (n, 2))
        hi = lo + rng.uniform(0.1, 0.5, (n, 2))
        objs = np.concatenate([rng.randint(0, 5, (n, 1)), lo, hi], axis=1)
        boxes.append(objs.astype(np.float32).reshape(-1))
    out = {}
    for name, mx in (("j", jmx), ("t", tmx)):
        prefix = str(tmp_path / name)
        _write_images(mx, prefix, 6, labels=lambda i: boxes[i])
        it = mx.io.ImageDetRecordIter(
            path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
            data_shape=(3, 24, 24), batch_size=4, object_width=5,
            label_pad_width=4, shuffle=True, rand_crop=True,
            rand_mirror=True, resize=28, seed=11)
        out[name] = _arrays(_drain(it))
        assert it.provide_label[0].shape == (4, 4, 5)
        it.close()
    assert out["t"][0][1][0].shape == (4, 4, 5)
    _assert_batches_equal(out["t"], out["j"])


def test_image_det_record_iter_overflow_raises(tmp_path):
    prefix = str(tmp_path / "o")
    _write_images(tmx, prefix, 1, labels=lambda i: np.tile(
        np.array([0, .1, .1, .2, .2], np.float32), 3))
    it = tmx.io.ImageDetRecordIter(
        path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
        data_shape=(3, 20, 20), batch_size=1, object_width=5,
        label_pad_width=2)
    with pytest.raises(tmx.base.MXNetError, match="label_pad_width"):
        it.next()
    it.close()


def test_eager_next_is_decode_raw_on_the_context(tmp_path):
    prefix = str(tmp_path / "e")
    _write_images(tmx, prefix, 4)
    kw = dict(path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
              data_shape=(3, 20, 20), batch_size=2, shuffle=True,
              rand_crop=True, rand_mirror=True, seed=9)
    a = tmx.io.ImageRecordIter(**kw)
    b = tmx.io.ImageRecordIter(**kw)
    for _ in range(2):
        raw = b.decode_raw(b.next_raw())
        assert raw.data[0]._data.device.type == "cpu"
        eager = a.next()
        np.testing.assert_array_equal(eager.data[0].asnumpy(),
                                      raw.data[0].asnumpy())
    a.close()
    b.close()


# ---------------------------------------------------------------------------
# CSV / MNIST / Resize / Prefetching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_matches_jax(tmp_path, round_batch):
    rng = np.random.RandomState(0)
    data = tmp_path / "d.csv"
    label = tmp_path / "l.csv"
    np.savetxt(data, rng.randn(10, 6), delimiter=",")
    np.savetxt(label, rng.randint(0, 3, (10, 1)), delimiter=",")
    out = {}
    for name, mx in (("j", jmx), ("t", tmx)):
        it = mx.io.CSVIter(data_csv=str(data), data_shape=(2, 3),
                           label_csv=str(label), batch_size=4,
                           round_batch=round_batch)
        batches = _arrays(_drain(it))
        it.reset()
        batches += _arrays(_drain(it))
        out[name] = (batches, it.provide_data, it.provide_label)
    _assert_batches_equal(out["t"][0], out["j"][0])
    assert [(d.name, d.shape) for d in out["t"][1]] == \
        [(d.name, d.shape) for d in out["j"][1]]
    assert [(d.name, d.shape) for d in out["t"][2]] == \
        [("label", (4, 1))]


def _write_idx(path, arr, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("flat,gz", [(False, False), (True, True)])
def test_mnist_iter_matches_jax(tmp_path, flat, gz):
    rng = np.random.RandomState(1)
    img = str(tmp_path / "img-idx3-ubyte")
    lab = str(tmp_path / "lab-idx1-ubyte")
    _write_idx(img + (".gz" if gz else ""),
               rng.randint(0, 256, (20, 28, 28)), gz)
    _write_idx(lab + (".gz" if gz else ""), rng.randint(0, 10, (20,)), gz)
    out = {}
    for name, mx in (("j", jmx), ("t", tmx)):
        np.random.seed(12)
        it = mx.io.MNISTIter(image=img, label=lab, batch_size=6,
                             shuffle=True, flat=flat)
        out[name] = _arrays(_drain(it))
    assert len(out["t"]) == 3              # the last partial batch drops
    assert out["t"][0][0][0].shape == ((6, 784) if flat else (6, 1, 28, 28))
    _assert_batches_equal(out["t"], out["j"])
    with pytest.raises(tmx.base.MXNetError, match="not found"):
        tmx.io.MNISTIter(image=str(tmp_path / "none"), label=lab)


@pytest.mark.parametrize("size", [2, 7])
def test_resize_iter_matches_jax(size):
    x = np.arange(60, dtype=np.float32).reshape(20, 3)
    y = np.arange(20, dtype=np.float32)
    out = {}
    for name, mx in (("j", jmx), ("t", tmx)):
        it = mx.io.ResizeIter(mx.io.NDArrayIter(x, y, batch_size=6), size)
        out[name] = _arrays(_drain(it))
        it.reset()
        assert len(_drain(it)) == size
    assert len(out["t"]) == size
    _assert_batches_equal(out["t"], out["j"])


def test_prefetching_iter_matches_jax():
    x = np.random.RandomState(2).randn(30, 4).astype(np.float32)
    y = np.arange(30, dtype=np.float32)
    out = {}
    for name, mx in (("j", jmx), ("t", tmx)):
        pre = mx.io.PrefetchingIter(
            [mx.io.NDArrayIter(x, y, batch_size=8),
             mx.io.NDArrayIter(2 * x, y, batch_size=8)],
            rename_data=[{"data": "a"}, {"data": "b"}], prefetch_depth=3)
        try:
            out[name] = (_arrays(_drain(pre)),
                         [d.name for d in pre.provide_data])
            pre.reset()
            assert len(_drain(pre)) == 4
        finally:
            pre.close()
    assert out["t"][1] == ["a", "b"]
    _assert_batches_equal(out["t"][0], out["j"][0])


def test_ndarray_iter_host_view_is_not_a_copy():
    from mxnet_tpu_torch.io.io import _as_host_view
    x = np.arange(6, dtype=np.float32)
    assert _as_host_view(x) is x
    nd = tmx.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
    view = _as_host_view(nd)
    nd._data[0, 0] = 100.0
    assert view[0, 0] == 100.0
    it = tmx.io.NDArrayIter(nd, batch_size=3)
    assert np.shares_memory(it.data[0][1], view)


def test_ndarray_iter_split_protocol_matches_next():
    x = np.random.RandomState(3).randn(11, 2).astype(np.float32)
    np.random.seed(4)
    a = tmx.io.NDArrayIter(x, np.arange(11), batch_size=4, shuffle=True)
    np.random.seed(4)
    b = tmx.io.NDArrayIter(x, np.arange(11), batch_size=4, shuffle=True)
    got = [b.decode_raw(b.next_raw()) for _ in range(3)]
    with pytest.raises(StopIteration):
        b.next_raw()
    want = _drain(a)
    _assert_batches_equal(_arrays(got), _arrays(want))
    assert got[-1].pad == 1
    assert got[0].label[0].dtype == np.int32


@pytest.mark.parametrize("world", [1, 2])
def test_unported_iterators_raise(tmp_path, world):
    """``make_sharded_pipeline`` is ported: each rank of a ``dp`` mesh gets
    its rows of every batch-divisible array, marked as placed (on two
    gloo ranks through ``torch_mesh_ranks``; a world of one keeps every
    row)."""
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    y = np.arange(8, dtype=np.float32)
    if world == 1:
        from mxnet_tpu_torch import parallel as tpar
        pipe = tmx.io.make_sharded_pipeline(
            tmx.io.NDArrayIter(x, y, batch_size=4), tpar.local_mesh("dp"))
        got = list(pipe)
        np.testing.assert_array_equal(
            np.concatenate([b.data[0].asnumpy() for b in got]), x)
        assert all(b.data[0]._dp_local for b in got)
        return
    import torch_mesh_ranks as h
    ranks = h.spawn(tmp_path, "pipeline", world)
    assert not h.errors(ranks, "")
    for r, res in enumerate(ranks):
        rows = [b * 4 + r * 2 + i for b in range(2) for i in range(2)]
        np.testing.assert_array_equal(res["pipe/data"].reshape(-1, 3),
                                      x[rows])
        np.testing.assert_array_equal(res["pipe/label"].reshape(-1), y[rows])
        assert res["pipe/marked"] == [True, True]
        assert res["pipe/whole"] == "cpu"
