"""Port parity: ``gluon.data`` (datasets, samplers, the DataLoader and
``vision.transforms``) against ``mxnet_tpu``, on the CPU.

Samplers and loaders draw their shuffles from numpy's global generator
in both packages, so a seeded run yields the same batches, which must be
equal exactly. The transforms agree within ``TOL``, ``Resize``'s
bilinear within ``RESIZE_TOL`` (antialiased filters summed in another
order; on uint8 images, whose float result is truncated, within one
level) and the random transforms take the same numpy draws.
``device_prefetch`` places through the async input pipeline (on
``cpu()`` here), accounts the copies under h2d and leaves no thread.
"""
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu_torch.gluon import data as tdata

TOL = dict(rtol=1e-5, atol=1e-5)
RESIZE_TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


def _np(v):
    return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)


def _batches(loader):
    out = []
    for b in loader:
        parts = b if isinstance(b, (list, tuple)) else [b]
        out.append([_np(p) for p in parts])
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_datasets_match_jax():
    x = np.random.RandomState(0).randn(10, 3).astype(np.float32)
    y = np.arange(10, dtype=np.float32)
    views = {}
    for name, mx, data in (("j", jmx, jdata), ("t", tmx, tdata)):
        ds = data.ArrayDataset(x, mx.nd.array(y))
        doubled = ds.transform_first(lambda a: a * 2)
        kept = data.SimpleDataset(list(range(10))).filter(
            lambda i: i % 3 == 0)
        views[name] = ([_np(v) for v in ds[4]],
                       [_np(v) for v in doubled[7]],
                       list(kept), len(ds.take(4)),
                       [_np(v) for v in ds.transform(
                           lambda a, b: (a + b, b), lazy=False)[2]])
    (jv, tv) = views["j"], views["t"]
    for a, b in zip(tv[0] + tv[1] + tv[4], jv[0] + jv[1] + jv[4]):
        np.testing.assert_array_equal(a, b)
    assert tv[2] == jv[2] == [0, 3, 6, 9]
    assert tv[3] == jv[3] == 4
    with pytest.raises(AssertionError, match="same length"):
        tdata.ArrayDataset(x, y[:3])


def test_record_file_dataset_reads_jax_files(tmp_path):
    prefix = str(tmp_path / "r")
    rec = jmx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                         "w")
    for i in range(5):
        rec.write_idx(i, b"record-%d" % i * (i + 1))
    rec.close()
    tds = tdata.RecordFileDataset(prefix + ".rec")
    jds = jdata.RecordFileDataset(prefix + ".rec")
    assert len(tds) == len(jds) == 5
    assert [tds[i] for i in range(5)] == [jds[i] for i in range(5)]
    # the DataLoader's threads read one handle: the reads stay whole
    loader = tdata.DataLoader(tds, batch_size=1, num_workers=4,
                              batchify_fn=lambda s: s[0])
    assert list(loader) == [jds[i] for i in range(5)]


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_match_jax(last_batch):
    got = {}
    for name, data in (("j", jdata), ("t", tdata)):
        np.random.seed(7)
        bs = data.BatchSampler(data.RandomSampler(11), 4, last_batch)
        epochs = [list(bs) for _ in range(3)]
        got[name] = (epochs, len(bs),
                     list(data.SequentialSampler(5)))
    assert got["t"] == got["j"]
    with pytest.raises(ValueError, match="last_batch"):
        list(tdata.BatchSampler(tdata.SequentialSampler(3), 2, "pad"))


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_dataloader_matches_jax(workers, last_batch):
    x = np.random.RandomState(1).randn(23, 2, 3).astype(np.float32)
    y = np.arange(23, dtype=np.int32)
    got = {}
    for name, mx, data in (("j", jmx, jdata), ("t", tmx, tdata)):
        np.random.seed(11)
        loader = data.DataLoader(data.ArrayDataset(x, y), batch_size=5,
                                 shuffle=True, last_batch=last_batch,
                                 num_workers=workers)
        got[name] = (_batches(loader) + _batches(loader), len(loader))
    assert got["t"][1] == got["j"][1]
    _assert_same(got["t"][0], got["j"][0])


def test_dataloader_keeps_int64_labels():
    # nd.array(dtype=int64) keeps int64 in the port; the JAX package,
    # without jax's x64 mode, stores int32
    y = np.arange(4, dtype=np.int64)
    (batch,) = _batches(tdata.DataLoader(tdata.ArrayDataset(y),
                                         batch_size=4))
    assert batch[0].dtype == np.int64


def test_dataloader_batchify_of_ndarray_samples_matches_jax():
    x = np.random.RandomState(2).randn(6, 4).astype(np.float32)
    got = {}
    for name, mx, data in (("j", jmx, jdata), ("t", tmx, tdata)):
        ds = data.SimpleDataset([mx.nd.array(r) for r in x])
        got[name] = _batches(data.DataLoader(ds, batch_size=4))
    _assert_same(got["t"], got["j"])
    with pytest.raises(ValueError, match="batch_size"):
        tdata.DataLoader(tdata.SimpleDataset([1]))


def test_device_prefetch_places_accounts_and_leaves_no_threads():
    from mxnet_tpu_torch import telemetry
    baseline = threading.active_count()
    x = np.random.RandomState(0).randn(24, 4).astype(np.float32)
    y = np.arange(24, dtype=np.float32)
    telemetry.reset()
    telemetry.start(run_id="loader")
    try:
        loader = tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=6,
                                  num_workers=2, device_prefetch=True)
        placed = []
        for data, label in loader:
            assert data._data.device.type == "cpu"
            placed.append((data.asnumpy(), label.asnumpy()))
        plain = [(d.asnumpy(), lb.asnumpy()) for d, lb in tdata.DataLoader(
            tdata.ArrayDataset(x, y), batch_size=6)]
    finally:
        rep = telemetry.stop()
        telemetry.reset()
    assert len(placed) == 4
    for (a, b), (c, d) in zip(placed, plain):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert rep["comms"] == {
        "h2d:data": {"calls": 4, "bytes": 4 * 6 * 4 * 4,
                     "time_ms": rep["comms"]["h2d:data"]["time_ms"]},
        "h2d:label": {"calls": 4, "bytes": 4 * 6 * 4,
                      "time_ms": rep["comms"]["h2d:label"]["time_ms"]}}
    deadline = time.time() + 5
    while threading.active_count() > baseline and time.time() < deadline:
        time.sleep(0.02)
    assert threading.active_count() <= baseline


def test_device_prefetch_stops_cleanly_mid_epoch():
    baseline = threading.active_count()
    x = np.zeros((40, 2), np.float32)
    loader = tdata.DataLoader(tdata.ArrayDataset(x, x), batch_size=4,
                              num_workers=2, device_prefetch=tmx.cpu())
    it = iter(loader)
    next(it)
    it.close()                     # the consumer stops after one batch
    deadline = time.time() + 5
    while threading.active_count() > baseline and time.time() < deadline:
        time.sleep(0.02)
    assert threading.active_count() <= baseline


# ---------------------------------------------------------------------------
# vision.transforms
# ---------------------------------------------------------------------------

def _image(seed=0, shape=(20, 30, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def _both(build, img, seed=0, dtype="uint8"):
    """``build(mx)``'s transform applied to ``img`` in each package from
    the same numpy seed."""
    out = []
    for mx in (jmx, tmx):
        t = build(mx)
        np.random.seed(seed)
        out.append(_np(t(mx.nd.array(img, dtype=dtype))))
    return out


def _T(mx):
    return mx.gluon.data.vision.transforms


@pytest.mark.parametrize("name,build", [
    ("to_tensor", lambda mx: _T(mx).ToTensor()),
    ("cast", lambda mx: _T(mx).Cast("float32")),
    ("center_crop", lambda mx: _T(mx).CenterCrop((12, 9))),
    ("crop_resize", lambda mx: _T(mx).CropResize(3, 2, 10, 8)),
    ("flip_lr", lambda mx: _T(mx).RandomFlipLeftRight()),
    ("flip_tb", lambda mx: _T(mx).RandomFlipTopBottom()),
    ("brightness", lambda mx: _T(mx).RandomBrightness(0.4)),
    ("contrast", lambda mx: _T(mx).RandomContrast(0.4)),
    ("saturation", lambda mx: _T(mx).RandomSaturation(0.4)),
    ("hue", lambda mx: _T(mx).RandomHue(0.2)),
    ("jitter", lambda mx: _T(mx).RandomColorJitter(0.3, 0.3, 0.3, 0.1)),
    ("lighting", lambda mx: _T(mx).RandomLighting(0.1)),
    ("gray", lambda mx: _T(mx).RandomGray(0.5)),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_transforms_match_jax(name, build, seed):
    j, t = _both(build, _image(seed), seed=seed)
    assert t.shape == j.shape and t.dtype == j.dtype
    np.testing.assert_allclose(t, j, **TOL)


def test_normalize_and_compose_match_jax():
    def build(mx):
        T = _T(mx)
        return T.Compose([T.Cast("float32"), T.ToTensor(),
                          T.Normalize((0.4, 0.5, 0.6), (0.2, 0.25, 0.3))])
    j, t = _both(build, _image(3))
    assert t.shape == (3, 20, 30)
    np.testing.assert_allclose(t, j, **TOL)
    batch = np.stack([_image(4), _image(5)]).astype(np.float32) / 255
    batch = batch.transpose(0, 3, 1, 2)
    outs = [_np(_T(mx).Normalize(0.5, 0.25)(mx.nd.array(batch)))
            for mx in (jmx, tmx)]
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


@pytest.mark.parametrize("size,keep,interp", [
    (12, False, 1), ((40, 26), False, 1), (16, True, 1), (18, False, 0),
    ((45, 33), False, 0)])
def test_resize_matches_jax(size, keep, interp):
    build = lambda mx: _T(mx).Resize(size, keep_ratio=keep,  # noqa: E731
                                     interpolation=interp)
    img = _image(6)
    j, t = _both(build, img.astype(np.float32), dtype="float32")
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, **RESIZE_TOL)
    ju, tu = _both(build, img)
    assert tu.dtype == ju.dtype == np.uint8
    assert np.abs(tu.astype(int) - ju.astype(int)).max() <= 1


def test_random_resized_crop_matches_jax():
    build = lambda mx: _T(mx).RandomResizedCrop(  # noqa: E731
        14, scale=(0.3, 1.0))
    for seed in range(3):
        j, t = _both(build, _image(seed, (32, 40, 3)).astype(np.float32),
                     seed=seed, dtype="float32")
        assert t.shape == (14, 14, 3)
        np.testing.assert_allclose(t, j, **RESIZE_TOL)


def test_transforms_in_a_loader_match_jax():
    imgs = np.stack([_image(i, (16, 16, 3)) for i in range(6)])
    labels = np.arange(6, dtype=np.float32)
    got = {}
    for name, mx, data in (("j", jmx, jdata), ("t", tmx, tdata)):
        T = _T(mx)
        tf = T.Compose([T.RandomFlipLeftRight(), T.ToTensor(),
                        T.Normalize(0.5, 0.2)])
        ds = data.ArrayDataset(mx.nd.array(imgs, dtype="uint8"),
                               labels).transform_first(tf)
        np.random.seed(9)
        got[name] = _batches(data.DataLoader(ds, batch_size=4))
    assert got["t"][0][0].shape == (4, 3, 16, 16)
    for g, w in zip(got["t"], got["j"]):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, **TOL)
