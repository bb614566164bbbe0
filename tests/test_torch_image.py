"""``mx.image`` of the port (``mxnet_tpu_torch/image``) against the JAX
package's (``mxnet_tpu/image``) on the CPU, over files and records this
test writes: ``imdecode``/``imread`` bit for bit; ``imresize`` (the
antialiased bilinear resize) at float32 rounding, and on a uint8 image
within one level, since both packages truncate a float32 result that
the two resizes round differently by ~1e-5 (``jax.image.resize`` and
torch's antialiased ``interpolate`` sum their weights in other orders);
every augmenter, ``CreateAugmenter``'s and ``CreateDetAugmenter``'s lists
under one ``random.seed`` (the same draws in the same order);
``ImageIter`` over a ``.rec`` and a ``.lst`` and ``ImageDetIter`` over a
``.rec`` with random crops, pads and mirrors: equal labels, and images
equal at float32 rounding of the resize. Then the JAX suite's own
scenarios (``tests/test_image_detection.py``) on the port."""
import io as _io
import os
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.image.detection import (
    DetBorrowAug, DetHorizontalFlipAug, DetRandomCropAug, DetRandomPadAug,
    DetRandomSelectAug, CreateDetAugmenter, CreateMultiRandCropAugmenter,
    ImageDetIter, _crop_boxes)
from mxnet_tpu_torch.image.image import CastAug

cv2 = pytest.importorskip("cv2")

TOL = dict(rtol=1e-5, atol=1e-4)         # values up to 255


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


def _rgb(seed, h=40, w=60):
    """A smooth image with flat patches (JPEG-friendly, resize ties)."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 4 + rs.randint(0, 40)) % 256,
                    (yy * 5 + rs.randint(0, 40)) % 256,
                    rs.randint(0, 256, (h, w)) // 32 * 32], -1)
    img[:h // 3, :w // 3] = 142
    return img.astype(np.uint8)


def _jpeg(img):
    ok, buf = cv2.imencode(".jpg", img[:, :, ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, 95])
    assert ok
    return buf.tobytes()


def _arr(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def test_imdecode_and_imread_equal_jax(tmp_path):
    buf = _jpeg(_rgb(0))
    path = str(tmp_path / "a.jpg")
    with open(path, "wb") as f:
        f.write(buf)
    for flag in (1, 0):
        got = tmx.image.imdecode(buf, flag=flag)
        want = jmx.image.imdecode(buf, flag=flag)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
        np.testing.assert_array_equal(
            tmx.image.imread(path, flag).asnumpy(),
            jmx.image.imread(path, flag).asnumpy())


@pytest.mark.parametrize("size", [(30, 20), (75, 52), (60, 40), (17, 61)])
def test_imresize_matches_jax(size):
    img = _rgb(1)
    f32 = img.astype(np.float32)
    got = tmx.image.imresize(tmx.nd.array(f32), *size)
    want = jmx.image.imresize(jmx.nd.array(f32), *size)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
    g8 = tmx.image.imresize(tmx.nd.array(img, dtype=np.uint8), *size)
    w8 = jmx.image.imresize(jmx.nd.array(img, dtype=np.uint8), *size)
    assert g8.dtype == w8.dtype == np.uint8
    diff = np.abs(g8.asnumpy().astype(int) - w8.asnumpy().astype(int))
    assert diff.max() <= 1
    # nearest
    np.testing.assert_array_equal(
        tmx.image.imresize(tmx.nd.array(f32), *size, interp=0).asnumpy(),
        jmx.image.imresize(jmx.nd.array(f32), *size, interp=0).asnumpy())


def _augs(mx):
    im = mx.image
    mean, std = [123.68, 116.28, 103.53], [58.4, 57.1, 57.4]

    return [im.ResizeAug(32), im.ForceResizeAug((50, 30)),
            im.RandomCropAug((30, 20)), im.CenterCropAug((30, 20)),
            im.HorizontalFlipAug(0.5), im.CastAug(),
            im.ColorNormalizeAug(mean, std), im.BrightnessJitterAug(0.3),
            im.ContrastJitterAug(0.3), im.SaturationJitterAug(0.3)]


@pytest.mark.parametrize("k", range(10))
def test_each_augmenter_draws_like_jax(k):
    img = _rgb(2).astype(np.float32)
    out = {}
    for mx in (tmx, jmx):
        random.seed(11)
        aug = _augs(mx)[k]
        res = [_arr(aug(mx.nd.array(img))) for _ in range(4)]
        out[mx] = res + [aug.dumps()]
    for g, w in zip(out[tmx][:-1], out[jmx][:-1]):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, **TOL)
    assert out[tmx][-1] == out[jmx][-1]


def test_create_augmenter_list_draws_like_jax():
    img = _rgb(3).astype(np.float32)
    kw = dict(resize=36, rand_crop=True, rand_mirror=True, mean=True,
              std=True, brightness=0.2, contrast=0.2, saturation=0.2)
    out = {}
    for mx in (tmx, jmx):
        random.seed(5)
        augs = mx.image.CreateAugmenter((3, 24, 30), **kw)
        res = []
        for _ in range(3):
            x = mx.nd.array(img)
            for a in augs:
                x = a(x)
            res.append(_arr(x))
        out[mx] = ([type(a).__name__ for a in augs], res)
    assert out[tmx][0] == out[jmx][0]
    for g, w in zip(out[tmx][1], out[jmx][1]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)


def _write_rec(mx, prefix, labels, det=False, size=(40, 60)):
    """An indexed .rec of JPEGs (and a .lst of the same files) with
    ``labels``; returns (rec path, lst path)."""
    rec = mx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                        "w")
    lines = []
    for i, lab in enumerate(labels):
        img = _rgb(10 + i, *size)
        buf = _jpeg(img)
        rec.write_idx(i, mx.recordio.pack(
            mx.recordio.IRHeader(0, np.asarray(lab, np.float32), i, 0), buf))
        name = "img%d.jpg" % i
        with open(os.path.join(os.path.dirname(prefix), name), "wb") as f:
            f.write(buf)
        lab = np.atleast_1d(lab)
        lines.append("\t".join([str(i)] + ["%g" % v for v in lab] + [name]))
    rec.close()
    with open(prefix + ".lst", "w") as f:
        f.write("\n".join(lines) + "\n")
    return prefix + ".rec", prefix + ".lst"


@pytest.mark.parametrize("source", ["rec", "lst"])
def test_image_iter_like_jax(tmp_path, source):
    rec, lst = _write_rec(tmx, str(tmp_path / "cls"), [float(i % 3)
                                                       for i in range(6)])
    out = {}
    for mx in (tmx, jmx):
        random.seed(3)
        kw = dict(path_imgrec=rec) if source == "rec" else \
            dict(path_imglist=lst, path_root=str(tmp_path))
        it = mx.image.ImageIter(batch_size=3, data_shape=(3, 28, 28),
                                shuffle=True, rand_crop=True,
                                rand_mirror=True, resize=32, **kw)
        batches = []
        for _ in range(2):
            it.reset()
            for b in it:
                batches.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
        out[mx] = (batches, it.provide_data[0].shape,
                   it.provide_label[0].shape)
    assert out[tmx][1:] == out[jmx][1:]
    assert len(out[tmx][0]) == len(out[jmx][0]) == 4
    for (gd, gl), (wd, wl) in zip(out[tmx][0], out[jmx][0]):
        np.testing.assert_array_equal(gl, wl)
        # the shorter side's uint8 resize: a truncated level either way
        assert np.abs(gd - wd).max() <= 1.0


def test_image_det_iter_over_a_rec_like_jax(tmp_path):
    rs = np.random.RandomState(4)
    labels = []
    for i in range(8):
        k = 1 + i % 3
        objs = np.zeros((k, 6), np.float32)
        objs[:, 0] = rs.randint(0, 4, k)
        lo = rs.uniform(0.05, 0.5, (k, 2))
        objs[:, 1:3] = lo
        objs[:, 3:5] = lo + rs.uniform(0.1, 0.45, (k, 2))
        objs[:, 5] = i % 2
        labels.append(np.concatenate([[2, 6], objs.reshape(-1)]))
    rec, _ = _write_rec(tmx, str(tmp_path / "det"), labels)
    out = {}
    for mx in (tmx, jmx):
        random.seed(9)
        it = mx.image.ImageDetIter(
            batch_size=4, data_shape=(3, 32, 32), path_imgrec=rec,
            shuffle=True, rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
            mean=True, std=True)
        res = []
        for _ in range(2):
            it.reset()
            for b in it:
                res.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
        out[mx] = (res, it.label_shape, [a.dumps() for a in it.auglist])
    assert out[tmx][1] == out[jmx][1] == (3, 6)
    assert out[tmx][2] == out[jmx][2]
    for (gd, gl), (wd, wl) in zip(out[tmx][0], out[jmx][0]):
        np.testing.assert_allclose(gl, wl, rtol=1e-6, atol=1e-7)
        assert (gl[..., 0] == -1).any()               # -1 padding rows
        np.testing.assert_allclose(gd, wd, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("det", [False, True])
def test_iter_batch_crosses_to_the_card_once(tmp_path, monkeypatch, det):
    """Decoding and augmenting stay on ``cpu()``: under a ``gpu(0)``
    scope, one ``next()`` makes exactly two arrays on the default
    context, its data and its labels (recorded here, and made on the CPU
    in their place), and nothing else reaches the scope's device."""
    if det:
        labels = [np.array([2, 5, i % 3, 0.1, 0.1, 0.6, 0.7], np.float32)
                  for i in range(4)]
    else:
        labels = [float(i % 3) for i in range(4)]
    rec, _ = _write_rec(tmx, str(tmp_path / "once"), labels)
    made, real = [], tmx.nd.array

    def array(source, ctx=None, dtype=None):
        if ctx is None or ctx.device_type != "cpu":
            made.append(np.shape(source))
            ctx = tmx.cpu()
        return real(source, ctx=ctx, dtype=dtype)
    monkeypatch.setattr(tmx.nd, "array", array)
    random.seed(5)
    with tmx.gpu(0):
        if det:
            it = tmx.image.ImageDetIter(
                batch_size=4, data_shape=(3, 32, 32), path_imgrec=rec,
                rand_crop=0.5, rand_pad=0.5, rand_mirror=True, mean=True,
                std=True)
        else:
            it = tmx.image.ImageIter(
                batch_size=4, data_shape=(3, 28, 28), path_imgrec=rec,
                rand_crop=True, rand_mirror=True, resize=32, mean=True,
                std=True, brightness=0.2, contrast=0.2, saturation=0.2)
        made.clear()
        batch = it.next()
    assert made == [(4, 3) + batch.data[0].shape[2:],
                    batch.label[0].shape]
    assert np.isfinite(batch.data[0].asnumpy()).all()


# --- the JAX suite's scenarios (tests/test_image_detection.py) on the port

def _img(h=40, w=60):
    rng = np.random.RandomState(0)
    return rng.randint(0, 255, (h, w, 3)).astype(np.float32)


LABEL = np.array([[1, 0.25, 0.25, 0.75, 0.75],
                  [0, 0.10, 0.60, 0.30, 0.90]], np.float32)


def test_flip_box_geometry():
    aug = DetHorizontalFlipAug(p=1.0)
    img, lab = aug(_img(), LABEL)
    np.testing.assert_allclose(lab[0, 1:5], [0.25, 0.25, 0.75, 0.75])
    np.testing.assert_allclose(lab[1, 1:5], [0.70, 0.60, 0.90, 0.90],
                               atol=1e-6)
    assert lab[0, 0] == 1 and lab[1, 0] == 0
    img2, lab2 = aug(img, lab)
    np.testing.assert_allclose(lab2, LABEL, atol=1e-6)
    np.testing.assert_allclose(img2, _img())


def test_crop_boxes_clip_and_eject():
    out = _crop_boxes(LABEL, 0, 0, 30, 40, 60, 40, min_eject_coverage=0.3)
    assert out[0, 0] == 1
    np.testing.assert_allclose(out[0, 1:5], [0.5, 0.25, 1.0, 0.75],
                               atol=1e-6)
    np.testing.assert_allclose(out[1, 1:5], [0.2, 0.6, 0.6, 0.9], atol=1e-6)
    out2 = _crop_boxes(LABEL, 0, 0, 16, 40, 60, 40, min_eject_coverage=0.3)
    assert out2[0, 0] == -1 and out2[1, 0] == 0


def test_random_crop_respects_min_object_covered():
    aug = DetRandomCropAug(min_object_covered=0.5, area_range=(0.2, 0.8),
                           max_attempts=200)
    found = False
    for _ in range(20):
        img, lab = aug(_img(), LABEL)
        if img.shape != _img().shape:
            found = True
            valid = lab[lab[:, 0] >= 0]
            assert valid.size
            assert np.all(valid[:, 3] > valid[:, 1])
            assert np.all(valid[:, 4] > valid[:, 2])
    assert found


def test_random_pad_shrinks_boxes():
    img, lab = DetRandomPadAug(area_range=(1.5, 2.5),
                               max_attempts=100)(_img(), LABEL)
    assert img.shape[0] >= 40 and img.shape[1] >= 60
    valid = lab[lab[:, 0] >= 0]

    def areas(a):
        return (a[:, 3] - a[:, 1]) * (a[:, 4] - a[:, 2])
    assert np.all(areas(valid) < areas(LABEL) + 1e-6) and img.min() >= 0


def test_select_and_borrow():
    sel = DetRandomSelectAug([DetHorizontalFlipAug(1.0)], skip_prob=1.0)
    np.testing.assert_allclose(sel(_img(), LABEL)[1], LABEL)
    np.testing.assert_allclose(DetBorrowAug(CastAug())(_img(), LABEL)[1],
                               LABEL)


def test_create_det_augmenter_runs():
    augs = CreateDetAugmenter((3, 32, 48), rand_crop=0.5, rand_pad=0.5,
                              rand_mirror=True, mean=True, std=True)
    img, lab = _img(), LABEL.copy()
    for a in augs:
        img, lab = a(img, lab)
    assert np.asarray(_arr(img)).shape[:2] == (32, 48)
    valid = lab[lab[:, 0] >= 0]
    assert np.all((valid[:, 1:5] >= 0) & (valid[:, 1:5] <= 1))


def test_multi_rand_crop_broadcasts_params():
    sel = CreateMultiRandCropAugmenter(
        min_object_covered=[0.1, 0.5], aspect_ratio_range=(0.75, 1.33),
        area_range=[(0.1, 1.0), (0.3, 1.0)])
    assert len(sel.aug_list) == 2
    assert sel.aug_list[1].min_object_covered == 0.5


def test_image_det_iter_end_to_end(tmp_path):
    rng = np.random.RandomState(3)
    files = []
    for i in range(4):
        name = "img%d.png" % i
        cv2.imwrite(str(tmp_path / name),
                    rng.randint(0, 255, (40, 60, 3), np.uint8))
        files.append(name)
    imglist = [
        [2, 5, 1, 0.1, 0.1, 0.5, 0.5, files[0]],
        [2, 5, 0, 0.2, 0.2, 0.8, 0.9, 1, 0.0, 0.0, 0.3, 0.3, files[1]],
        [2, 5, 2, 0.4, 0.1, 0.9, 0.6, files[2]],
        [2, 5, 1, 0.3, 0.3, 0.6, 0.8, files[3]],
    ]
    it = ImageDetIter(batch_size=2, data_shape=(3, 32, 32), imglist=imglist,
                      path_root=str(tmp_path), rand_mirror=True)
    assert it.provide_label[0].shape == (2, 2, 5)
    batch = it.next()
    assert batch.data[0].shape == (2, 3, 32, 32)
    assert batch.label[0].asnumpy()[0, 1, 0] == -1
    it.next()
    with pytest.raises(StopIteration):
        it.next()
    it.reset()
    img = next(it.draw_next())
    assert img.shape == (32, 32, 3) and img.dtype == np.uint8
    it2 = ImageDetIter(batch_size=2, data_shape=(3, 32, 32),
                       imglist=imglist[:2], path_root=str(tmp_path))
    it2.label_shape = (5, 6)
    assert it.sync_label_shape(it2) == (5, 6) and it.label_shape == (5, 6)


def test_image_det_iter_record_label_shape(tmp_path):
    rng = np.random.RandomState(5)
    rec_path = str(tmp_path / "det.rec")
    rec = tmx.recordio.MXRecordIO(rec_path, "w")
    labels = [[2.0, 6.0] + sum(([float(c % 3), 0.1, 0.1, 0.6, 0.7, 0.0]
                                for c in range(17)), []),
              [2.0, 6.0, 1.0, 0.2, 0.2, 0.8, 0.9, 1.0]]
    for i, lab in enumerate(labels):
        ok, buf = cv2.imencode(".png", rng.randint(0, 255, (40, 60, 3),
                                                   np.uint8))
        rec.write(tmx.recordio.pack(
            tmx.recordio.IRHeader(0, np.asarray(lab, np.float32), i, 0),
            buf.tobytes()))
    rec.close()
    it = ImageDetIter(batch_size=2, data_shape=(3, 32, 32),
                      path_imgrec=rec_path)
    assert it.label_shape == (17, 6)
    lab = it.next().label[0].asnumpy()
    assert lab.shape == (2, 17, 6)
    assert int((lab[0, :, 0] >= 0).sum()) == 17 and lab[1, 1, 0] == -1
