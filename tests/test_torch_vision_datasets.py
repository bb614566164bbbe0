"""``gluon.data.vision``'s datasets of the port
(``mxnet_tpu_torch/gluon/data/vision/datasets.py``) against the JAX
package's, over files this test writes: MNIST and FashionMNIST idx files
(plain and gzipped), CIFAR-10's and CIFAR-100's pickled batches, an image
folder and a ``.rec``. Every item (image values and dtype, label) and
length must be equal, transforms apply alike, and a missing file raises
``MXNetError`` in both, with nothing downloaded."""
import gzip
import os
import pickle
import struct

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

cv2 = pytest.importorskip("cv2")


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


def _val(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same_items(got_ds, want_ds):
    assert len(got_ds) == len(want_ds)
    for i in range(len(want_ds)):
        got, want = got_ds[i], want_ds[i]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            g, w = _val(g), _val(w)
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def _idx(path, arr, gz):
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    with (gzip.open if gz else open)(path + (".gz" if gz else ""),
                                     "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("cls", ["MNIST", "FashionMNIST"])
def test_mnist_idx(tmp_path, cls, gz):
    rs = np.random.RandomState(0)
    for prefix, n in (("train", 7), ("t10k", 3)):
        _idx(str(tmp_path / ("%s-images-idx3-ubyte" % prefix)),
             rs.randint(0, 256, (n, 28, 28)), gz)
        _idx(str(tmp_path / ("%s-labels-idx1-ubyte" % prefix)),
             rs.randint(0, 10, n), gz)
    for train in (True, False):
        got = getattr(tmx.gluon.data.vision, cls)(str(tmp_path), train=train)
        want = getattr(jmx.gluon.data.vision, cls)(str(tmp_path),
                                                   train=train)
        _same_items(got, want)
        assert len(got) == (7 if train else 3)


def _cifar(root, name, batches, fine):
    rs = np.random.RandomState(len(name))
    os.makedirs(root, exist_ok=True)
    for b in batches:
        d = {"data": rs.randint(0, 256, (4, 3072)).astype(np.uint8)}
        if fine:
            d["fine_labels"] = rs.randint(0, 100, 4).tolist()
            d["coarse_labels"] = rs.randint(0, 20, 4).tolist()
        else:
            d["labels"] = rs.randint(0, 10, 4).tolist()
        with open(os.path.join(root, b), "wb") as f:
            pickle.dump(d, f)


def test_cifar10(tmp_path):
    _cifar(str(tmp_path / "cifar-10-batches-py"), "c10",
           ["data_batch_%d" % i for i in range(1, 6)] + ["test_batch"], False)
    for train in (True, False):
        _same_items(tmx.gluon.data.vision.CIFAR10(str(tmp_path), train=train),
                    jmx.gluon.data.vision.CIFAR10(str(tmp_path), train=train))


@pytest.mark.parametrize("fine", [False, True])
def test_cifar100(tmp_path, fine):
    _cifar(str(tmp_path), "c100", ["train", "test"], True)
    for train in (True, False):
        _same_items(
            tmx.gluon.data.vision.CIFAR100(str(tmp_path), fine_label=fine,
                                           train=train),
            jmx.gluon.data.vision.CIFAR100(str(tmp_path), fine_label=fine,
                                           train=train))


def test_image_folder_with_a_transform(tmp_path):
    rs = np.random.RandomState(1)
    for cls in ("cat", "dog"):
        os.makedirs(tmp_path / cls)
        for i in range(2):
            cv2.imwrite(str(tmp_path / cls / ("%d.png" % i)),
                        rs.randint(0, 256, (9, 11, 3), np.uint8))
    (tmp_path / "dog" / "notes.txt").write_text("not an image")
    (tmp_path / "stray.jpg").write_bytes(b"")
    with pytest.warns(UserWarning):
        got = tmx.gluon.data.vision.ImageFolderDataset(str(tmp_path))
    with pytest.warns(UserWarning):
        want = jmx.gluon.data.vision.ImageFolderDataset(str(tmp_path))
    assert got.synsets == want.synsets == ["cat", "dog"]
    _same_items(got, want)
    for flag in (0, 1):
        _same_items(
            tmx.gluon.data.vision.ImageFolderDataset(
                str(tmp_path / "cat/.."), flag=flag,
                transform=lambda x, y: (x.astype("float32") / 2, y + 1)),
            jmx.gluon.data.vision.ImageFolderDataset(
                str(tmp_path / "cat/.."), flag=flag,
                transform=lambda x, y: (x.astype("float32") / 2, y + 1)))


def test_image_record_dataset(tmp_path):
    rs = np.random.RandomState(2)
    prefix = str(tmp_path / "imgs")
    rec = tmx.recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec",
                                         "w")
    for i in range(5):
        ok, buf = cv2.imencode(".png", rs.randint(0, 256, (8, 10, 3),
                                                  np.uint8))
        rec.write_idx(i, tmx.recordio.pack(
            tmx.recordio.IRHeader(0, float(i % 3), i, 0), buf.tobytes()))
    rec.close()
    for flag in (1, 0):
        _same_items(
            tmx.gluon.data.vision.ImageRecordDataset(prefix + ".rec", flag),
            jmx.gluon.data.vision.ImageRecordDataset(prefix + ".rec", flag))


@pytest.mark.parametrize("cls,kw", [
    ("MNIST", {}), ("FashionMNIST", {"train": False}), ("CIFAR10", {}),
    ("CIFAR100", {"train": False})])
def test_a_missing_file_raises_as_in_jax(tmp_path, cls, kw):
    for mx in (tmx, jmx):
        with pytest.raises(mx.base.MXNetError):
            getattr(mx.gluon.data.vision, cls)(str(tmp_path / "none"), **kw)


def test_the_datasets_load_through_a_data_loader(tmp_path):
    rs = np.random.RandomState(3)
    _idx(str(tmp_path / "train-images-idx3-ubyte"),
         rs.randint(0, 256, (6, 28, 28)), False)
    _idx(str(tmp_path / "train-labels-idx1-ubyte"), rs.randint(0, 10, 6),
         False)
    ds = tmx.gluon.data.vision.MNIST(str(tmp_path)).transform_first(
        tmx.gluon.data.vision.transforms.ToTensor())
    batches = list(tmx.gluon.data.DataLoader(ds, batch_size=3))
    assert [tuple(b[0].shape) for b in batches] == [(3, 1, 28, 28)] * 2
