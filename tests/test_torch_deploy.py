"""The port's deploy artifacts (``mxnet_tpu_torch.deploy``: torch.export
programs in the JAX package's single-file layout) against the JAX
package's (tests/test_deploy.py's non-int8 cases): round trips from a
hybridized block and from a Symbol, a blob run in a process that
imports only torch, the meta (equal to JAX's for the same graph),
call validation, the bucket ladder's pad-and-slice, format-1 files, and
the port's own refusals (a JAX artifact, a graph with a hand-kernel op,
``quantize=True``). The Predictor is held to JAX's on the same Symbol
and numpy parameters at rtol 1e-5, atol 1e-6."""
import io
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


@pytest.fixture(scope="module")
def resnet18(tmp_path_factory):
    """The port's hybridized resnet18_v1 (10 classes), its output on a
    (2, 3, 32, 32) batch, and its artifact."""
    os.environ["MXNET_DEFAULT_CONTEXT"] = "cpu"
    from mxnet_tpu_torch.gluon.model_zoo import vision
    mx.random.seed(0)
    net = vision.resnet18_v1(classes=10)
    net.initialize(mx.init.Xavier())
    net.hybridize()
    x = mx.nd.array(np.random.RandomState(0).uniform(
        0, 1, (2, 3, 32, 32)).astype(np.float32))
    y = net(x).asnumpy()
    path = str(tmp_path_factory.mktemp("deploy") / "model.mxp")
    mx.deploy.export_compiled(net, path,
                              input_shapes={"data0": (2, 3, 32, 32)})
    return net, x.asnumpy(), y, path


def _fc(m, seed=0):
    d = m.sym.var("data")
    out = m.sym.FullyConnected(d, m.sym.var("w"), m.sym.var("b"),
                               num_hidden=4)
    rs = np.random.RandomState(seed)
    w = rs.uniform(-1, 1, (4, 6)).astype(np.float32)
    b = rs.uniform(-1, 1, (4,)).astype(np.float32)
    return out, {"w": m.nd.array(w), "b": m.nd.array(b)}, w, b


def _fc_artifact(m, path, batch_sizes=None, batch=3):
    out, params, w, b = _fc(m)
    m.deploy.export_compiled(out, path, params=params,
                             input_shapes={"data": (batch, 6)},
                             batch_sizes=batch_sizes)
    return w, b


def test_block_export_load_roundtrip(resnet18):
    _net, x, y_ref, path = resnet18
    pred = mx.deploy.load_compiled(path)
    assert pred.input_names == ["data0"]
    out = pred(x)
    assert isinstance(out, np.ndarray)
    np.testing.assert_allclose(out, y_ref, rtol=2e-4, atol=2e-5)


def test_symbol_export_form_against_jax_predictor(tmp_path):
    path = str(tmp_path / "fc.mxp")
    jpath = str(tmp_path / "fc_jax.mxp")
    w, b = _fc_artifact(mx, path)
    _fc_artifact(jmx, jpath)
    pred = mx.deploy.load_compiled(path)
    x = np.random.RandomState(0).randn(3, 6).astype(np.float32)
    np.testing.assert_allclose(pred(x), x @ w.T + b, **TOL)
    jpred = jmx.deploy.load_compiled(jpath)
    np.testing.assert_allclose(pred(x), np.asarray(jpred(x)), **TOL)


def test_artifact_is_self_contained(resnet18, tmp_path):
    """A process that imports only torch runs the program: the blob
    through torch.export.load, the weight block through torch.load."""
    _net, x, y_ref, path = resnet18
    np.save(str(tmp_path / "x.npy"), x)
    code = r"""
import io, json, struct, sys
import numpy as np, torch
with open(sys.argv[1], "rb") as f:
    assert f.read(12) == b"MXTPUDEPLOY1"
    (n,) = struct.unpack("<I", f.read(4))
    meta = json.loads(f.read(n).decode())
    blob = f.read(meta["programs"][0]["length"])
    weights = torch.load(io.BytesIO(f.read(meta["weights"]["length"])),
                         weights_only=True)
ep = torch.export.load(io.BytesIO(blob))
for k in ep.state_dict:
    ep.state_dict[k] = weights[k]
y = ep.module()(torch.from_numpy(np.load(sys.argv[2])))
np.save(sys.argv[3], y.detach().numpy())
assert not [m for m in sys.modules if m.startswith("mxnet_tpu")]
print(meta["inputs"][0]["shape"], meta["runtime"])
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", code, path, str(tmp_path / "x.npy"),
         str(tmp_path / "y.npy")], capture_output=True, text=True,
        env=env, timeout=120, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[2,", "3,", "32,", "32]",
                                  "torch.export"]
    np.testing.assert_allclose(np.load(str(tmp_path / "y.npy")), y_ref,
                               rtol=2e-4, atol=2e-5)


def test_bad_magic_rejected(tmp_path):
    p = tmp_path / "junk.mxp"
    p.write_bytes(b"not an artifact")
    with pytest.raises(MXNetError, match="deploy artifact"):
        mx.deploy.load_compiled(str(p))


def test_meta_records_outputs_equal_to_jax(tmp_path):
    for batch_sizes in (None, [1, 2, 4]):
        path = str(tmp_path / "fc.mxp")
        jpath = str(tmp_path / "fc_jax.mxp")
        _fc_artifact(mx, path, batch_sizes=batch_sizes)
        _fc_artifact(jmx, jpath, batch_sizes=batch_sizes)
        pred = mx.deploy.load_compiled(path)
        jpred = jmx.deploy.load_compiled(jpath)
        meta, jmeta = pred.meta, jpred.meta
        for key in ("format", "inputs", "outputs"):
            assert meta[key] == jmeta[key], key
        assert [(p["batch"], p["outputs"]) for p in meta["programs"]] \
            == [(p["batch"], p["outputs"]) for p in jmeta["programs"]]
        assert pred.batch_sizes == jpred.batch_sizes
        assert pred.output_info == jpred.output_info
        assert (meta["framework"], jmeta["framework"]) \
            == ("mxnet_tpu_torch", "mxnet_tpu")
        assert meta["runtime"] == "torch.export"
        assert meta["torch"] == torch.__version__
    assert meta["format"] == 2
    assert pred.output_info == [{"shape": [1, 4], "dtype": "float32"}]


def test_predictor_validates_calls(tmp_path):
    path = str(tmp_path / "fc.mxp")
    _fc_artifact(mx, path)
    pred = mx.deploy.load_compiled(path)
    with pytest.raises(MXNetError, match="1 input"):
        pred(np.zeros((3, 6), np.float32), np.zeros((3, 6), np.float32))
    with pytest.raises(MXNetError, match="non-batch dims"):
        pred(np.zeros((3, 7), np.float32))
    with pytest.raises(MXNetError, match="rank"):
        pred(np.zeros((3, 6, 1), np.float32))
    with pytest.raises(MXNetError, match="cannot safely"):
        pred(np.zeros((3, 6), np.complex64))
    with pytest.raises(MXNetError, match="largest exported"):
        pred(np.zeros((5, 6), np.float32))
    with pytest.raises(MXNetError, match="no program for bucket"):
        pred.program(4)
    out = pred(np.zeros((3, 6), np.float64))
    assert out.shape == (3, 4)


def test_multi_signature_artifact_pads_and_slices(tmp_path):
    path = str(tmp_path / "fc.mxp")
    w, b = _fc_artifact(mx, path, batch_sizes=[1, 2, 4, 8])
    pred = mx.deploy.load_compiled(path)
    assert pred.batch_sizes == [1, 2, 4, 8]
    assert [p["batch"] for p in pred.meta["programs"]] == [1, 2, 4, 8]
    x = np.random.RandomState(0).randn(3, 6).astype(np.float32)
    np.testing.assert_allclose(pred(x), x @ w.T + b, **TOL)
    for bsz in (1, 2, 4, 8):
        xb = np.random.RandomState(bsz).randn(bsz, 6).astype(np.float32)
        got = pred(xb)
        assert got.shape == (bsz, 4)
        np.testing.assert_allclose(got, xb @ w.T + b, **TOL)
    # the weights are stored once, not once a bucket
    size = os.path.getsize(path)
    assert pred.meta["weights"]["length"] < size / 4


def test_format1_artifact_still_loads(tmp_path):
    """A format-1 file (one trailing self-contained blob, no programs
    or outputs in the meta) loads and predicts."""
    path = str(tmp_path / "fc.mxp")
    w, b = _fc_artifact(mx, path)
    pred = mx.deploy.load_compiled(path)
    buf = io.BytesIO()
    torch.export.save(pred._programs[0][1], buf)     # weights inside
    old_meta = {"format": 1, "inputs": pred.meta["inputs"],
                "framework": "mxnet_tpu_torch"}
    mb = json.dumps(old_meta).encode()
    old = tmp_path / "old.mxp"
    with open(old, "wb") as f:
        f.write(b"MXTPUDEPLOY1")
        f.write(struct.pack("<I", len(mb)))
        f.write(mb)
        f.write(buf.getvalue())
    pred = mx.deploy.load_compiled(str(old))
    assert pred.meta["format"] == 1
    assert pred.output_info is None
    assert pred.batch_sizes == [3]
    x = np.random.RandomState(0).randn(3, 6).astype(np.float32)
    want = x @ w.T + b
    np.testing.assert_allclose(pred(x), want, **TOL)
    np.testing.assert_allclose(pred(x[:1]), want[:1], **TOL)


def test_programs_move_to_the_callers_device(tmp_path):
    """Every tensor and every ``device=`` of a loaded program is on the
    caller's device (here ``meta``, standing in for the card): an
    artifact exported on the CPU keeps nothing on the CPU."""
    d = mx.sym.var("data")
    out = mx.sym.broadcast_add(mx.sym.FullyConnected(
        d, mx.sym.var("w"), mx.sym.var("b"), num_hidden=4),
        mx.sym.zeros((1, 4)))
    path = str(tmp_path / "z.mxp")
    mx.deploy.export_compiled(
        out, path, params={"w": mx.nd.ones((4, 6)),
                           "b": mx.nd.zeros((4,))},
        input_shapes={"data": (2, 6)}, batch_sizes=[1, 2])
    cpu = mx.deploy.load_compiled(path)
    assert cpu.program_devices() == {"cpu"}
    moved = mx.deploy.load_compiled(path, device="meta")
    assert moved.device == torch.device("meta")
    assert moved.program_devices() == {"meta"}
    y = moved.program(2)(torch.zeros(2, 6, device="meta"))
    assert y.device.type == "meta" and tuple(y.shape) == (2, 4)


def test_jax_artifact_refused(tmp_path):
    jpath = str(tmp_path / "fc_jax.mxp")
    _fc_artifact(jmx, jpath)
    with pytest.raises(MXNetError, match="StableHLO"):
        mx.deploy.load_compiled(jpath)


def test_hand_kernel_graph_refused(tmp_path):
    q = mx.sym.var("q")
    att = mx.sym.contrib.flash_attention(q, q, q, causal=True) \
        if hasattr(mx.sym.contrib, "flash_attention") \
        else mx.sym._contrib_flash_attention(q, q, q, causal=True)
    with pytest.raises(MXNetError, match="_contrib_flash_attention"):
        mx.deploy.export_compiled(att, str(tmp_path / "a.mxp"),
                                  input_shapes={"q": (1, 8, 2, 4)})
    assert not os.path.exists(str(tmp_path / "a.mxp"))


def test_quantize_raises_naming_item_13(tmp_path):
    out, params, _w, _b = _fc(mx)
    with pytest.raises(MXNetError, match="item 13"):
        mx.deploy.export_compiled(out, str(tmp_path / "q.mxp"),
                                  params=params,
                                  input_shapes={"data": (4, 6)},
                                  quantize=True)


def test_top_level_names():
    assert mx.deploy.export_compiled is not None
    for name in jmx.deploy.__all__:
        assert hasattr(mx.deploy, name), name
