"""The port's deploy artifacts (``mxnet_tpu_torch.deploy``: torch.export
programs in the JAX package's single-file layout) against the JAX
package's (tests/test_deploy.py's non-int8 cases): round trips from a
hybridized block and from a Symbol, a blob run in a process that
imports only torch, the meta (equal to JAX's for the same graph),
call validation, the bucket ladder's pad-and-slice, format-1 files, a
JAX artifact refused; artifacts holding the attention ops (their
programs hold the ``mxnet_tpu_torch`` op nodes, no plain attention,
answers within 2e-5 of the JAX artifact's) and an artifact naming ops
the loader does not know refused; and format-3 int8 artifacts, the
counterparts of tests/test_deploy.py's four int8 tests, each held to
the JAX artifact's meta and answers. The Predictor is held to JAX's on
the same Symbol and numpy parameters at rtol 1e-5, atol 1e-6."""
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
    (2, 3, 32, 32) batch, and its artifact. The CPU default is set for
    the fixture alone: a test file run after this one on the same worker
    sees the environment it started with."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
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


ATT_TOL = dict(rtol=2e-5, atol=2e-5)
# the plain attention's ops: none may be traced into an artifact
PLAIN_ATTENTION = {"aten::exp", "aten::amax", "aten::logsumexp",
                   "aten::bmm", "aten::einsum", "aten::_softmax"}


def _attention_net(m, seed=0):
    """FC -> q, k, v (B, T, 2, 8) -> causal flash attention -> FC, and
    its numpy parameters."""
    d = m.sym.var("data")
    heads = []
    for name in ("q", "k", "v"):
        h = m.sym.FullyConnected(d, num_hidden=16, flatten=False,
                                 name=name)
        heads.append(m.sym.reshape(h, shape=(0, 0, 2, 8)))
    att = m.sym._contrib_flash_attention(*heads, causal=True)
    out = m.sym.FullyConnected(m.sym.reshape(att, shape=(0, 0, 16)),
                               num_hidden=5, flatten=False, name="out")
    rs = np.random.RandomState(seed)
    shapes = {"q_weight": (16, 12), "k_weight": (16, 12),
              "v_weight": (16, 12), "q_bias": (16,), "k_bias": (16,),
              "v_bias": (16,), "out_weight": (5, 16), "out_bias": (5,)}
    return out, {n: (rs.randn(*sh) * 0.4).astype(np.float32)
                 for n, sh in shapes.items()}


def _decode_net(m):
    """``_contrib_decode_attention`` over data inputs, the lengths one of
    them."""
    return m.sym._contrib_decode_attention(
        m.sym.var("q"), m.sym.var("k"), m.sym.var("v"),
        m.sym.var("lengths")), {}


def _targets(pred):
    return [{n.target.name() for n in ep.graph.nodes
             if n.op == "call_function"
             and isinstance(n.target, torch._ops.OpOverload)}
            for _b, ep in pred._programs]


@pytest.mark.parametrize("which", ["prefill", "decode"])
def test_attention_artifact_against_jax(tmp_path, which):
    """A graph holding an attention op, exported by both packages with
    buckets [1, 2]: both artifacts' answers agree within 2e-5; each of
    the port's programs (traced on the CPU) holds the op node and none
    of the plain attention's ops; the meta names the op."""
    build = _attention_net if which == "prefill" else _decode_net
    rs = np.random.RandomState(3)
    if which == "prefill":
        shapes = {"data": (1, 10, 12)}
        xs = [rs.randn(b, 10, 12).astype(np.float32) for b in (1, 2)]
        op = "mxnet_tpu_torch::flash_fwd"
    else:
        B, T, H, D = 1, 24, 2, 8
        shapes = {"q": (B, 1, H, D), "k": (B, T, H, D), "v": (B, T, H, D),
                  "lengths": (B,)}
        xs = [(rs.randn(b, 1, H, D).astype(np.float32),
               rs.randn(b, T, H, D).astype(np.float32),
               rs.randn(b, T, H, D).astype(np.float32),
               rs.randint(1, T + 1, b).astype(np.float32)) for b in (1, 2)]
        op = "mxnet_tpu_torch::flash_decode"
    preds = []
    for m in (mx, jmx):
        sym, params = build(m)
        path = str(tmp_path / ("%s.mxp" % m.__name__))
        m.deploy.export_compiled(
            sym, path, params={n: m.nd.array(v) for n, v in params.items()},
            input_shapes=shapes, batch_sizes=[1, 2])
        preds.append(m.deploy.load_compiled(path))
    pred, jpred = preds
    assert pred.meta["custom_ops"] == [op]
    for held in _targets(pred):
        assert op in held and not held & PLAIN_ATTENTION, held
    for x in xs:
        args = x if isinstance(x, tuple) else (x,)
        got, want = pred(*args), np.asarray(jpred(*args))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **ATT_TOL)
    for key in ("format", "inputs", "outputs"):
        assert pred.meta[key] == jpred.meta[key], key


def test_attention_artifact_moves_with_its_op(tmp_path):
    """Loaded on another device (``meta``, standing in for the card),
    the program keeps the op node, and it dispatches there."""
    sym, params = _attention_net(mx)
    path = str(tmp_path / "att.mxp")
    mx.deploy.export_compiled(
        sym, path, params={n: mx.nd.array(v) for n, v in params.items()},
        input_shapes={"data": (2, 10, 12)})
    moved = mx.deploy.load_compiled(path, device="meta")
    assert moved.program_devices() == {"meta"}
    assert "mxnet_tpu_torch::flash_fwd" in _targets(moved)[0]
    y = moved.program(2)(torch.zeros(2, 10, 12, device="meta"))
    assert y.device.type == "meta" and tuple(y.shape) == (2, 10, 5)


def test_artifact_naming_unknown_ops_is_refused(tmp_path):
    sym, params = _attention_net(mx)
    path = str(tmp_path / "att.mxp")
    mx.deploy.export_compiled(
        sym, path, params={n: mx.nd.array(v) for n, v in params.items()},
        input_shapes={"data": (1, 10, 12)})
    with open(path, "rb") as f:
        magic = f.read(12)
        (n,) = struct.unpack("<I", f.read(4))
        meta = json.loads(f.read(n).decode())
        rest = f.read()
    meta["custom_ops"] += ["mxnet_tpu_torch::flash_next",
                           "other_lib::fused_thing"]
    mb = json.dumps(meta).encode()
    bad = str(tmp_path / "bad.mxp")
    with open(bad, "wb") as f:
        f.write(magic + struct.pack("<I", len(mb)) + mb + rest)
    with pytest.raises(MXNetError,
                       match="mxnet_tpu_torch::flash_next, "
                             "other_lib::fused_thing"):
        mx.deploy.load_compiled(bad)


# ---------------------------------------------------------------------------
# format 3: int8 artifacts (tests/test_deploy.py's four int8 tests, each
# held to the JAX artifact)
# ---------------------------------------------------------------------------

def _mlp_and_calib(m, seed=0, batch=4):
    """tests/test_deploy.py's MLP, weights and calibration batches."""
    rng = np.random.RandomState(seed)
    data = m.sym.var("data")
    fc1 = m.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = m.sym.Activation(fc1, act_type="relu")
    fc2 = m.sym.FullyConnected(act, num_hidden=4, name="fc2")
    params = {"fc1_weight": m.nd.array(
                  rng.randn(16, 8).astype(np.float32) * 0.3),
              "fc1_bias": m.nd.zeros((16,)),
              "fc2_weight": m.nd.array(
                  rng.randn(4, 16).astype(np.float32) * 0.3),
              "fc2_bias": m.nd.zeros((4,))}
    xs = [m.nd.array(rng.randn(batch, 8).astype(np.float32))
          for _ in range(3)]

    class Batches:
        def __iter__(self):
            return iter([type("B", (), {"data": [x]})() for x in xs])

        def reset(self):
            pass

    return fc2, params, xs, Batches()


def _both_int8(tmp_path, **kw):
    """The MLP exported with quantize=True by the port and by the JAX
    package: (port predictor, JAX predictor, the numpy batches, the
    port's fp32 answers)."""
    preds = []
    for m in (mx, jmx):
        sym, params, xs, calib = _mlp_and_calib(m)
        path = str(tmp_path / ("q_%s.mxp" % m.__name__))
        m.deploy.export_compiled(sym, path, params=params,
                                 input_shapes={"data": (4, 8)},
                                 quantize=True, calib_data=calib, **kw)
        preds.append(m.deploy.load_compiled(path))
        if m is mx:
            fp32 = [sym.bind(mx.cpu(), dict(params, data=x)).forward()[0]
                    .asnumpy() for x in xs]
            batches = [x.asnumpy() for x in xs]
    return preds[0], preds[1], batches, fp32


def _same_quantization(q, jq):
    for key in ("dtype", "calib_mode", "calib_batches", "excluded",
                "tolerance"):
        assert q[key] == jq[key], key
    assert sorted(q["ranges"]) == sorted(jq["ranges"])
    for n, rng in jq["ranges"].items():
        np.testing.assert_allclose(q["ranges"][n], rng, err_msg=n, **TOL)
    np.testing.assert_allclose(q["max_abs_delta"], jq["max_abs_delta"],
                               **TOL)


def test_int8_export_format3_roundtrip(tmp_path):
    pred, jpred, xs, fp32 = _both_int8(tmp_path)
    assert pred.meta["format"] == jpred.meta["format"] == 3
    q = pred.quantization
    assert q["dtype"] == "int8" and q["calib_mode"] == "naive"
    assert q["calib_batches"] == 3 and set(q["ranges"]) == {"fc1", "fc2"}
    assert all(lo < hi for lo, hi in q["ranges"].values())
    _same_quantization(q, jpred.quantization)
    for key in ("inputs", "outputs"):
        assert pred.meta[key] == jpred.meta[key], key
    # the artifact predicts within the RECORDED delta of the fp32 graph,
    # and as the JAX artifact does
    got = pred(xs[0])
    assert np.max(np.abs(got - fp32[0])) <= q["max_abs_delta"] + 1e-6
    np.testing.assert_allclose(got, np.asarray(jpred(xs[0])), **TOL)
    # one node a quantized op, and the meta names them
    held = set().union(*_targets(pred))
    assert pred.meta["custom_ops"] == sorted(
        "mxnet_tpu_torch::" + n for n in ("quantize_v2",
                                          "quantized_fully_connected",
                                          "requantize", "dequantize"))
    assert set(pred.meta["custom_ops"]) <= held
    assert "aten::linear" not in held and "aten::_int_mm" not in held


def test_int8_export_accuracy_oracle_gates(tmp_path):
    sym, params, _xs, calib = _mlp_and_calib(mx)
    path = str(tmp_path / "q.mxp")
    with pytest.raises(MXNetError, match="max_output_delta"):
        mx.deploy.export_compiled(sym, path, params=params,
                                  input_shapes={"data": (4, 8)},
                                  quantize=True, calib_data=calib,
                                  max_output_delta=1e-9)
    assert not os.path.exists(path)
    pred, jpred, xs, _ = _both_int8(tmp_path, max_output_delta=10.0)
    assert pred.quantization["tolerance"] == 10.0
    assert pred.quantization["max_abs_delta"] <= 10.0
    _same_quantization(pred.quantization, jpred.quantization)
    np.testing.assert_allclose(pred(xs[1]), np.asarray(jpred(xs[1])), **TOL)


def test_int8_export_requires_calib_and_excludes(tmp_path):
    sym, params, _xs, _calib = _mlp_and_calib(mx)
    with pytest.raises(MXNetError, match="calib_data"):
        mx.deploy.export_compiled(sym, str(tmp_path / "q.mxp"),
                                  params=params,
                                  input_shapes={"data": (4, 8)},
                                  quantize=True)
    # excluding every eligible node leaves ranges for none of them
    pred, jpred, xs, fp32 = _both_int8(
        tmp_path, excluded_sym_names=("fc1", "fc2"))
    assert pred.quantization["excluded"] == ["fc1", "fc2"]
    _same_quantization(pred.quantization, jpred.quantization)
    # a fully excluded graph is the fp32 graph: the delta is (near) zero
    assert pred.quantization["max_abs_delta"] <= 1e-5
    np.testing.assert_allclose(pred(xs[0]), fp32[0], **TOL)
    np.testing.assert_allclose(pred(xs[0]), np.asarray(jpred(xs[0])), **TOL)


def test_int8_export_multi_signature_buckets(tmp_path):
    """quantize=True composes with batch_sizes: every bucket program
    runs the int8 graph, pad/slice dispatch is unchanged."""
    pred, jpred, xs, fp32 = _both_int8(tmp_path, batch_sizes=[2, 4, 8])
    assert pred.meta["format"] == 3
    assert pred.batch_sizes == jpred.batch_sizes == [2, 4, 8]
    assert [(p["batch"], p["outputs"]) for p in pred.meta["programs"]] \
        == [(p["batch"], p["outputs"]) for p in jpred.meta["programs"]]
    tol = pred.quantization["max_abs_delta"] + 1e-6
    # batch 3 pads onto the 4-bucket; rows must match the exact call
    got3 = pred(xs[0][:3])
    assert np.max(np.abs(got3 - fp32[0][:3])) <= tol
    for x in (xs[0][:1], xs[0][:3], np.concatenate([xs[0], xs[1]])):
        np.testing.assert_allclose(pred(x), np.asarray(jpred(x)), **TOL)


def test_top_level_names():
    assert mx.deploy.export_compiled is not None
    for name in jmx.deploy.__all__:
        assert hasattr(mx.deploy, name), name
