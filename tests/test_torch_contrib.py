"""Port parity: ``mx.contrib``'s ``io``, ``svrg_optimization``, ``text``,
``onnx``, ``tensorboard`` and ``_alias`` against ``mxnet_tpu`` on the CPU.

- ``DataLoaderIter``: the same batches and pads as JAX's from one
  dataset (``tests/test_contrib_band.py``'s case).
- SVRG: ``tests/test_aux_subsystems.py``'s least-squares problem, one
  set of numpy weights in both packages; the parameters after two epochs
  equal JAX's at 1e-5. The port runs with its fused step on (the
  default), where a corrected gradient left in the executor's arrays
  would be dropped by ``update()``'s graph; the JAX package runs with
  ``MXNET_FUSED_STEP=0``, since its own fused step drops the correction
  (its ``forward_backward`` rewrites arrays that ``update()`` never
  reads).
- ``text``: a vocabulary and a custom embedding from the same local file.
- ``onnx``: the graph IR of ``tests/test_onnx.py``'s model-zoo nets,
  traced in both packages from one set of weights, equal node for node,
  and the IR's Symbol round trip equal to the net's forward; the proto
  steps raise JAX's ``ImportError`` without the ``onnx`` package.
- ``LogMetricsCallback``: the scalars both packages write, read back
  from the event files.
"""
import collections
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.gluon.convert import params_from_numpy

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    monkeypatch.setenv("MXNET_DATA_PIPELINE", "0")


@pytest.fixture(autouse=True)
def _fresh_names():
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


# ---------------------------------------------------------------------------
# contrib.io
# ---------------------------------------------------------------------------

def _loader_iter(mx, n=70, batch=32):
    x = np.random.RandomState(0).randn(n, 6).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.float32)
    ds = mx.gluon.data.ArrayDataset(mx.nd.array(x), mx.nd.array(y))
    return mx.contrib.io.DataLoaderIter(
        mx.gluon.data.DataLoader(ds, batch_size=batch))


@pytest.mark.parametrize("n", [70, 64])
def test_dataloader_iter_batches_and_pads_match_jax(n):
    jit_, tit = _loader_iter(jmx, n), _loader_iter(tmx, n)
    assert tit.provide_data == jit_.provide_data
    assert tit.provide_label == jit_.provide_label
    assert tit.provide_data[0].shape == (32, 6)
    for _ in range(2):                  # a second epoch after reset()
        jb, tb = list(jit_), list(tit)
        assert len(tb) == len(jb) == (n + 31) // 32
        for j, t in zip(jb, tb):
            assert t.pad == j.pad
            assert t.data[0].shape == (32, 6)
            np.testing.assert_array_equal(t.data[0].asnumpy(),
                                          j.data[0].asnumpy())
            np.testing.assert_array_equal(t.label[0].asnumpy(),
                                          j.label[0].asnumpy())
        assert tb[-1].pad == (-n) % 32
        jit_.reset()
        tit.reset()


# ---------------------------------------------------------------------------
# contrib.svrg_optimization
# ---------------------------------------------------------------------------

def _lsq(mx):
    rng = np.random.RandomState(0)
    N, D = 64, 5
    w_true = rng.randn(D, 1).astype(np.float32)
    X = rng.randn(N, D).astype(np.float32)
    y = (X @ w_true).ravel()
    data = mx.sym.var("data")
    label = mx.sym.var("lin_label")
    pred = mx.sym.FullyConnected(data, num_hidden=1, no_bias=True,
                                 name="fc")
    out = mx.sym.LinearRegressionOutput(pred, label, name="lin")
    it = mx.io.NDArrayIter({"data": X}, {"lin_label": y}, batch_size=16,
                           shuffle=False, label_name="lin_label")
    return out, it


W0 = np.random.RandomState(7).normal(0, 0.1, (1, 5)).astype(np.float32)


def _svrg_loop(mx, cls, epochs=2, **mod_kw):
    out, it = _lsq(mx)
    mod = cls(out, data_names=("data",), label_names=("lin_label",),
              context=mx.cpu(), **mod_kw)
    mod.bind(it.provide_data, it.provide_label, for_training=True)
    mod.init_params(arg_params={"fc_weight": mx.nd.array(W0)})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05})
    svrg = hasattr(mod, "update_full_grads")
    if svrg:
        mod.update_full_grads(it)
    for _ in range(epochs):
        it.reset()
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
        if svrg:
            mod.update_full_grads(it)
    return mod.get_params()[0]["fc_weight"].asnumpy()


def _jax_svrg(monkeypatch, fn):
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    try:
        return fn()
    finally:
        monkeypatch.delenv("MXNET_FUSED_STEP")


def test_svrg_steps_match_jax_under_the_fused_step(monkeypatch):
    from mxnet_tpu.contrib.svrg_optimization import SVRGModule as JSVRG
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.contrib.svrg_optimization import SVRGModule
    from mxnet_tpu_torch.fused_step import fused_step_enabled
    want = _jax_svrg(monkeypatch,
                     lambda: _svrg_loop(jmx, JSVRG, update_freq=1))
    assert fused_step_enabled()
    before = profiler.counters().get("fused_step_fallbacks", 0)
    got = _svrg_loop(tmx, SVRGModule, update_freq=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # every corrected step ran eagerly: 2 epochs of 4 batches
    assert profiler.counters().get("fused_step_fallbacks", 0) - before == 8
    # the correction moves the weights: plain SGD ends elsewhere
    plain = _svrg_loop(tmx, tmx.mod.Module)
    assert np.abs(plain - got).max() > 1e-3


def test_svrg_fit_matches_jax(monkeypatch):
    from mxnet_tpu.contrib.svrg_optimization import SVRGModule as JSVRG
    from mxnet_tpu_torch.contrib.svrg_optimization import SVRGModule

    def fit(mx, cls):
        out, it = _lsq(mx)
        mod = cls(out, data_names=("data",), label_names=("lin_label",),
                  context=mx.cpu(), update_freq=2)
        mod.bind(it.provide_data, it.provide_label, for_training=True)
        mod.init_params(arg_params={"fc_weight": mx.nd.array(W0)})
        mod.fit(it, num_epoch=3, optimizer="sgd",
                optimizer_params={"learning_rate": 0.05},
                eval_metric="mse")
        return mod.get_params()[0]["fc_weight"].asnumpy()
    want = _jax_svrg(monkeypatch, lambda: fit(jmx, JSVRG))
    np.testing.assert_allclose(fit(tmx, SVRGModule), want, rtol=1e-5,
                               atol=1e-6)


def test_svrg_rejects_bad_update_freq():
    from mxnet_tpu_torch.contrib.svrg_optimization import SVRGModule
    out, _ = _lsq(tmx)
    with pytest.raises(tmx.MXNetError, match="update_freq"):
        SVRGModule(out, update_freq=0)


# ---------------------------------------------------------------------------
# contrib.text
# ---------------------------------------------------------------------------

def test_vocabulary_matches_jax():
    counter = collections.Counter(
        {"the": 10, "cat": 5, "sat": 5, "mat": 1, "on": 3})
    for kw in (dict(min_freq=2, reserved_tokens=["<pad>"]),
               dict(most_freq_count=2), dict()):
        j = jmx.contrib.text.Vocabulary(counter, **kw)
        t = tmx.contrib.text.Vocabulary(counter, **kw)
        assert t.idx_to_token == j.idx_to_token
        assert t.token_to_idx == j.token_to_idx
        assert t.to_indices(["the", "zzz", "on"]) == \
            j.to_indices(["the", "zzz", "on"])
        assert t.to_tokens(1) == j.to_tokens(1)
    with pytest.raises(tmx.MXNetError, match="out of range"):
        t.to_tokens(99)
    with pytest.raises(tmx.MXNetError, match="min_freq"):
        tmx.contrib.text.Vocabulary(counter, min_freq=0)
    text = "a b\nb c  C\n"
    for lower in (False, True):
        assert tmx.contrib.text.count_tokens_from_str(text, to_lower=lower) \
            == jmx.contrib.text.count_tokens_from_str(text, to_lower=lower)


@pytest.mark.parametrize("header", [False, True])
def test_custom_embedding_matches_jax(tmp_path, header):
    f = tmp_path / "emb.txt"
    rows = ["cat 1.0 2.0 3.0", "dog 3.0 4.0 -5.5", "bad 1.0",
            "The 0.5 0.25 0.125"]
    f.write_text(("4 3\n" if header else "") + "\n".join(rows) + "\n")
    j = jmx.contrib.text.CustomEmbedding(str(f))
    t = tmx.contrib.text.CustomEmbedding(str(f))
    assert t.idx_to_token == j.idx_to_token and t.vec_len == j.vec_len == 3
    np.testing.assert_array_equal(t.idx_to_vec.asnumpy(),
                                  j.idx_to_vec.asnumpy())
    toks = ["cat", "bird", "the", "dog"]
    for lower in (False, True):
        np.testing.assert_array_equal(
            t.get_vecs_by_tokens(toks, lower_case_backup=lower).asnumpy(),
            j.get_vecs_by_tokens(toks, lower_case_backup=lower).asnumpy())
    new = np.array([[9.0, 8.0, 7.0]], np.float32)
    j.update_token_vectors(["cat"], jmx.nd.array(new))
    t.update_token_vectors(["cat"], tmx.nd.array(new))
    np.testing.assert_array_equal(t.get_vecs_by_tokens("cat").asnumpy(),
                                  j.get_vecs_by_tokens("cat").asnumpy())
    # over a given vocabulary, unknown rows from init_unknown_vec
    vocab = tmx.contrib.text.Vocabulary(collections.Counter(["dog", "emu"]))
    jvocab = jmx.contrib.text.Vocabulary(collections.Counter(["dog", "emu"]))
    t2 = tmx.contrib.text.CustomEmbedding(str(f), vocabulary=vocab,
                                          init_unknown_vec=tmx.nd.ones)
    j2 = jmx.contrib.text.CustomEmbedding(str(f), vocabulary=jvocab,
                                          init_unknown_vec=jmx.nd.ones)
    np.testing.assert_array_equal(t2.idx_to_vec.asnumpy(),
                                  j2.idx_to_vec.asnumpy())


# ---------------------------------------------------------------------------
# contrib.onnx
# ---------------------------------------------------------------------------

def _trace_pair(factory, size):
    """The zoo net in both packages from JAX's Xavier weights, each
    hybridized and traced once: (sym, params) per package, the input and
    JAX's output."""
    x = np.random.RandomState(1).uniform(0, 1, (1, 3, size, size)) \
        .astype(np.float32)
    jnet = getattr(jmx.gluon.model_zoo.vision, factory)()
    jnet.initialize(jmx.init.Xavier())
    jnet.hybridize()
    y = jnet(jmx.nd.array(x)).asnumpy()
    tnet = getattr(tmx.gluon.model_zoo.vision, factory)()
    tnet.initialize()
    params_from_numpy(tnet, {k: p.data().asnumpy() for k, p in
                             jnet._collect_params_with_prefix().items()})
    tnet.hybridize()
    tnet(tmx.nd.array(x))
    out = []
    for net in (jnet, tnet):
        sym = net._cached_graph[1]
        names = set(sym.list_arguments()) | \
            set(sym.list_auxiliary_states())
        out.append((sym, {n: p.data().asnumpy() for n, p in
                          net.collect_params().items() if n in names}))
    return out, x, y


@pytest.mark.parametrize("factory,size", [("resnet18_v1", 32),
                                          ("mobilenet_v2_1_0", 32),
                                          ("squeezenet1_0", 224)])
def test_onnx_ir_node_for_node_and_roundtrip(factory, size):
    from mxnet_tpu.contrib.onnx import symbol_to_onnx_ir as j_ir
    from mxnet_tpu_torch.contrib.onnx import (symbol_to_onnx_ir,
                                              ir_to_symbol)
    ((jsym, jparams), (tsym, tparams)), x, y = _trace_pair(factory, size)
    assert tsym.list_arguments() == jsym.list_arguments()
    shapes = {"data0": x.shape}
    jir = j_ir(jsym, jparams, shapes)
    tir = symbol_to_onnx_ir(tsym, tparams, shapes)
    assert tir["inputs"] == jir["inputs"]
    assert tir["outputs"] == jir["outputs"]
    assert len(tir["nodes"]) == len(jir["nodes"])
    for jn, tn in zip(jir["nodes"], tir["nodes"]):
        assert tn == jn
    assert sorted(tir["initializers"]) == sorted(jir["initializers"])
    for k, v in jir["initializers"].items():
        np.testing.assert_array_equal(tir["initializers"][k], v)
    sym2, args, auxs = ir_to_symbol(tir)
    data_name = [n for n in sym2.list_arguments() if n not in args][0]
    feed = dict(args)
    feed[data_name] = tmx.nd.array(x)
    got = sym2.bind(tmx.cpu(), feed, aux_states=auxs) \
        .forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(got, y, rtol=2e-4, atol=2e-5)


def test_onnx_errors_match_jax(tmp_path):
    from mxnet_tpu.contrib import onnx as jonnx
    from mxnet_tpu_torch.contrib import onnx as tonnx
    for mx, onnx_mod in ((jmx, jonnx), (tmx, tonnx)):
        d = mx.sym.var("data")
        with pytest.raises(mx.base.MXNetError, match="no converter"):
            onnx_mod.symbol_to_onnx_ir(mx.sym.create("arcsinh", [d], {}),
                                       {}, {"data": (2, 2)})
    try:
        import onnx  # noqa: F401
        pytest.skip("onnx is installed: the proto steps run")
    except ImportError:
        pass
    d = tmx.sym.var("data")
    net = tmx.sym.FullyConnected(d, num_hidden=2, name="fc")
    params = {"fc_weight": np.ones((2, 3), np.float32),
              "fc_bias": np.zeros(2, np.float32)}
    msgs = []
    for onnx_mod in (jonnx, tonnx):
        ir = onnx_mod.symbol_to_onnx_ir(net, params, {"data": (1, 3)})
        with pytest.raises(ImportError) as e1:
            onnx_mod.ir_to_onnx(ir)
        with pytest.raises(ImportError) as e2:
            onnx_mod.export_model(net, params, [(1, 3)],
                                  str(tmp_path / "m.onnx"))
        with pytest.raises(ImportError) as e3:
            onnx_mod.import_model(str(tmp_path / "m.onnx"))
        msgs.append([str(e.value) for e in (e1, e2, e3)])
    assert msgs[0] == msgs[1]
    assert not os.path.exists(tmp_path / "m.onnx")
    assert tmx.contrib.onnx_export is tonnx.export_model


def test_contrib_alias_installs_the_stripped_names():
    from mxnet_tpu_torch.contrib._alias import install_contrib_ops
    ns = {}
    install_contrib_ops(ns, lambda op: op.name)
    assert ns["box_nms"] == "_contrib_box_nms"
    jns = {}
    from mxnet_tpu.contrib._alias import install_contrib_ops as j_install
    j_install(jns, lambda op: op.name)
    assert set(ns) == set(jns)


# ---------------------------------------------------------------------------
# contrib.tensorboard
# ---------------------------------------------------------------------------

def _scalars(logdir):
    from tensorboard.backend.event_processing import event_accumulator
    acc = event_accumulator.EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, round(e.value, 6)) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_log_metrics_callback_events_match_jax(tmp_path):
    from mxnet_tpu.model import BatchEndParam as JParam
    from mxnet_tpu_torch.model import BatchEndParam as TParam
    got = {}
    for name, mx, param in (("jax", jmx, JParam), ("port", tmx, TParam)):
        cb = mx.contrib.tensorboard.LogMetricsCallback(
            str(tmp_path / name), prefix="train")
        assert type(cb.summary_writer).__module__.startswith("tensorboardX")
        metric = mx.metric.create("acc")
        for epoch, pred in enumerate(([[0.9, 0.1], [0.2, 0.8]],
                                      [[0.1, 0.9], [0.2, 0.8]])):
            metric.update([mx.nd.array([0., 1.])], [mx.nd.array(pred)])
            cb(param(epoch=epoch, nbatch=0, eval_metric=metric,
                     locals=None))
        cb(param(epoch=2, nbatch=0, eval_metric=None, locals=None))
        cb.summary_writer.close()
        got[name] = _scalars(tmp_path / name)
    assert got["port"] == got["jax"] == {
        "train-accuracy": [(0, 1.0), (1, 0.75)]}
