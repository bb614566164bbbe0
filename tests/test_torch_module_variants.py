"""Port parity: ``SequentialModule``, ``PythonModule`` and
``PythonLossModule`` (``tests/test_io_modules.py``'s cases) against
``mxnet_tpu``, on the CPU.

Both packages start from the JAX package's Xavier parameters; the loss
of every step and the trained parameters then agree within ``TOL``
(ROADMAP rule 5's fp32 tolerance), and each case still meets its JAX
test's gate.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


@pytest.fixture(autouse=True)
def _fresh_names():
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


def _two_stage(mx, H=16, C=3, tail="module"):
    d1 = mx.sym.var("data")
    feat = mx.sym.Activation(
        mx.sym.FullyConnected(d1, num_hidden=H, name="fc1"),
        act_type="relu", name="act1")
    m1 = mx.mod.Module(feat, data_names=("data",), label_names=None,
                       context=mx.cpu())
    if tail == "module":
        d2 = mx.sym.var("data")
        out = mx.sym.SoftmaxOutput(
            mx.sym.FullyConnected(d2, num_hidden=C, name="fc2"),
            mx.sym.var("softmax_label"), name="softmax")
        m2 = mx.mod.Module(out, data_names=("data",),
                           label_names=("softmax_label",), context=mx.cpu())
    else:
        # a softmax head and a Python loss tail
        m1 = mx.mod.Module(mx.sym.softmax(mx.sym.FullyConnected(
            d1, num_hidden=C, name="fc")), data_names=("data",),
            label_names=None, context=mx.cpu())
        m2 = mx.mod.PythonLossModule()
    seq = mx.mod.SequentialModule()
    seq.add(m1).add(m2, take_labels=True)
    return seq


def _bind(mx, seq, B, I):
    seq.bind(data_shapes=[mx.io.DataDesc("data", (B, I))],
             label_shapes=[mx.io.DataDesc("softmax_label", (B,))])


def _train(tail, B, I, C, lr, steps, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, I).astype(np.float32)
    y = rng.randint(0, C, (B,)).astype(np.float32)
    runs, params = {}, None
    for name, mx in (("j", jmx), ("t", tmx)):
        seq = _two_stage(mx, C=C, tail=tail)
        _bind(mx, seq, B, I)
        if params is None:
            np.random.seed(seed)
            seq.init_params(mx.init.Xavier())
            params = {k: v.asnumpy() for k, v in seq.get_params()[0].items()}
        else:
            seq.init_params(arg_params={k: mx.nd.array(v)
                                        for k, v in params.items()})
        seq.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": lr})
        batch = mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)])
        losses = []
        for _ in range(steps):
            seq.forward(batch, is_train=True)
            probs = seq.get_outputs()[0].asnumpy()
            picked = probs[np.arange(B), y.astype(np.int64)]
            losses.append(-np.log(np.maximum(picked, 1e-9)).mean())
            seq.backward()
            seq.update()
        runs[name] = (np.array(losses), seq)
    return runs


def test_sequential_two_stage_training_matches_jax():
    runs = _train("module", B=8, I=10, C=3, lr=0.5, steps=25, seed=0)
    (jl, jseq), (tl, tseq) = runs["j"], runs["t"]
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0] * 0.5, (tl[0], tl[-1])
    jp, tp = jseq.get_params()[0], tseq.get_params()[0]
    assert sorted(tp) == sorted(jp) == ["fc1_bias", "fc1_weight",
                                        "fc2_bias", "fc2_weight"]
    for k in jp:
        np.testing.assert_allclose(tp[k].asnumpy(), jp[k].asnumpy(),
                                   err_msg=k, **TOL)


def test_python_loss_tail_matches_jax():
    runs = _train("python_loss", B=6, I=8, C=4, lr=2.0, steps=60, seed=1)
    (jl, _), (tl, tseq) = runs["j"], runs["t"]
    np.testing.assert_allclose(tl, jl, **TOL)
    assert tl[-1] < tl[0] * 0.7, (tl[0], tl[-1])
    tail = tseq._modules[-1]
    assert tail.output_shapes == [("pyloss_output", (6, 4))]
    assert tail.get_params() == ({}, {})


def test_python_loss_custom_grad_func_matches_jax():
    B, I, C = 4, 5, 3
    rng = np.random.RandomState(2)
    x = rng.randn(B, I).astype(np.float32)
    y = rng.randint(0, C, (B,)).astype(np.float32)
    grads = {}
    for name, mx in (("j", jmx), ("t", tmx)):
        tail = mx.mod.PythonLossModule(
            grad_func=lambda s, lab, mx=mx: mx.nd.array(
                2.0 * s.asnumpy() - lab.asnumpy()[:, None]))
        tail.bind([mx.io.DataDesc("data", (B, C))],
                  [mx.io.DataDesc("softmax_label", (B,))])
        tail.forward(mx.io.DataBatch([mx.nd.array(x[:, :C])],
                                     [mx.nd.array(y)]))
        tail.backward()
        grads[name] = tail.get_input_grads()[0].asnumpy()
        with pytest.raises(mx.base.MXNetError, match="tail"):
            tail.backward(out_grads=[mx.nd.array(x)])
    np.testing.assert_allclose(grads["t"], grads["j"], **TOL)
    with pytest.raises(tmx.base.MXNetError, match="callable"):
        tmx.mod.PythonLossModule(grad_func=3)


def test_sequential_inference_bind_matches_jax():
    outs, params = {}, None
    for name, mx in (("j", jmx), ("t", tmx)):
        d1 = mx.sym.var("data")
        m1 = mx.mod.Module(mx.sym.FullyConnected(d1, num_hidden=4,
                                                 name="sfc1"),
                           data_names=("data",), label_names=None,
                           context=mx.cpu())
        d2 = mx.sym.var("data")
        m2 = mx.mod.Module(mx.sym.softmax(
            mx.sym.FullyConnected(d2, num_hidden=2, name="sfc2")),
            data_names=("data",), label_names=None, context=mx.cpu())
        seq = mx.mod.SequentialModule()
        seq.add(m1).add(m2)
        seq.bind(data_shapes=[mx.io.DataDesc("data", (2, 6))],
                 for_training=False)
        if params is None:
            np.random.seed(3)
            seq.init_params(mx.init.Xavier())
            params = {k: v.asnumpy() for k, v in seq.get_params()[0].items()}
        else:
            seq.init_params(arg_params={k: mx.nd.array(v)
                                        for k, v in params.items()})
        x = np.random.RandomState(4).randn(2, 6).astype(np.float32)
        seq.forward(mx.io.DataBatch([mx.nd.array(x)], None),
                    is_train=False)
        outs[name] = seq.get_outputs()[0].asnumpy()
        assert seq.output_shapes[0][1] == (2, 2)
        assert seq.data_names == ["data"]
        # no module took the labels: the metric scores the tail output
        metric = mx.metric.create("acc")
        seq.update_metric(metric, [mx.nd.array([0.0, 1.0])])
        outs[name + "_acc"] = metric.get()[1]
    np.testing.assert_allclose(outs["t"], outs["j"], **TOL)
    assert outs["t_acc"] == outs["j_acc"]


def test_sequential_errors_match_jax():
    for mx in (jmx, tmx):
        seq = mx.mod.SequentialModule()
        with pytest.raises(mx.base.MXNetError, match="no modules"):
            seq.bind(data_shapes=[mx.io.DataDesc("data", (2, 3))])
        with pytest.raises(mx.base.MXNetError, match="meta"):
            seq.add(mx.mod.PythonLossModule(), wrong=True)
        d = mx.sym.var("data")
        m1 = mx.mod.Module(mx.sym.SliceChannel(
            mx.sym.FullyConnected(d, num_hidden=4, name="split_fc"),
            num_outputs=2), label_names=None, context=mx.cpu())
        m2 = mx.mod.Module(mx.sym.FullyConnected(
            mx.sym.var("data"), num_hidden=2, name="tail_fc"),
            label_names=None, context=mx.cpu())
        seq.add(m1).add(m2)
        with pytest.raises(mx.base.MXNetError, match="feeds 2 outputs"):
            seq.bind(data_shapes=[mx.io.DataDesc("data", (2, 3))])
