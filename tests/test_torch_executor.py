"""Port parity: the Executor (``mxnet_tpu_torch.executor``, reached
through ``Symbol.bind``/``simple_bind``/``eval``) against
``mxnet_tpu.executor``, on the CPU.

The cases of ``tests/test_symbol_executor.py`` on the same numpy inputs
in both packages, fp32 at rtol 1e-5, atol 1e-6 (ROADMAP rule 5): the
forward, the gradients, ``grad_req`` null/add, training by the raw
executor, ``reshape``, a multi-output split, arithmetic and groups, the
JSON of either package bound in the port, and the conv-bias/BatchNorm
peephole. One stated difference: the JAX executor's ``backward()`` runs
its forward again and updates BatchNorm's moving statistics a second
time; the port (and the reference) update them once, so the port's
statistics after ``forward`` + ``backward`` are held to JAX's after
``forward`` alone.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cached_op as tco

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


def _standin(body, device, pool):
    """A CUDA capture's contract on the CPU (as in
    test_torch_cached_op.py): one call now, its output buffers kept, each
    replay writes the body's result into them."""
    out = body()

    def replay():
        for o, r in zip(out, body()):
            o.copy_(r)
    return replay, out, {}


def _mlp(mx):
    data = mx.sym.var("data")
    h = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
    h = mx.sym.Activation(h, act_type="relu", name="relu1")
    h = mx.sym.FullyConnected(h, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(h, mx.sym.var("label"), name="softmax")


def _both(fn):
    return fn(jmx), fn(tmx)


def _np(arr):
    return None if arr is None else arr.asnumpy()


def _bind_mlp(batch, dim, seed):
    """The MLP simple-bound in both packages with the same weights."""
    rng = np.random.RandomState(seed)
    exes = []
    for mx in (jmx, tmx):
        exes.append(_mlp(mx).simple_bind(mx.cpu(), data=(batch, dim),
                                         label=(batch,)))
    weights = {n: rng.normal(0, 0.2, a.shape).astype(np.float32)
               for n, a in exes[1].arg_dict.items()
               if n.endswith(("weight", "bias"))}
    for (mx, ex) in zip((jmx, tmx), exes):
        for n, w in weights.items():
            ex.arg_dict[n][:] = mx.nd.array(w)
    return exes


def test_listing_and_infer_shape_match_jax():
    j, t = _both(_mlp)
    assert t.list_arguments() == j.list_arguments() == [
        "data", "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias", "label"]
    assert t.infer_shape(data=(16, 30), label=(16,)) == \
        j.infer_shape(data=(16, 30), label=(16,))
    fc1 = t.get_internals()["fc1_output"]
    assert fc1.list_arguments() == ["data", "fc1_weight", "fc1_bias"]


def test_simple_bind_forward_backward_matches_jax():
    jex, tex = _bind_mlp(16, 30, seed=0)
    rng = np.random.RandomState(1)
    x = rng.normal(0, 1, (16, 30)).astype(np.float32)
    y = rng.randint(0, 4, (16,)).astype(np.float32)
    outs = [ex.forward(is_train=False, data=x, label=y)[0].asnumpy()
            for ex in (jex, tex)]
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    np.testing.assert_allclose(outs[1].sum(axis=1), np.ones(16), rtol=1e-5)
    for ex in (jex, tex):
        ex.forward_backward(is_train=True)
    for n in jex.arg_names:
        np.testing.assert_allclose(_np(tex.grad_dict[n]),
                                   _np(jex.grad_dict[n]), **TOL, err_msg=n)
    assert np.abs(tex.grad_dict["fc2_weight"].asnumpy()).sum() > 0
    assert not tex.grad_dict["label"].asnumpy().any()      # zero label grad
    np.testing.assert_allclose(tex.outputs[0].asnumpy(),
                               jex.outputs[0].asnumpy(), **TOL)


def test_raw_executor_training_matches_jax():
    """30 SGD steps by hand over the raw executor (lr / batch, as
    Module's rescale_grad): the loss trajectory and the weights follow
    JAX's, and the loss drops."""
    jex, tex = _bind_mlp(32, 10, seed=2)
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (32, 10)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32) + 2 * (x[:, 1] > 0)
    lr = 0.5 / 32
    curves = []
    for mx, ex in ((jmx, jex), (tmx, tex)):
        ex.arg_dict["data"][:] = mx.nd.array(x)
        ex.arg_dict["label"][:] = mx.nd.array(y)
        nll = []
        for _ in range(30):
            ex.forward(is_train=False)
            p = ex.outputs[0].asnumpy()
            nll.append(-np.log(p[np.arange(32), y.astype(int)] + 1e-8).mean())
            ex.forward_backward(is_train=True)
            for name in ex.arg_dict:
                g = ex.grad_dict[name]
                if name not in ("data", "label") and g is not None:
                    ex.arg_dict[name][:] = ex.arg_dict[name] - lr * g
        curves.append(np.array(nll))
    np.testing.assert_allclose(curves[1], curves[0], rtol=1e-5, atol=1e-6)
    assert curves[1][-1] < curves[1][0] * 0.9
    for n in ("fc1_weight", "fc2_weight", "fc2_bias"):
        np.testing.assert_allclose(tex.arg_dict[n].asnumpy(),
                                   jex.arg_dict[n].asnumpy(), **TOL)


def test_grad_req_null_and_add_match_jax():
    got = []
    for mx in (jmx, tmx):
        data, w = mx.sym.var("data"), mx.sym.var("w")
        out = mx.sym.broadcast_mul(data, w)
        x, wv, gw = mx.nd.array([1., 2.]), mx.nd.array([3., 4.]), \
            mx.nd.zeros((2,))
        ex = out.bind(mx.cpu(), {"data": x, "w": wv}, args_grad={"w": gw},
                      grad_req={"data": "null", "w": "add"})
        ex.forward_backward(is_train=True)
        ex.forward_backward(is_train=True)
        assert ex.grad_dict["data"] is None
        got.append(gw.asnumpy())
    np.testing.assert_allclose(got[1], got[0], **TOL)
    np.testing.assert_allclose(got[1], [2., 4.])


def test_grad_write_in_place_and_unused_input_gets_zeros():
    """A gradient array keeps its tensor (written in place); an input the
    output does not depend on gets zeros, as JAX's vjp gives."""
    got = []
    for mx in (jmx, tmx):
        a, b = mx.sym.var("a"), mx.sym.var("b")
        out = mx.sym.Group([a * 2, (b > 4.5) + a])
        ga, gb = mx.nd.ones((3,)) * 7, mx.nd.ones((3,)) * 7
        ex = out.bind(mx.cpu(), {"a": mx.nd.array([1., 2., 3.]),
                                 "b": mx.nd.array([4., 5., 6.])},
                      args_grad={"a": ga, "b": gb})
        before = ga._data.data_ptr() if mx is tmx else None
        ex.forward_backward(is_train=True)
        if mx is tmx:
            assert ga._data.data_ptr() == before
        got.append((ga.asnumpy(), gb.asnumpy()))
    for t, j in zip(got[1], got[0]):
        np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_allclose(got[1][1], np.zeros(3))


def test_arithmetic_group_split_and_eval_match_jax():
    def build(mx):
        a, b = mx.sym.var("a"), mx.sym.var("b")
        parts = mx.sym.SliceChannel(mx.sym.var("m"), num_outputs=2, axis=1,
                                    name="split")
        return mx.sym.Group([(a + b * 2) / (a - 1 + 3), a * 2, a + 1,
                             parts[0] + parts[1]])
    feed = dict(a=np.array([2., 5.], np.float32),
                b=np.array([3., -1.], np.float32),
                m=np.array([[1., 2.], [3., 4.]], np.float32))
    j, t = _both(build)
    assert t.list_outputs() == j.list_outputs()
    outs = [[o.asnumpy() for o in sym.bind(mx.cpu(), {
        k: mx.nd.array(v) for k, v in feed.items()}).forward()]
        for mx, sym in ((jmx, j), (tmx, t))]
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(outs[1][3], [[3.], [7.]])
    evald = t.eval(ctx=tmx.cpu(), **{k: tmx.nd.array(v)
                                     for k, v in feed.items()})
    for got, want in zip(evald, outs[0]):
        np.testing.assert_allclose(got.asnumpy(), want, **TOL)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_json_of_either_package_binds_in_the_port(writer):
    j, t = _both(_mlp)
    js = (j if writer == "jax" else t).tojson()
    loaded = tmx.sym.load_json(js)
    assert loaded.list_arguments() == t.list_arguments()
    ex = loaded.simple_bind(tmx.cpu(), data=(4, 6), label=(4,))
    ex.forward()
    assert ex.outputs[0].shape == (4, 4)
    assert json.loads(js)["heads"]


def test_reshape_shares_params_and_matches_jax():
    exes = []
    for mx in (jmx, tmx):
        ex = _mlp(mx).simple_bind(mx.cpu(), data=(8, 10), label=(8,))
        ex.arg_dict["fc1_weight"][:] = mx.nd.array(
            np.random.RandomState(3).normal(0, 0.3, (8, 10)))
        ex2 = ex.reshape(data=(4, 10), label=(4,))
        assert ex2.arg_dict["data"].shape == (4, 10)
        assert ex2.arg_dict["fc1_weight"] is ex.arg_dict["fc1_weight"]
        ex2.forward(data=np.ones((4, 10), np.float32))
        exes.append(ex2)
    assert exes[1].outputs[0].shape == (4, 4)
    np.testing.assert_allclose(exes[1].outputs[0].asnumpy(),
                               exes[0].outputs[0].asnumpy(), **TOL)


def _conv_bn(mx):
    data = mx.sym.var("data")
    conv = mx.sym.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                              name="conv")
    bn = mx.sym.BatchNorm(conv, name="bn", fix_gamma=False, momentum=0.9)
    return mx.sym.Activation(bn, act_type="relu", name="act")


def _conv_bn_bind(mx, out, arrays, aux_shapes):
    a = {n: mx.nd.array(v) for n, v in arrays.items()}
    grads = {n: mx.nd.zeros(v.shape) for n, v in arrays.items()
             if n != "data"}
    aux = {n: mx.nd.zeros(s) if "mean" in n else mx.nd.ones(s)
           for n, s in aux_shapes.items()}
    return out.bind(mx.cpu(), a, args_grad=grads,
                    grad_req={n: "write" if n in grads else "null"
                              for n in a}, aux_states=aux)


def test_conv_bias_bn_peephole_matches_jax():
    """``_plan_bias_defer``: the biased conv feeding a train-mode
    BatchNorm runs biasless. The port's outputs, gradients and moving
    statistics equal JAX's, and the deferred bias's gradient is exactly
    0; a control bind with the peephole off agrees, its bias gradient
    ~0. Moving statistics: the port's after forward + backward against
    JAX's after forward alone (the JAX backward updates them again)."""
    rng = np.random.RandomState(7)
    j, t = _both(_conv_bn)
    x = rng.randn(2, 3, 5, 5).astype(np.float32)
    shapes = dict(zip(t.list_arguments(), t.infer_shape(data=x.shape)[0]))
    arrays = {n: (rng.randn(*shapes[n]) * (1.0 if n == "conv_bias" else 0.1)
                  ).astype(np.float32)
              for n in t.list_arguments() if n != "data"}
    arrays["data"] = x
    aux_shapes = dict(zip(t.list_auxiliary_states(),
                          t.infer_shape(data=x.shape)[2]))
    jex = _conv_bn_bind(jmx, j, arrays, aux_shapes)
    assert jex._bias_defer
    jex.forward(is_train=True)
    jax_aux_once = {n: a.asnumpy() for n, a in jex.aux_dict.items()}
    jex.backward()
    texes = []
    for defer in (True, False):
        tex = _conv_bn_bind(tmx, t, arrays, aux_shapes)
        assert list(tex._bias_defer) == [0]
        if not defer:
            tex._bias_defer = {}
        tex.forward(is_train=True)
        tex.backward()
        texes.append(tex)
    tex, tref = texes
    np.testing.assert_allclose(tex.outputs[0].asnumpy(),
                               jex.outputs[0].asnumpy(), rtol=1e-5,
                               atol=1e-5)
    for n in ("conv_weight", "bn_gamma", "bn_beta"):
        np.testing.assert_allclose(tex.grad_dict[n].asnumpy(),
                                   jex.grad_dict[n].asnumpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=n)
        np.testing.assert_allclose(tref.grad_dict[n].asnumpy(),
                                   tex.grad_dict[n].asnumpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=n)
    assert not tex.grad_dict["conv_bias"].asnumpy().any()      # exactly 0
    assert not jex.grad_dict["conv_bias"].asnumpy().any()
    np.testing.assert_allclose(tref.grad_dict["conv_bias"].asnumpy(), 0.0,
                               atol=1e-4)
    for n, want in jax_aux_once.items():
        np.testing.assert_allclose(tex.aux_dict[n].asnumpy(), want,
                                   rtol=1e-5, atol=1e-6, err_msg=n)
        np.testing.assert_allclose(tref.aux_dict[n].asnumpy(), want,
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    for mx_ex in (jex, tex, tref):
        mx_ex.forward(is_train=False)
    np.testing.assert_allclose(tex.outputs[0].asnumpy(),
                               tref.outputs[0].asnumpy(), rtol=1e-5,
                               atol=1e-5)


def test_jax_backward_updates_batchnorm_statistics_twice():
    """The reference finding behind the port's one update (ROADMAP queue
    C): a BatchNorm symbol, ``forward(is_train=True)`` then
    ``backward()``. The JAX executor's moving mean moves again at
    ``backward`` (it re-runs the forward); the port's moves once, to
    ``momentum * 0 + (1 - momentum) * batch_mean``."""
    x = np.random.RandomState(11).randn(4, 3, 2, 2).astype(np.float32) + 2.5
    batch_mean = x.mean(axis=(0, 2, 3))
    means = []
    for mx in (jmx, tmx):
        bn = mx.sym.BatchNorm(mx.sym.var("data"), name="bn", momentum=0.9)
        ex = bn.simple_bind(mx.cpu(), data=x.shape)
        ex.aux_dict["bn_moving_var"][:] = mx.nd.ones((3,))
        ex.forward(is_train=True, data=x)
        after_fwd = ex.aux_dict["bn_moving_mean"].asnumpy()
        ex.backward()
        means.append((after_fwd, ex.aux_dict["bn_moving_mean"].asnumpy()))
    (j_fwd, j_bwd), (t_fwd, t_bwd) = means
    np.testing.assert_allclose(t_fwd, 0.1 * batch_mean, **TOL)
    np.testing.assert_allclose(t_bwd, t_fwd, **TOL)        # once
    np.testing.assert_allclose(j_fwd, t_fwd, **TOL)
    np.testing.assert_allclose(j_bwd, 0.9 * j_fwd + 0.1 * batch_mean,
                               rtol=1e-5, atol=1e-6)       # twice


def test_predict_graph_replays_over_in_place_writes():
    """Predict mode on the executor's graph holder (a stand-in capture on
    the CPU): the batch args are staged, parameters and moving
    statistics read in place, so new batches, ``copy_params_from`` and
    ``arg_dict[...][:] =`` replay the one graph; a replaced parameter
    tensor recaptures once."""
    sym = _conv_bn(tmx)
    ex = sym.simple_bind(tmx.cpu(), data=(2, 3, 5, 5), grad_req="null")
    ex._batch_args = {"data"}
    ex.graphs = tco._Graphs("cpu", capture=_standin)
    rng = np.random.RandomState(5)
    for n, a in ex.arg_dict.items():
        a[:] = tmx.nd.array(rng.randn(*a.shape) * 0.3)
    eager = ex._make_graph_fn(False)
    outs = []
    for i in range(3):
        x = rng.randn(2, 3, 5, 5).astype(np.float32)
        got = ex.forward(data=x)[0].asnumpy()
        with torch.no_grad():
            want = eager(*ex._values())[0][0].numpy()
        np.testing.assert_array_equal(got, want)
        outs.append(got)
    w = ex.arg_dict["conv_weight"]
    ex.copy_params_from({"conv_weight": w * 2})
    ex.forward(data=x)
    assert ex.stats() == dict(captures=1, replays=4, recaptures=0,
                              signatures=1, eager_rng=0, grouped=0)
    w._set_data(w._data * 0.5)
    ex.forward(data=x)
    assert ex.graphs.stats()["recaptures"] == 1


def test_monitor_callback_sees_the_same_names_as_jax():
    seen = []
    for mx in (jmx, tmx):
        ex = _mlp(mx).simple_bind(mx.cpu(), data=(2, 5), label=(2,))
        names = []
        ex.set_monitor_callback(lambda n, v, names=names: names.append(
            (n, v.shape)), monitor_all=True)
        ex.forward(is_train=False)
        ex.set_monitor_callback(lambda n, v, names=names: names.append(
            (n, v.shape)))
        ex.forward(is_train=False)
        seen.append(names)
        assert ex.output_dict["softmax_output"].shape == (2, 4)
    assert seen[1] == seen[0]
    assert "Op:SoftmaxOutput" in ex.debug_str()


def test_multi_device_bind_and_group2ctx_raise():
    sym = _mlp(tmx)
    with pytest.raises(NotImplementedError, match="item 12"):
        sym.simple_bind([tmx.cpu(0), tmx.cpu(1)], data=(2, 5), label=(2,))
    # placement (queue A item 8) is ported: a group2ctx naming no group
    # of the graph leaves it off (tests/test_torch_placement.py)
    grouped = sym.simple_bind(tmx.cpu(), data=(2, 5), label=(2,),
                              group2ctx={"dev1": tmx.cpu()})
    assert grouped._op_ctxs is None
    ex = sym.simple_bind([tmx.cpu(), tmx.cpu()], data=(2, 5), label=(2,))
    assert ex.forward()[0].shape == (2, 4)


@pytest.mark.parametrize("case", [
    dict(),
    dict(normalization="batch"),
    dict(normalization="valid", use_ignore=True, ignore_label=2),
    dict(smooth_alpha=0.1, grad_scale=3.0),
    dict(multi_output=True),
    dict(multi_output=True, normalization="valid"),
    dict(preserve_shape=True),
    dict(out_grad=True),
    dict(probability_label=True),
], ids=lambda c: ",".join("%s=%s" % kv for kv in c.items()) or "default")
def test_softmax_output_matches_jax(case):
    """SoftmaxOutput's forward and its loss gradient (the JAX custom
    VJP) under each option, through a bound graph in both packages."""
    case = dict(case)
    prob = case.pop("probability_label", False)
    rng = np.random.RandomState(21)
    if case.get("multi_output"):
        x = rng.randn(2, 4, 3, 2).astype(np.float32)
        label = rng.randint(0, 4, (2, 3, 2)).astype(np.float32)
    elif case.get("preserve_shape"):
        x = rng.randn(2, 3, 5).astype(np.float32)
        label = rng.randint(0, 5, (2, 3)).astype(np.float32)
    else:
        x = rng.randn(6, 5).astype(np.float32)
        label = rng.randint(0, 5, (6,)).astype(np.float32)
    if prob:
        label = rng.dirichlet(np.ones(5), 6).astype(np.float32)
    head = rng.randn(*x.shape).astype(np.float32)
    res = []
    for mx in (jmx, tmx):
        out = mx.sym.SoftmaxOutput(mx.sym.var("data"), mx.sym.var("label"),
                                   name="sm", **case)
        gx = mx.nd.zeros(x.shape)
        ex = out.bind(mx.cpu(), {"data": mx.nd.array(x),
                                 "label": mx.nd.array(label)},
                      args_grad={"data": gx})
        ex.forward(is_train=True)
        ex.backward(mx.nd.array(head))
        res.append((ex.outputs[0].asnumpy(), gx.asnumpy()))
    for got, want in zip(res[1], res[0]):
        np.testing.assert_allclose(got, want, **TOL)
    assert tmx.sym.SoftmaxOutput(tmx.sym.var("d"), tmx.sym.var("l")) \
        .infer_shape(d=x.shape, l=label.shape)[1] == [x.shape]
    assert tmx.sym.Softmax is not None
