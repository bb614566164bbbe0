"""Port parity: the Symbol layer (``mxnet_tpu_torch.symbol``) against
``mxnet_tpu.symbol``, on the CPU.

The same graph is composed through each package's ``mx.sym`` (node
names from fresh name counters): the listings, ``infer_shape`` /
``infer_shape_partial`` / ``infer_type``, the attributes and the nnvm
JSON must be equal, and the JSON of each package must load in the
other. A Gluon net traced with ``net(sym.var("data"))`` must give the
JAX net's graph, node for node.
"""
import json

import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


@pytest.fixture(autouse=True)
def _fresh_names():
    from mxnet_tpu.name import NameManager as JaxNames
    from mxnet_tpu_torch.name import NameManager as PortNames
    with JaxNames(), PortNames():
        yield


def _graph(mx):
    """conv → BatchNorm → relu → max pool, plus an avg-pooled skip of the
    conv, flattened into a classifier: args, aux states, an auto-named
    broadcast_add and a scalar op."""
    S = mx.sym
    data = S.var("data")
    c = S.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                      name="conv")
    b = S.BatchNorm(c, fix_gamma=False, name="bn")
    r = S.Activation(b, act_type="relu", name="relu")
    p = S.Pooling(r, kernel=(2, 2), stride=(2, 2), pool_type="max",
                  name="pool")
    skip = S.Pooling(c, kernel=(2, 2), stride=(2, 2), pool_type="avg",
                     name="skip")
    f = S.Flatten(p + skip * 0.5, name="flat")
    return S.FullyConnected(f, num_hidden=3, name="fc")


def _both(fn):
    return fn(jmx), fn(tmx)


def _json(sym):
    js = json.loads(sym.tojson())
    js["attrs"].pop("framework")           # names the package
    return js


LISTINGS = ("list_arguments", "list_auxiliary_states", "list_outputs",
            "list_inputs")


def test_composition_and_listings_match_jax():
    j, t = _both(_graph)
    for name in LISTINGS:
        assert getattr(t, name)() == getattr(j, name)(), name
    assert t.list_auxiliary_states() == ["bn_moving_mean", "bn_moving_var"]
    assert t.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    assert t.attr_dict() == j.attr_dict()
    assert t.name == j.name == "fc"
    tg, jg = (mx.sym.Group([s, s.get_internals()["bn_output"]])
              for mx, s in ((tmx, t), (jmx, j)))
    assert tg.list_outputs() == jg.list_outputs()
    assert len(tg) == len(jg) == 2
    assert tg[1:].list_outputs() == jg[1:].list_outputs()
    assert tg["fc_output"].name == "fc"
    assert tg.name is None and "group" in repr(tg)


@pytest.mark.parametrize("attr", [None, {"ctx_group": "dev1"}])
def test_json_matches_jax_and_loads_across(attr):
    def build(mx):
        if attr is None:
            return _graph(mx)
        with mx.AttrScope(**attr):
            return _graph(mx)
    j, t = _both(build)
    assert _json(t) == _json(j)
    # each package's JSON loads in the other and gives the same graph
    t2 = tmx.sym.load_json(j.tojson())
    j2 = jmx.sym.load_json(t.tojson())
    for name in LISTINGS:
        assert getattr(t2, name)() == getattr(j, name)()
        assert getattr(j2, name)() == getattr(t, name)()
    assert _json(t2) == _json(j)
    shapes = dict(data=(2, 3, 8, 8))
    assert t2.infer_shape(**shapes) == j2.infer_shape(**shapes)


def test_save_and_load_roundtrip(tmp_path):
    t = _graph(tmx)
    path = str(tmp_path / "g-symbol.json")
    t.save(path)
    assert _json(tmx.sym.load(path)) == _json(t)
    assert _json(jmx.sym.load(path)) == _json(t)


@pytest.mark.parametrize("feed", [
    dict(data=(2, 3, 8, 8)),
    dict(data=(1, 3, 6, 10)),
])
def test_infer_shape_matches_jax(feed):
    j, t = _both(_graph)
    got, want = t.infer_shape(**feed), j.infer_shape(**feed)
    assert got == want
    assert got[1] == [(feed["data"][0], 3)]
    assert t.infer_shape(feed["data"]) == want        # positional
    assert t.infer_type(data="float32") == j.infer_type(data="float32")


def test_infer_shape_partial_and_unknowns_match_jax():
    j, t = _both(_graph)
    assert t.infer_shape_partial() == j.infer_shape_partial()
    assert t.infer_shape_partial()[1] == [None]
    with pytest.raises(tmx.MXNetError, match="data"):
        t.infer_shape()
    # a given parameter shape with an unknown data shape
    part = dict(conv_weight=(4, 3, 3, 3))
    assert t.infer_shape_partial(**part) == j.infer_shape_partial(**part)


def test_infer_shape_reports_an_op_that_fails():
    x = tmx.sym.var("x")
    bad = tmx.sym.FullyConnected(x, num_hidden=4, name="fc")
    with pytest.raises(tmx.MXNetError, match="infer_shape failed at op "
                                             "FullyConnected"):
        bad.infer_shape(x=(2, 5), fc_weight=(4, 6))


def test_kernel_ops_infer_shape_without_running():
    """The attention ops reach a CUDA kernel, which cannot run on
    ``meta`` tensors: their registered output rule gives the shape."""
    q = tmx.sym.var("q")
    att = tmx.sym._contrib_flash_attention(q, q, q, causal=True)
    assert att.infer_shape(q=(2, 16, 4, 8))[1] == [(2, 16, 4, 8)]


def test_arithmetic_and_methods_match_jax():
    def build(mx):
        a, b = mx.sym.var("a"), mx.sym.var("b")
        out = [a + b, a - 2, 3 - a, a * b, a / 4, 2 / a, a ** 2, -a,
               a.reshape((0, -1)), a.sum(axis=1),
               a.mean(), a.astype("float16"), a.softmax(axis=0),
               abs(a), a > b, a <= 1.5]
        return mx.sym.Group(out)
    j, t = _both(build)
    assert _json(t) == _json(j)
    feed = dict(a=(2, 3, 4), b=(2, 3, 4))
    assert t.infer_shape(**feed)[1] == j.infer_shape(**feed)[1]


def test_executor_entry_points_raise_until_ported():
    """The executor is ported: ``bind``, ``simple_bind`` and ``eval`` run
    and equal JAX's on the same arrays (predict mode, then a training
    forward with its backward)."""
    import numpy as np
    rng = np.random.RandomState(8)
    j, t = _both(_graph)
    shapes = dict(zip(t.list_arguments(),
                      t.infer_shape(data=(2, 3, 4, 4))[0]))
    vals = {n: rng.randn(*s).astype(np.float32) * 0.5
            for n, s in shapes.items()}
    aux = {n: np.ones(s, np.float32) if "var" in n else np.zeros(
        s, np.float32) for n, s in zip(t.list_auxiliary_states(),
                                       t.infer_shape(data=(2, 3, 4, 4))[2])}
    res = []
    for mx, sym in ((jmx, j), (tmx, t)):
        ex = sym.bind(mx.cpu(), {n: mx.nd.array(v) for n, v in vals.items()},
                      args_grad={n: mx.nd.zeros(v.shape)
                                 for n, v in vals.items()},
                      aux_states={n: mx.nd.array(v) for n, v in aux.items()})
        pred = ex.forward()[0].asnumpy()
        ex.forward(is_train=True)
        ex.backward(mx.nd.ones((2, 3)))
        sb = sym.simple_bind(mx.cpu(), data=(2, 3, 4, 4))
        sb.copy_params_from({n: mx.nd.array(v) for n, v in vals.items()},
                            {n: mx.nd.array(v) for n, v in aux.items()})
        conv = sym.get_internals()["conv_output"]
        ev = conv.eval(ctx=mx.cpu(), **{n: mx.nd.array(vals[n])
                                        for n in conv.list_arguments()})
        res.append([pred, ex.grad_dict["conv_weight"].asnumpy(),
                    sb.forward()[0].asnumpy(), ev[0].asnumpy()])
    for got, want in zip(res[1], res[0]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _small_net(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, 2, 1, use_bias=False), nn.BatchNorm(),
                nn.Activation("relu"), nn.MaxPool2D(3, 2, 1),
                nn.GlobalAvgPool2D(), nn.Dense(5))
    return net


@pytest.mark.parametrize("run_first", [False, True])
def test_traced_gluon_graph_matches_jax(run_first):
    """``net(sym.var("data"))``: the same nodes, names, attributes and
    variables (with their ``__shape__``/``__dtype__``/``__lr_mult__``)
    as the JAX net's, before and after the first forward fixed the
    deferred shapes."""
    graphs = []
    for mx in (jmx, tmx):
        net = _small_net(mx)
        net.initialize()
        if run_first:
            net(mx.nd.ones((1, 3, 8, 8)))
        graphs.append(net(mx.sym.var("data")))
    j, t = graphs
    assert _json(t) == _json(j)
    assert t.infer_shape(data=(2, 3, 8, 8)) == \
        j.infer_shape(data=(2, 3, 8, 8))
    resnet = [mx.gluon.model_zoo.vision.resnet18_v1(classes=4)
              for mx in (jmx, tmx)]
    for mx, net in zip((jmx, tmx), resnet):
        net.initialize()
    j, t = (net(mx.sym.var("data")) for mx, net in zip((jmx, tmx), resnet))
    assert _json(t) == _json(j)
    assert len(t.list_auxiliary_states()) == 40
    assert t.infer_shape(data=(1, 3, 32, 32)) == \
        j.infer_shape(data=(1, 3, 32, 32))
