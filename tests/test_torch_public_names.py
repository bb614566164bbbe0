"""Public names the port adds to match the JAX package's surface, each
held to the JAX package on the CPU: ``Parameter.reset_ctx`` and
``ParameterDict.reset_ctx`` (the JAX package's are no-ops, placement there
being an annotation; the port's move the value and gradient and keep
them equal), ``Initializer.set_verbosity``, ``Context.empty_cache``,
``DecodeServer.latency_snapshot``, ``deploy.Predictor.predict``,
``compile_watch.last_dispatch`` and ``base.build_param_doc`` /
``base.Registry.items``."""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import base as jbase
from mxnet_tpu import compile_watch as jcw
from mxnet_tpu import deploy as jdeploy
from mxnet_tpu import serving as jserving
from mxnet_tpu_torch import base as tbase
from mxnet_tpu_torch import compile_watch as tcw
from mxnet_tpu_torch import deploy as tdeploy
from mxnet_tpu_torch import serving as tserving


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    jcw.disable()
    tcw.disable()
    yield
    jcw.disable()
    tcw.disable()


def _dense(m, seed):
    net = m.gluon.nn.Dense(3, in_units=4)
    net.initialize(m.init.Xavier())
    rs = np.random.RandomState(seed)
    w = rs.uniform(-1, 1, (3, 4)).astype(np.float32)
    b = rs.uniform(-1, 1, (3,)).astype(np.float32)
    net.weight.set_data(m.nd.array(w))
    net.bias.set_data(m.nd.array(b))
    return net, w, b


def test_parameter_reset_ctx_keeps_value_and_gradient():
    jnet, w, b = _dense(jmx, 0)
    tnet, _, _ = _dense(mx, 0)
    x = np.random.RandomState(1).uniform(-1, 1, (2, 4)).astype(np.float32)
    for m, net in ((jmx, jnet), (mx, tnet)):
        xs = m.nd.array(x)
        with m.autograd.record():
            loss = (net(xs) * net(xs)).sum()
        loss.backward()
    want_grad = jnet.weight.grad().asnumpy()
    np.testing.assert_allclose(tnet.weight.grad().asnumpy(), want_grad,
                               rtol=1e-5, atol=1e-6)
    jnet.weight.reset_ctx(jmx.cpu())
    tnet.weight.reset_ctx(mx.cpu(0))
    np.testing.assert_array_equal(tnet.weight.data().asnumpy(), w)
    np.testing.assert_array_equal(tnet.weight.data().asnumpy(),
                                  jnet.weight.data().asnumpy())
    np.testing.assert_allclose(tnet.weight.grad().asnumpy(), want_grad,
                               rtol=1e-5, atol=1e-6)
    assert tnet.weight.list_ctx() == [mx.cpu(0)]
    # the whole dict, to a list of contexts: the first holds the arrays
    jnet.collect_params().reset_ctx([jmx.cpu(0), jmx.cpu(1)])
    tnet.collect_params().reset_ctx([mx.cpu(0), mx.cpu(1)])
    assert tnet.bias.list_ctx() == [mx.cpu(0), mx.cpu(1)]
    np.testing.assert_array_equal(tnet.bias.data().asnumpy(), b)
    np.testing.assert_array_equal(tnet.bias.data().asnumpy(),
                                  jnet.bias.data().asnumpy())
    # the moved arrays stay the ones autograd differentiates
    xs = mx.nd.array(x)
    with mx.autograd.record():
        loss = (tnet(xs) * tnet(xs)).sum()
    loss.backward()
    np.testing.assert_allclose(tnet.weight.grad().asnumpy(), want_grad,
                               rtol=1e-5, atol=1e-6)


def test_reset_ctx_of_deferred_and_unbound_parameters():
    for m in (jmx, mx):
        p = m.gluon.Parameter("w_weight", shape=(0, 3),
                              allow_deferred_init=True)
        p.initialize(ctx=m.cpu(0))
        p.reset_ctx(m.cpu(1))
        q = m.gluon.Parameter("q", shape=(2, 2))
        q.reset_ctx(m.cpu())            # never initialized: left as it is
    assert p.list_ctx() == [mx.cpu(1)]
    p.shape = (2, 3)
    p._finish_deferred_init()
    assert p.list_ctx() == [mx.cpu(1)] and p.data().shape == (2, 3)
    with pytest.raises(RuntimeError):
        q.data()


def test_set_verbosity_returns_the_initializer():
    for m in (jmx, mx):
        init = m.init.Xavier()
        assert init.set_verbosity(True) is init
        assert (init._verbose, init._print_func) == (True, None)
        assert init.set_verbosity(False, print) is init
        assert (init._verbose, init._print_func) == (False, print)
        params = m.gluon.nn.Dense(2, in_units=2).collect_params()
        params.initialize(init, verbose=True)
        assert init._verbose is True


def test_empty_cache_on_a_host_context():
    assert jmx.cpu().empty_cache() is None
    assert mx.cpu().empty_cache() is None
    assert mx.cpu_pinned().empty_cache() is None


def test_latency_snapshot_holds_the_inter_token_intervals():
    kw = dict(vocab=32, n_layers=1, n_heads=2, head_dim=8, max_len=64)
    jm = jserving.ToyDecoderLM(**kw)
    jp = jm.init_params(seed=3)
    tm = tserving.ToyDecoderLM(**kw)
    tp = tserving.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, "cpu", model=tm)
    opts = dict(seq_ladder=[8, 16], max_new_tokens=6, window=2, page_size=8,
                pool_pages=16, start=False)
    servers = (jserving.DecodeServer(jm, jp, **opts),
               tserving.DecodeServer(tm, tp, device="cpu", **opts))
    lengths = []
    try:
        for srv in servers:
            assert srv.latency_snapshot() == []
            reqs = [srv.submit(np.arange(1, 6), max_new_tokens=6),
                    srv.submit(np.arange(3, 12), max_new_tokens=4)]
            for _ in range(200):
                if all(r.done() for r in reqs):
                    break
                srv._tick()
            snap = srv.latency_snapshot()
            assert all(isinstance(v, float) and v >= 0.0 for v in snap)
            assert srv.stats()["inter_token_ms"]["p50"] == round(
                float(np.percentile(snap, 50)), 3)
            lengths.append(len(snap))
    finally:
        for srv in servers:
            srv.stop()
    assert lengths[0] == lengths[1] == (6 - 1) + (4 - 1)


def test_predictor_predict_is_call(tmp_path):
    assert jdeploy.Predictor.predict is jdeploy.Predictor.__call__
    assert tdeploy.Predictor.predict is tdeploy.Predictor.__call__
    d = mx.sym.var("data")
    out = mx.sym.FullyConnected(d, mx.sym.var("w"), mx.sym.var("b"),
                                num_hidden=4)
    rs = np.random.RandomState(0)
    params = {"w": mx.nd.array(rs.uniform(-1, 1, (4, 6)).astype(np.float32)),
              "b": mx.nd.array(rs.uniform(-1, 1, (4,)).astype(np.float32))}
    path = str(tmp_path / "fc.mxp")
    mx.deploy.export_compiled(out, path, params=params,
                              input_shapes={"data": (3, 6)})
    pred = mx.deploy.load_compiled(path)
    x = rs.uniform(-1, 1, (3, 6)).astype(np.float32)
    np.testing.assert_array_equal(pred.predict(x), pred(x))


def test_last_dispatch_is_the_sites_latest_cost():
    import jax.numpy as jnp
    import torch
    assert jcw.last_dispatch("names:mm") is None        # the watch off
    assert tcw.last_dispatch("names:mm") is None
    jcw.enable()
    tcw.enable()
    a = np.random.RandomState(0).uniform(-1, 1, (4, 8)).astype(np.float32)
    b = np.random.RandomState(1).uniform(-1, 1, (8, 16)).astype(np.float32)
    jf = jcw.jit(lambda x, y: x @ y, "names:mm")
    tf = tcw.jit(lambda x, y: x @ y, "names:mm")
    assert jcw.last_dispatch("names:mm") is None        # not dispatched
    assert tcw.last_dispatch("names:mm") is None
    jf(jnp.asarray(a), jnp.asarray(b))
    tf(torch.from_numpy(a), torch.from_numpy(b))
    jc, tc = jcw.last_dispatch("names:mm"), tcw.last_dispatch("names:mm")
    assert set(tc) == set(jc) == {"flops", "bytes"}
    assert tc["flops"] == jc["flops"] == 2 * 4 * 8 * 16
    assert tc["bytes"] > 0
    tf(torch.from_numpy(a), torch.from_numpy(b))        # the eager re-run
    assert tcw.last_dispatch("names:mm") == tc
    assert tcw.last_dispatch("names:other") is None


def test_build_param_doc_and_registry_items():
    args = (["data", "weight", "data", "bias"],
            ["NDArray", "NDArray", "NDArray", "NDArray, optional"],
            ["Input data.", "", "Again.", "The bias."])
    for dup in (True, False):
        assert tbase.build_param_doc(*args, remove_dup=dup) == \
            jbase.build_param_doc(*args, remove_dup=dup)
    regs = [m.Registry("thing", case_sensitive=False) for m in (jbase, tbase)]
    for reg in regs:
        reg.register("Alpha")(int)
        reg.register("beta")(float)
    assert regs[1].items() == regs[0].items() == [("alpha", int),
                                                  ("beta", float)]


def test_default_ctx_is_the_current_context():
    assert str(mx.Context.default_ctx) == str(jmx.Context.default_ctx) \
        == "cpu(0)"
    with mx.cpu(1), jmx.cpu(1):
        assert str(mx.Context.default_ctx) == \
            str(jmx.Context.default_ctx) == "cpu(1)"
    assert mx.Context.default_ctx == mx.cpu(0)


def test_executor_cache_token_follows_the_graph(tmp_path):
    from mxnet_tpu import compile_cache as jcc
    from mxnet_tpu_torch import compile_cache as tcc
    tokens = []
    for m, cc in ((jmx, jcc), (mx, tcc)):
        d = m.sym.var("data")
        out = m.sym.FullyConnected(d, num_hidden=3, name="fc")
        ex = out.simple_bind(m.cpu(), data=(2, 4))
        assert ex.cw_cache_token is None           # no cache on
        cc.enable(str(tmp_path / m.__name__))
        try:
            token = ex.cw_cache_token
            assert token == cc.graph_token(out.tojson())
            other = m.sym.FullyConnected(d, num_hidden=3, name="fc2")
            assert other.simple_bind(m.cpu(), data=(2, 4)).cw_cache_token \
                not in (None, token)
            tokens.append(token)
        finally:
            cc.disable()
    assert all(len(t) == 64 for t in tokens)
