"""Port parity: ``mxnet_tpu_torch.cached_op`` against
``mxnet_tpu.cached_op``, and the CachedOp's graph holder, on the CPU.

``build_graph_callable`` over the same Symbol must give JAX's outputs
and auxiliary values (eval and train, rtol = 1e-5, atol = 1e-6); the
eager CachedOp path (train mode, ``record()``) must give JAX's outputs,
moving statistics and gradients. The graph holder (``cached_op._Graphs``:
one CUDA graph per input signature on the card) is driven on the CPU
through a stand-in capture that re-runs the body at each replay, as
``tests/test_torch_graphs.py`` does for the decode server's programs:
captures, replays, recaptures over a replaced tensor, staged data
inputs, copied outputs, and no fallback when a capture fails.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cached_op as tco
from mxnet_tpu_torch.gluon.convert import params_from_numpy

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


def _graph(mx):
    S = mx.sym
    data = S.var("data")
    c = S.Convolution(data, kernel=(3, 3), num_filter=4, pad=(1, 1),
                      name="conv")
    b = S.BatchNorm(c, fix_gamma=False, momentum=0.7, name="bn")
    p = S.Pooling(S.Activation(b, act_type="relu"), kernel=(2, 2),
                  stride=(2, 2), pool_type="max", name="pool")
    return S.FullyConnected(p + 1.0, num_hidden=3, name="fc")


def _inputs(sym, seed=0, batch=2):
    """Numpy values for every argument and auxiliary state."""
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(batch, 3, 6, 6))
    args = [rs.randn(*s).astype(np.float32) for s in arg_shapes]
    aux = [rs.uniform(0.5, 1.5, s).astype(np.float32) for s in aux_shapes]
    return args, aux


@pytest.mark.parametrize("train", [False, True])
def test_graph_callable_matches_jax(train):
    jsym, tsym = _graph(jmx), _graph(tmx)
    jplan = jmx.cached_op.build_graph_callable(jsym)
    tplan = tco.build_graph_callable(tsym)
    assert tplan[1:] == jplan[1:]              # names, n_rng, n_out
    args, aux = _inputs(tsym)
    want = jplan[0]({"__train__": train},
                    *[jmx.nd.array(a)._data for a in args + aux])
    got = tplan[0]({"__train__": train},
                   *[torch.from_numpy(a) for a in args + aux])
    assert len(got) == len(want) == 1 + 2       # the logits, then the aux
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    assert np.array_equal(got[1].detach().numpy(), aux[0]) != train


def _cached_call(mx, op_cls, sym, args, aux):
    arrays = [mx.nd.array(a) for a in args]
    arrays[1].attach_grad()                     # conv_weight
    aux_nd = [mx.nd.array(a) for a in aux]
    op = op_cls(sym)
    with mx.autograd.record():
        out = op(*(arrays + aux_nd))
        loss = (out * out).sum()
    loss.backward()
    return op, aux_nd, {"out": out.asnumpy(),
                        "d_conv_weight": arrays[1].grad.asnumpy(),
                        "moving_mean": aux_nd[0].asnumpy(),
                        "moving_var": aux_nd[1].asnumpy()}


def test_cached_op_training_call_matches_jax():
    """Under ``record()`` (train mode) the CachedOp runs op by op: torch
    autograd records it and BatchNorm's new moving statistics land in
    the auxiliary NDArrays in place."""
    jsym, tsym = _graph(jmx), _graph(tmx)
    args, aux = _inputs(tsym, seed=1)
    _, _, want = _cached_call(jmx, jmx.cached_op.CachedOp, jsym, args, aux)
    op, aux_nd, got = _cached_call(tmx, tco.CachedOp, tsym, args, aux)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    assert not np.allclose(got["moving_mean"], aux[0])
    assert op.stats()["replays"] == 0            # no graph on the CPU
    with pytest.raises(tmx.MXNetError, match="expects 9 inputs"):
        op(*aux_nd)


def _standin(fail=False):
    """A CUDA capture's contract on the CPU: one call now, the output
    buffers kept, each replay writes the body's result into them."""
    def capture(body, device, pool):
        if fail:
            raise RuntimeError("capture failed")
        out = body()

        def replay():
            for o, r in zip(out, body()):
                o.copy_(r)
        return replay, out, {}
    return capture


def _holder_op(sym):
    op = tco.CachedOp(sym, data_indices=[0])
    op.graphs = tco._Graphs("cpu", capture=_standin())
    return op


def _eager(sym, arrays):
    op = tco.CachedOp(sym)           # no graph on the CPU: op by op
    return op(*arrays).asnumpy()


def test_graph_holder_captures_replays_and_recaptures():
    sym = _graph(tmx)
    args, aux = _inputs(sym, seed=2)
    params = [tmx.nd.array(a) for a in args[1:]]
    aux_nd = [tmx.nd.array(a) for a in aux]
    op = _holder_op(sym)

    def call(x):
        return op(*([x] + params + aux_nd))

    def want(x):
        return _eager(sym, [x] + params + aux_nd)

    x1, x2 = (tmx.nd.array(np.random.RandomState(s).randn(2, 3, 6, 6))
              for s in (3, 4))
    y1 = call(x1)
    assert op.stats() == dict(captures=1, replays=1, recaptures=0,
                              signatures=1,
                              eager_rng=0, eager_host=0)
    first = y1.asnumpy()
    np.testing.assert_allclose(first, want(x1), **TOL)
    y2 = call(x2)                      # another data tensor: staged, replay
    np.testing.assert_allclose(y2.asnumpy(), want(x2), **TOL)
    np.testing.assert_array_equal(y1.asnumpy(), first)   # copied out
    assert y1._data.data_ptr() != y2._data.data_ptr()
    assert op.stats()["captures"] == 1 and op.stats()["replays"] == 2

    # a parameter written in place: the graph reads it, no recapture
    with torch.no_grad():
        params[0]._data.mul_(0.5)
    np.testing.assert_allclose(call(x1).asnumpy(), want(x1), **TOL)
    assert op.stats()["captures"] == 1
    # a parameter replaced by a new tensor: one counted recapture
    params[0]._set_data(params[0]._data * 3.0)
    y = call(x1)
    np.testing.assert_allclose(y.asnumpy(), want(x1), **TOL)
    assert not np.allclose(y.asnumpy(), first)
    assert op.stats() == dict(captures=2, replays=4, recaptures=1,
                              signatures=1,
                              eager_rng=0, eager_host=0)
    # a new signature is a capture of its own, not a recapture
    x3 = tmx.nd.array(np.random.RandomState(5).randn(3, 3, 6, 6))
    np.testing.assert_allclose(call(x3).asnumpy(), want(x3), **TOL)
    assert op.stats() == dict(captures=3, replays=5, recaptures=1,
                              signatures=2,
                              eager_rng=0, eager_host=0)
    # recording or train mode: op by op, the moving statistics move
    before = aux_nd[0].asnumpy()
    with tmx.autograd.train_mode():
        call(x1)
    with tmx.autograd.record():
        call(x1)
    assert op.stats()["replays"] == 5
    assert not np.allclose(aux_nd[0].asnumpy(), before)


def test_capture_failure_raises_without_fallback():
    sym = _graph(tmx)
    args, aux = _inputs(sym, seed=6)
    op = tco.CachedOp(sym, data_indices=[0])
    op.graphs = tco._Graphs("cpu", capture=_standin(fail=True))
    with pytest.raises(RuntimeError, match="capture failed"):
        op(*[tmx.nd.array(a) for a in args + aux])
    assert op.stats() == dict(captures=0, replays=0, recaptures=0,
                              signatures=0,
                              eager_rng=0, eager_host=0)


def test_graphs_serve_only_cuda_tensors_by_default():
    op = tco.CachedOp(_graph(tmx))
    assert op.graphs.device_type == "cuda"
    assert not op.graphs.serves([torch.zeros(2)])
    assert op.graphs.serves([torch.zeros(2, device="meta")]) is False


def _net(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.BatchNorm(),
                nn.Activation("relu"), nn.GlobalAvgPool2D(), nn.Dense(3))
    return net


def test_hybridized_block_replays_and_clears_its_graph():
    """A hybridized block feeds its call arguments as the graph's data
    inputs and its parameters in place; ``params_from_numpy`` writes in
    place (a replay, no recapture), ``hybridize()``, ``register_child``
    and ``cast`` drop the CachedOp and its graphs."""
    x = np.random.RandomState(7).randn(2, 3, 5, 5).astype(np.float32)
    jnet = _net(jmx)
    jnet.initialize(jmx.init.Xavier())
    want = jnet(jmx.nd.array(x)).asnumpy()
    weights = {k: p.data().asnumpy()
               for k, p in jnet._collect_params_with_prefix().items()}
    net = _net(tmx)
    net.initialize()
    net.hybridize()
    net(tmx.nd.array(x))                       # builds the CachedOp
    op = net._cached_op
    assert op._data_indices == (0,)
    op.graphs = tco._Graphs("cpu", capture=_standin())
    params_from_numpy(net, weights)
    np.testing.assert_allclose(net(tmx.nd.array(x)).asnumpy(), want, **TOL)
    np.testing.assert_allclose(net(tmx.nd.array(x)).asnumpy(), want, **TOL)
    assert op.stats() == dict(captures=1, replays=2, recaptures=0,
                              signatures=1,
                              eager_rng=0, eager_host=0)
    net.hybridize()
    assert net._cached_op is None
    net(tmx.nd.array(x))
    assert net._cached_op is not op
    net.add(tmx.gluon.nn.Activation("relu"))
    assert net._cached_op is None
    net(tmx.nd.array(x))
    net.cast("float64")
    assert net._cached_op is None
    out = net(tmx.nd.array(x, dtype="float64"))
    assert out.dtype == np.float64
    assert net[1].running_mean.data().dtype == np.float64


# ---------------------------------------------------------------------------
# a plan holding Dropout
# ---------------------------------------------------------------------------

def _dropout_net(mx, mode="training"):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(4, 3, padding=1), nn.Activation("relu"),
                nn.Dropout(0.5), nn.GlobalAvgPool2D(), nn.Dense(3))
    if mode == "always":
        class _Always(mx.gluon.HybridBlock):
            def hybrid_forward(self, F, x):
                return F.Dropout(x, p=0.5, mode="always")
        net.add(_Always())
    return net


def test_predict_graph_keeps_dropout_plans():
    """A hybridized net with train-mode Dropout keeps its graph in
    predict mode: 1 capture, replays, no eager call; its logits equal
    JAX's (Dropout is the identity there). Under ``record()`` it runs
    op by op and draws."""
    x = np.random.RandomState(8).randn(2, 3, 6, 6).astype(np.float32)
    jnet = _dropout_net(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet.hybridize()
    want = jnet(jmx.nd.array(x)).asnumpy()
    net = _dropout_net(tmx)
    net.initialize()
    net.hybridize()
    net(tmx.nd.array(x))
    op = net._cached_op
    assert op._op.needs_rng and not op._predict_draws
    op.graphs = tco._Graphs("cpu", capture=_standin())
    params_from_numpy(net, {k: p.data().asnumpy() for k, p
                            in jnet._collect_params_with_prefix().items()})
    for _ in range(3):
        np.testing.assert_allclose(net(tmx.nd.array(x)).asnumpy(), want,
                                   **TOL)
    assert op.stats() == dict(captures=1, replays=3, recaptures=0,
                              signatures=1, eager_rng=0, eager_host=0)
    with tmx.autograd.record():
        drawn = net(tmx.nd.array(x)).asnumpy()
    assert not np.allclose(drawn, want)
    assert op.stats()["replays"] == 3


def test_plan_that_draws_in_predict_runs_op_by_op_counted():
    """``Dropout(mode="always")`` draws in predict mode: no capture,
    each call op by op, counted as ``eager_rng``; the executor's
    predict run does the same."""
    x = np.random.RandomState(9).randn(2, 3, 6, 6).astype(np.float32)
    net = _dropout_net(tmx, mode="always")
    net.initialize()
    net.hybridize()
    net(tmx.nd.array(x))
    op = net._cached_op
    assert op._predict_draws
    op.graphs = tco._Graphs("cpu", capture=_standin())
    outs = [net(tmx.nd.array(x)).asnumpy() for _ in range(2)]
    assert not np.array_equal(outs[0], outs[1])          # two draws
    assert op.stats() == dict(captures=0, replays=0, recaptures=0,
                              signatures=0, eager_rng=2, eager_host=0)
    sym = tmx.sym.Dropout(tmx.sym.FullyConnected(
        tmx.sym.var("data"), num_hidden=4, name="fc"), p=0.5, mode="always")
    ex = sym.simple_bind(tmx.cpu(), data=(3, 5), grad_req="null")
    ex.graphs = tco._Graphs("cpu", capture=_standin())
    ex.arg_dict["fc_weight"][:] = 1.0
    ex.forward(data=np.ones((3, 5), np.float32))
    assert ex.graphs.stats()["eager_rng"] == 1
    assert ex.graphs.stats()["captures"] == 0


def test_graph_callable_with_dropout_matches_jax():
    """``build_graph_callable`` over a traced net with Dropout: the same
    names and RNG count as JAX's, and equal predict-mode outputs."""
    jnet, tnet = _dropout_net(jmx), _dropout_net(tmx)
    jnet.initialize(jmx.init.Xavier())
    x = np.random.RandomState(10).randn(1, 3, 6, 6).astype(np.float32)
    jnet(jmx.nd.array(x))
    tnet.initialize()
    params_from_numpy(tnet, {k: p.data().asnumpy() for k, p
                             in jnet._collect_params_with_prefix().items()})
    jplan = jmx.cached_op.build_graph_callable(jnet(jmx.sym.var("data")))
    tplan = tco.build_graph_callable(tnet(tmx.sym.var("data")))
    assert tplan[1:] == jplan[1:] and tplan[3] == 1
    params = {p.name: p for p in tnet.collect_params().values()}
    vals = [torch.from_numpy(x) if n == "data" else params[n].data()._data
            for n in tplan[1] + tplan[2]]
    got = tplan[0]({"__train__": False}, *vals)[0]
    np.testing.assert_allclose(got.detach().numpy(),
                               jnet(jmx.nd.array(x)).asnumpy(), **TOL)
